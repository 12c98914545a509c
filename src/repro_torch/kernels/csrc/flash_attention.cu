// Causal-capable online-softmax (flash) attention with grouped KV heads.
// q (BH, S, D); k, v (BH / group, T, D); o (BH, S, D) in q's type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:29
// make_flash_body / :66 flash_attention_desc (grid (BH, S/bq), both axes
// parallel; the KV sweep runs inside the tile with running (m, l, acc)).
// One CUDA block is one task: head p0, query rows [p1*bq, (p1+1)*bq).
// The block walks those rows in sub-tiles of 32 and the keys in chunks of
// 32, keeping m, l and the f32 accumulator of each row in registers, and
// skips key chunks that the causal mask hides entirely (they add exactly
// nothing: p = 0 and alpha = 1 or, while m is still -inf, 0 times 0).
// The masking follows the reference: -inf scores, isfinite guards so that a
// fully masked row gives 0 and never exp(-inf - -inf), l clamped at 1e-30,
// absolute query positions from q_offset.
//
// What bounds it on an H100: at the model's head width (D = 128) and a
// prefill of 512 or more tokens it does ~S/2 operations per byte, which is
// past the bf16 balance point, so operations bound it. This first version
// is simple rather than fast: CUDA-core f32 FMAs from shared memory, no
// tensor cores. Supports D <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_sched.cuh"

namespace {

constexpr int kThreads = 128;   // 4 threads per query row
constexpr int kRows = 32;       // query rows per sub-tile
constexpr int kCols = 32;       // keys per chunk
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 4;   // head-dim columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kCols * (D + 1) +
                          (size_t)kCols * D + (size_t)kRows * (kCols + 1));
}

template <typename T>
__device__ void flash_tile(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int S,
                           int Tk, int D, int group, int bq, int causal,
                           int q_offset, float scale, int p0, int p1,
                           float* smem) {
  const int Dp = D + 1;
  float* Qs = smem;                    // [kRows][D+1], pre-scaled
  float* Ks = Qs + kRows * Dp;         // [kCols][D+1]
  float* Vs = Ks + kCols * Dp;         // [kCols][D]
  float* Ps = Vs + kCols * D;          // [kRows][kCols+1]
  const int tid = threadIdx.x;
  const int r = tid >> 2;              // this thread's query row
  const int cq = tid & 3;              // its quarter of keys / head dims
  const T* qh = q + (long)p0 * S * D;
  const T* kh = k + (long)(p0 / group) * Tk * D;
  const T* vh = v + (long)(p0 / group) * Tk * D;
  T* oh = o + (long)p0 * S * D;

  for (int rs = 0; rs < bq; rs += kRows) {
    const int q0 = p1 * bq + rs;
    const int nrows = min(kRows, bq - rs);
    __syncthreads();                   // the last sub-tile is done with Qs
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int rr = e / D, d = e % D;
      float x = 0.f;
      if (rr < nrows) x = to_f32(qh[(long)(q0 + rr) * D + d]) * scale;
      Qs[rr * Dp + d] = x;
    }
    const int qpos = q_offset + q0 + r;
    float m = -INFINITY, l = 0.f;
    float acc[kDPer];
#pragma unroll
    for (int i = 0; i < kDPer; ++i) acc[i] = 0.f;
    // keys past the last row's position are masked for every row here
    const int kv_end = causal ? min(Tk, q_offset + q0 + nrows) : Tk;

    for (int c0 = 0; c0 < kv_end; c0 += kCols) {
      __syncthreads();                 // the last chunk is done with Ks, Vs
      for (int e = tid; e < kCols * D; e += kThreads) {
        const int cc = e / D, d = e % D;
        float kx = 0.f, vx = 0.f;
        if (c0 + cc < Tk) {
          kx = to_f32(kh[(long)(c0 + cc) * D + d]);
          vx = to_f32(vh[(long)(c0 + cc) * D + d]);
        }
        Ks[cc * Dp + d] = kx;
        Vs[cc * D + d] = vx;
      }
      __syncthreads();

      float s[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qd = Qs[r * Dp + d];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j] = fmaf(qd, Ks[(cq * 8 + j) * Dp + d], s[j]);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = c0 + cq * 8 + j;
        if (kpos >= Tk || (causal && qpos < kpos)) s[j] = -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      // the 4 threads of a row are adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = isfinite(s[j]) ? expf(s[j] - m_safe) : 0.f;
        Ps[r * (kCols + 1) + cq * 8 + j] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
      l = l * alpha + psum;
      m = m_new;
      __syncwarp();                    // the row's p values are visible
#pragma unroll
      for (int i = 0; i < kDPer; ++i) acc[i] *= alpha;
      for (int c = 0; c < kCols; ++c) {
        const float p = Ps[r * (kCols + 1) + c];
#pragma unroll
        for (int i = 0; i < kDPer; ++i) {
          const int d = cq + 4 * i;
          if (d < D) acc[i] = fmaf(p, Vs[c * D + d], acc[i]);
        }
      }
    }
    if (r < nrows) {
      const float denom = fmaxf(l, 1e-30f);
#pragma unroll
      for (int i = 0; i < kDPer; ++i) {
        const int d = cq + 4 * i;
        if (d < D) store(&oh[(long)(q0 + r) * D + d], acc[i] / denom);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int D, int group, int bq, int causal, int q_offset,
                 float scale, TileSched s) {
  extern __shared__ float smem[];
  for_each_task(s, [&](int p0, int p1) {
    flash_tile<T>(q, k, v, o, S, Tk, D, group, bq, causal, q_offset, scale,
                  p0, p1, smem);
  });
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int S,
             int Tk, int D, int group, int bq, int causal, int q_offset,
             float scale, dim3 grid, TileSched s, cudaStream_t st) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, Tk, D, group, bq,
      causal, q_offset, scale, s);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike)
int launch(const void* q, const void* k, const void* v, void* o, int S,
           int Tk, int D, int group, int bq, int causal, int q_offset,
           float scale, int dtype, dim3 grid, TileSched s, void* stream) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, o, S, Tk, D, group, bq, causal, q_offset,
                           scale, grid, s, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, o, S, Tk, D, group, bq, causal,
                                   q_offset, scale, grid, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int flash_plain(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int Tk, int D, int group, int bq, int causal,
                int q_offset, float scale, int dtype, void* stream) {
  const int G0 = BH, G1 = S / bq;
  return launch(q, k, v, o, S, Tk, D, group, bq, causal, q_offset, scale,
                dtype, dim3(G0, G1), plain_sched(G0, G1), stream);
}

int flash_sliced(const void* q, const void* k, const void* v, void* o, int BH,
                 int S, int Tk, int D, int group, int bq, int causal,
                 int q_offset, float scale, int dtype, int g0, int g1,
                 int off0, int off1, void* stream) {
  return launch(q, k, v, o, S, Tk, D, group, bq, causal, q_offset, scale,
                dtype, dim3(g0, g1), sliced_sched(BH, S / bq, off0, off1),
                stream);
}

int flash_persistent(const void* q, const void* k, const void* v, void* o,
                     int BH, int S, int Tk, int D, int group, int bq,
                     int causal, int q_offset, float scale, int dtype, int W,
                     int start, int budget, void* done, void* stream) {
  return launch(q, k, v, o, S, Tk, D, group, bq, causal, q_offset, scale,
                dtype, dim3(W, 1),
                persistent_sched(BH, S / bq, W, start, budget, done), stream);
}

}  // extern "C"
