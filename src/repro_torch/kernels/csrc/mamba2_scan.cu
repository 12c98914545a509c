// Mamba2 SSD chunk scan: y and the final state h of the SSD recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = h_t C_t + D x_t
// computed chunk by chunk, as the reference does.
// x (B, S, NH, HD), Bm, Cm (B, S, DS) and y (B, S, NH, HD) in one type
// (f32 or bf16); dt (B, S, NH), A (NH), D (NH) and h (B, NH, HD, DS) f32.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan.py:21
// make_ssd_body / :66 mamba2_scan_desc: grid (B, nc), only the batch axis
// parallel, the chunk axis a sequential sweep with the state carried in
// VMEM scratch. Here a task is one batch element and runs its whole chunk
// sweep; blockIdx.z is the head, because heads are independent in the
// recurrence and one head's state (HD x DS f32, 32 KB at mamba2-130m
// width) fits in shared memory where all 24 (786 KB) do not. The task ->
// batch mapping, the persistent done[w] and the watermark are those of
// csrc/tile_sched.cuh; every z-block of worker w writes the same done[w].
//
// Per chunk of L tokens the block computes, in f32:
//   cum = cumsum(dt A) (a warp scan), tot = cum[L-1];
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s      (intra)
//       + exp(cum_t) C_t . h                                      (state)
//       + D x_t                                                   (skip)
//   h  <- exp(tot) h + sum_s exp(tot - cum_s) dt_s x_s (x) B_s.
// The L x L term (256 KB in f32 at L = 256) is never held whole: it is
// formed in 32 x 32 tiles of (t, s), masked with s <= t before the exp
// (outside the mask the product is 0, never exp of a positive number),
// and tiles above the diagonal are skipped. L may be any length from 1
// (a prime S) up, power of two or not.
//
// What bounds it on an H100: at mamba2-130m width the descriptor counts
// ~245 operations per byte, just under the bf16 balance point (~295), so
// bytes bound it (0.27 ms for B = 264, S = 512, against 0.22 ms of
// tensor-core work). This first version is simple rather than fast:
// CUDA-core f32 FMAs from shared memory, C . B^T recomputed for each head,
// x, B and C read again for the state update. Supports HD <= 64 and
// DS <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tile_sched.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // t rows of a tile
constexpr int kCols = 32;                 // s columns of a tile
constexpr int kMaxHD = 64;
constexpr int kMaxDS = 128;
constexpr int kYPer = kMaxHD / 8;         // y columns per thread
constexpr int kHRows = kMaxHD / 8;        // state rows per thread
constexpr int kHCols = kMaxDS / 32;       // state columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int HD, int DS, int L) {
  const size_t DSp = DS + 1;
  return sizeof(float) * (HD * DSp + kRows * DSp + kCols * DSp +
                          (size_t)kCols * HD + kRows * (kCols + 1) +
                          2 * (size_t)L);
}

// Bs[ss][n] = B_{s0+ss}, xs[ss][p] = x_{s0+ss}[head], zero past ns rows
template <typename T>
__device__ void load_cols(const T* __restrict__ x, const T* __restrict__ Bm,
                          long tok, int ns, int NH, int HD, int DS, int head,
                          float* Bs, float* xs) {
  const int DSp = DS + 1;
  for (int e = threadIdx.x; e < kCols * DS; e += kThreads) {
    const int ss = e / DS, n = e - ss * DS;
    Bs[ss * DSp + n] = ss < ns ? to_f32(Bm[(tok + ss) * DS + n]) : 0.f;
  }
  for (int e = threadIdx.x; e < kCols * HD; e += kThreads) {
    const int ss = e / HD, p = e - ss * HD;
    xs[ss * HD + p] =
        ss < ns ? to_f32(x[((tok + ss) * NH + head) * HD + p]) : 0.f;
  }
}

template <typename T>
__device__ void ssd_task(const T* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const T* __restrict__ Bm, const T* __restrict__ Cm,
                         const float* __restrict__ Dv, T* __restrict__ y,
                         float* __restrict__ hout, int S, int NH, int HD,
                         int DS, int L, int b, int head, float* smem) {
  const int DSp = DS + 1;
  float* hs = smem;                       // [HD][DS+1] the carried state
  float* Cs = hs + HD * DSp;              // [kRows][DS+1]
  float* Bs = Cs + kRows * DSp;           // [kCols][DS+1]
  float* xs = Bs + kCols * DSp;           // [kCols][HD]
  float* Gs = xs + kCols * HD;            // [kRows][kCols+1]
  float* cum = Gs + kRows * (kCols + 1);  // [L]
  float* dts = cum + L;                   // [L]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid >> 3, cg = tid & 7;   // y: row r, columns cg + 8i
  const float a = A[head], dskip = Dv[head];
  const int nc = S / L;

  __syncthreads();                        // the last task is done with smem
  for (int e = tid; e < HD * DSp; e += kThreads) hs[e] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long tok0 = (long)b * S + (long)c * L;   // the chunk's first token
    __syncthreads();                      // the last chunk is done with dts
    for (int l = tid; l < L; l += kThreads) dts[l] = dt[(tok0 + l) * NH + head];
    __syncthreads();
    if (warp == 0) {                      // inclusive cumsum of dt * A
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int l = base + lane;
        float v = l < L ? dts[l] * a : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (l < L) cum[l] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float tot = cum[L - 1];

    // ---- y, one tile of kRows rows at a time (reads the incoming h) ----
    for (int t0 = 0; t0 < L; t0 += kRows) {
      const int nt = min(kRows, L - t0);
      const int t = t0 + r;
      __syncthreads();                    // the last tile is done with Cs
      for (int e = tid; e < kRows * DS; e += kThreads) {
        const int rr = e / DS, n = e - rr * DS;
        Cs[rr * DSp + n] =
            rr < nt ? to_f32(Cm[(tok0 + t0 + rr) * DS + n]) : 0.f;
      }
      const float cum_t = r < nt ? cum[t] : 0.f;
      float acc[kYPer];
#pragma unroll
      for (int i = 0; i < kYPer; ++i) acc[i] = 0.f;

      // columns s < t0 + nt: tiles above the diagonal add nothing
      for (int s0 = 0; s0 < t0 + nt; s0 += kCols) {
        const int ns = min(kCols, L - s0);
        __syncthreads();                  // Bs, xs, Gs free; Cs visible
        load_cols(x, Bm, tok0 + s0, ns, NH, HD, DS, head, Bs, xs);
        __syncthreads();
        float g[kCols / 8];
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) g[j] = 0.f;
        for (int n = 0; n < DS; ++n) {
          const float cv = Cs[r * DSp + n];
#pragma unroll
          for (int j = 0; j < kCols / 8; ++j)
            g[j] = fmaf(cv, Bs[(cg + 8 * j) * DSp + n], g[j]);
        }
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
          const int ss = cg + 8 * j, s = s0 + ss;
          float v = 0.f;
          if (r < nt && ss < ns && s <= t)
            v = g[j] * expf(cum_t - cum[s]) * dts[s];
          Gs[r * (kCols + 1) + ss] = v;
        }
        __syncwarp();                     // row r's 8 threads share a warp
        for (int ss = 0; ss < ns; ++ss) {
          const float gv = Gs[r * (kCols + 1) + ss];
          const float* xr = xs + ss * HD;
#pragma unroll
          for (int i = 0; i < kYPer; ++i) {
            const int p = cg + 8 * i;
            if (p < HD) acc[i] = fmaf(gv, xr[p], acc[i]);
          }
        }
      }
      // incoming state: exp(cum_t) * C_t . h[p]
      float ci[kYPer];
#pragma unroll
      for (int i = 0; i < kYPer; ++i) ci[i] = 0.f;
      for (int n = 0; n < DS; ++n) {
        const float cv = Cs[r * DSp + n];
#pragma unroll
        for (int i = 0; i < kYPer; ++i) {
          const int p = cg + 8 * i;
          if (p < HD) ci[i] = fmaf(cv, hs[p * DSp + n], ci[i]);
        }
      }
      if (r < nt) {
        const float ec = expf(cum_t);
#pragma unroll
        for (int i = 0; i < kYPer; ++i) {
          const int p = cg + 8 * i;
          if (p < HD) {
            const long off = ((tok0 + t) * NH + head) * HD + p;
            store(&y[off], acc[i] + ec * ci[i] + to_f32(x[off]) * dskip);
          }
        }
      }
    }

    // ---- state update: thread (warp, lane) owns h[warp + 8i][lane + 32j]
    float hacc[kHRows][kHCols];
#pragma unroll
    for (int i = 0; i < kHRows; ++i)
#pragma unroll
      for (int j = 0; j < kHCols; ++j) hacc[i][j] = 0.f;
    for (int s0 = 0; s0 < L; s0 += kCols) {
      const int ns = min(kCols, L - s0);
      __syncthreads();                    // y is done with hs, Bs, xs, Gs
      load_cols(x, Bm, tok0 + s0, ns, NH, HD, DS, head, Bs, xs);
      if (tid < kCols)                    // w_s = exp(tot - cum_s) dt_s
        Gs[tid] = tid < ns ? expf(tot - cum[s0 + tid]) * dts[s0 + tid] : 0.f;
      __syncthreads();
      for (int ss = 0; ss < ns; ++ss) {
        const float w = Gs[ss];
        const float* xr = xs + ss * HD;
        const float* br = Bs + ss * DSp;
#pragma unroll
        for (int i = 0; i < kHRows; ++i) {
          const int p = warp + 8 * i;
          if (p < HD) {
            const float wx = w * xr[p];
#pragma unroll
            for (int j = 0; j < kHCols; ++j) {
              const int n = lane + 32 * j;
              if (n < DS) hacc[i][j] = fmaf(wx, br[n], hacc[i][j]);
            }
          }
        }
      }
    }
    const float et = expf(tot);
#pragma unroll
    for (int i = 0; i < kHRows; ++i) {
      const int p = warp + 8 * i;
#pragma unroll
      for (int j = 0; j < kHCols; ++j) {
        const int n = lane + 32 * j;
        if (p < HD && n < DS)             // each element has one owner
          hs[p * DSp + n] = et * hs[p * DSp + n] + hacc[i][j];
      }
    }
  }

  __syncthreads();
  float* hb = hout + ((long)b * NH + head) * HD * DS;
  for (int e = tid; e < HD * DS; e += kThreads) {
    const int p = e / DS, n = e - p * DS;
    hb[e] = hs[p * DSp + n];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ Dv,
               T* __restrict__ y, float* __restrict__ hout, int S, int NH,
               int HD, int DS, int L, TileSched s) {
  extern __shared__ float smem[];
  const int head = blockIdx.z;
  for_each_task(s, [&](int p0, int /*p1: the grid has one parallel axis*/) {
    ssd_task<T>(x, dt, A, Bm, Cm, Dv, y, hout, S, NH, HD, DS, L, p0, head,
                smem);
  });
}

template <typename T>
int launch_t(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* Dv, void* y, void* h, int S, int NH,
             int HD, int DS, int L, dim3 grid, TileSched s, cudaStream_t st) {
  const size_t smem = smem_bytes(HD, DS, L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)Dv, (T*)y, (float*)h, S, NH, HD, DS, L, s);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y alike)
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, void* y, void* h, int S, int NH,
           int HD, int DS, int L, int dtype, int G0, dim3 grid, TileSched s,
           void* stream) {
  if (HD < 1 || HD > kMaxHD || DS < 1 || DS > kMaxDS || L < 1 || S % L ||
      NH < 1 || NH > 65535 || G0 < 1)
    return (int)cudaErrorInvalidValue;
  grid.z = NH;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L,
                           grid, s, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS,
                                   L, grid, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int ssd_plain(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* Dv, void* y, void* h, int B, int S,
              int NH, int HD, int DS, int L, int dtype, void* stream) {
  return launch(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, dtype, B,
                dim3(B, 1), plain_sched(B, 1), stream);
}

int ssd_sliced(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* Dv, void* y, void* h, int B, int S,
               int NH, int HD, int DS, int L, int dtype, int g0, int g1,
               int off0, int off1, void* stream) {
  return launch(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, dtype, B,
                dim3(g0, g1), sliced_sched(B, 1, off0, off1), stream);
}

int ssd_persistent(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* Dv, void* y,
                   void* h, int B, int S, int NH, int HD, int DS, int L,
                   int dtype, int W, int start, int budget, void* done,
                   void* stream) {
  return launch(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, dtype, B,
                dim3(W, 1), persistent_sched(B, 1, W, start, budget, done),
                stream);
}

}  // extern "C"
