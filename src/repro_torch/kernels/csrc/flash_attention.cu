// Causal-capable online-softmax (flash) attention with grouped KV heads, in
// two routes. q (BH, S, D); k, v (BH / group, T, D); o (BH, S, D) in q's
// type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:29
// make_flash_body / :66 flash_attention_desc (grid (BH, S/bq), both axes
// parallel; the KV sweep runs inside the tile with running (m, l, acc)).
// One task is head p0, query rows [p1*bq, (p1+1)*bq); its KV head is
// p0 / group. Both routes keep the reference's masking: -inf scores,
// isfinite guards so that a fully masked row gives 0 and never
// exp(-inf - -inf), l clamped at 1e-30, absolute query positions from
// q_offset, keys past T masked, and key tiles that the causal mask hides
// from every row skipped (they add exactly nothing: p = 0 and alpha = 1 or,
// while m is still -inf, 0 times 0). The three launch forms come from
// tile_sched.cuh.
//
// What bounds it on an H100: at the model's head width (D = 128) and a
// prefill of 512 or more tokens it does ~S/2 operations per byte, far past
// the bf16 balance point (~295), so operations bound it, and the tensor
// cores are the only way to them.
//
// bf16 route (cuda-wgmma-tma; flash_plain, flash_sliced,
// flash_persistent; D = 64 or 128): three warpgroups. Warpgroup 0 is the
// producer: one thread loads by TMA, with the 128-byte swizzle, the task's
// query rows 128 at a time (64 for each consumer) and then K and V tiles of
// 128 keys into a 2-stage ring tracked by full/empty mbarriers. Warpgroups
// 1 and 2 are the consumers, 64 query rows each: S = Q K^T by
// wgmma.m64n128k16 (Q and K both K-major in shared memory), the online
// softmax in registers on the accumulator fragment, P rounded to bf16 in
// registers and used as wgmma's register A operand of P V (V is MN-major:
// the transpose bit), O in 64 (D = 128) or 32 f32 registers a thread. A
// 256-row task is two passes of 128 rows, each with its own causal end.
// Stage and phase of the ring come from running counters that both roles
// advance through the same sequence of (task, pass, tile), so they carry
// over from task to task in the persistent form. At the main path's
// geometry (BH = 40, S = 512, bq = 256) the reference's grid has 80 tasks
// for 132 SMs.
//
// f32 route (cuda-fma; flash_fma_*, D <= 128): f32 inputs, on the CUDA
// cores, for the f32 parity shapes: query rows in sub-tiles of 32, keys in
// chunks of 32, m, l and the f32 accumulator of each row in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"
#include "tile_sched.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kRows = 128;       // query rows a pass (64 per consumer)
constexpr int kKeys = 128;       // keys a K/V tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Geom {
  static constexpr int kChunks = D / 64;      // 128-byte column chunks
  static constexpr int kQBox = 64 * 128;      // 64 rows x 64 values
  static constexpr int kQBytes = 2 * kChunks * kQBox;
  static constexpr int kKVChunk = kKeys * 128;
  static constexpr int kTileBytes = kChunks * kKVChunk;   // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr size_t kSmem = 1024 + kQBytes +
                                  (size_t)kStages * kStageBytes +
                                  (2 * kStages + 2) * sizeof(uint64_t);
};

// K/V tiles of the pass over rows [r, min(r + kRows, t1)): up to the last
// key the last row may see
__device__ __forceinline__ int pass_tiles(int r, int t1, int Tk, int causal,
                                          int q_offset) {
  const int kv_end = causal ? min(Tk, q_offset + min(r + kRows, t1)) : Tk;
  return kv_end > 0 ? (kv_end + kKeys - 1) / kKeys : 0;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    __nv_bfloat16* __restrict__ o, int S, int Tk, int group,
                    int bq, int causal, int q_offset, float scale_log2,
                    TileSched s) {
  using namespace hopper;
  using G = Geom<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align_1024(smem_raw);
  uint8_t* ring = qs + G::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               kStages * G::kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  uint64_t* q_empty = q_full + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ---------------------------------------------------------
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0, qi = 0;
      for_each_task(s, [&](int p0, int p1) {
        const int kvh = p0 / group;
        const int t1 = (p1 + 1) * bq;
        for (int r = p1 * bq; r < t1; r += kRows) {
          const int nt = pass_tiles(r, t1, Tk, causal, q_offset);
          // a consumer whose 64 rows all lie past the task gets no Q
          const int nq = r + 64 < t1 ? 2 : 1;
          mbar_wait(q_empty, (qi & 1) ^ 1);
          mbar_arrive_expect_tx(q_full, nq * G::kChunks * G::kQBox);
          for (int w = 0; w < nq; ++w)
            for (int c = 0; c < G::kChunks; ++c)
              tma_load_3d(qs + (w * G::kChunks + c) * G::kQBox, &map_q,
                          q_full, c * 64, r + 64 * w, p0);
          ++qi;
          for (int t = 0; t < nt; ++t, ++it) {
            const int st = it % kStages;
            mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
            uint8_t* kb = ring + st * G::kStageBytes;
            uint8_t* vb = kb + G::kTileBytes;
            mbar_arrive_expect_tx(&full[st], G::kStageBytes);
            for (int c = 0; c < G::kChunks; ++c) {
              tma_load_3d(kb + c * G::kKVChunk, &map_k, &full[st], c * 64,
                          t * kKeys, kvh);
              tma_load_3d(vb + c * G::kKVChunk, &map_v, &full[st], c * 64,
                          t * kKeys, kvh);
            }
          }
        }
      });
    }
  } else {
    // ---- consumers --------------------------------------------------------
    regs_alloc<232>();
    const int t = threadIdx.x - 128;
    const int cw = t / 128;                  // which 64 rows of the pass
    const int warp = (t % 128) / 32, lane = t % 32;
    const int g = lane / 4, qd = lane % 4;
    const bool leader = (t % 128) == 0;
    int it = 0, qi = 0;
    for_each_task(s, [&](int p0, int p1) {
      const int t1 = (p1 + 1) * bq;
      __nv_bfloat16* oh = o + (long)p0 * S * D;
      for (int r = p1 * bq; r < t1; r += kRows) {
        const int nt = pass_tiles(r, t1, Tk, causal, q_offset);
        const int w0 = r + 64 * cw;
        const int w_end = min(w0 + 64, t1);     // this consumer's task rows
        // keys past `need` are masked for every row of this consumer
        const int need =
            w0 >= t1 ? 0 : (causal ? min(Tk, q_offset + w_end) : Tk);
        const int row0 = w0 + warp * 16 + g;    // rows row0 and row0 + 8
        const int pos0 = q_offset + row0;
        float acc[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
        mbar_wait(q_full, qi & 1);
        const uint8_t* qw = qs + cw * G::kChunks * G::kQBox;
        for (int tt = 0; tt < nt; ++tt, ++it) {
          const int st = it % kStages;
          mbar_wait(&full[st], (it / kStages) & 1);
          const int c0 = tt * kKeys;
          if (c0 < need) {
            const uint8_t* kb = ring + st * G::kStageBytes;
            const uint8_t* vb = kb + G::kTileBytes;
            // S = Q K^T, 64 rows x 128 keys
            float sc[64];
#pragma unroll
            for (int i = 0; i < 64; ++i) sc[i] = 0.f;
            fence_regs(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const int c = kk / 4, off = (kk % 4) * 32;
              wgmma_m64n128k16_ss<0>(
                  sc, desc_sw128(qw + c * G::kQBox + off, 16, 1024),
                  desc_sw128(kb + c * G::kKVChunk + off, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);

            // scores in log2 units, masked; the rows' maxima
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int i = 0; i < 16; ++i) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = c0 + 8 * i + 2 * qd + e;
                float s0 = sc[4 * i + e] * scale_log2;
                float s1 = sc[4 * i + 2 + e] * scale_log2;
                if (key >= Tk || (causal && pos0 < key)) s0 = -INFINITY;
                if (key >= Tk || (causal && pos0 + 8 < key)) s1 = -INFINITY;
                sc[4 * i + e] = s0;
                sc[4 * i + 2 + e] = s1;
                mx0 = fmaxf(mx0, s0);
                mx1 = fmaxf(mx1, s1);
              }
            }
            const float mn0 = fmaxf(m0, quad_max(mx0));
            const float mn1 = fmaxf(m1, quad_max(mx1));
            const float ms0 = isfinite(mn0) ? mn0 : 0.f;
            const float ms1 = isfinite(mn1) ? mn1 : 0.f;
            const float al0 = isfinite(m0) ? exp2f(m0 - ms0) : 0.f;
            const float al1 = isfinite(m1) ? exp2f(m1 - ms1) : 0.f;
            m0 = mn0;
            m1 = mn1;
            // P in the register layout of wgmma's A operand: 16 keys (two
            // 8-column groups) a k-step, rows g and g + 8
            uint32_t pa[8][4];
            float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              float p[4];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float s0 = sc[4 * i + e], s1 = sc[4 * i + 2 + e];
                p[e] = isfinite(s0) ? exp2f(s0 - ms0) : 0.f;
                p[2 + e] = isfinite(s1) ? exp2f(s1 - ms1) : 0.f;
              }
              ps0 += p[0] + p[1];
              ps1 += p[2] + p[3];
              pa[i / 2][(i % 2) * 2] = pack_bf16(p[0], p[1]);
              pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
            }
            // each thread keeps the sum over its own columns; alpha is
            // the row's, so the partial sums rescale like the whole
            l0 = l0 * al0 + ps0;
            l1 = l1 * al1 + ps1;
#pragma unroll
            for (int i = 0; i < D / 8; ++i) {
              acc[4 * i] *= al0;
              acc[4 * i + 1] *= al0;
              acc[4 * i + 2] *= al1;
              acc[4 * i + 3] *= al1;
            }
            // O += P V
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < kKeys / 16; ++j) {
              const uint64_t dv = desc_sw128(vb + j * 2048, G::kKVChunk, 1024);
              if constexpr (D == 128) {
                wgmma_m64n128k16_rs<1>(acc, pa[j], dv);
              } else {
                wgmma_m64n64k16_rs<1>(acc, pa[j], dv);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int j = 0; j < kKeys / 16; ++j) fence_regs(pa[j]);
          }
          if (leader) mbar_arrive(&empty[st]);
        }
        if (leader) mbar_arrive(q_empty);
        ++qi;

        const float d0 = fmaxf(quad_sum(l0), 1e-30f);
        const float d1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int c = 8 * i + 2 * qd;
          if (row0 < w_end)
            *reinterpret_cast<__nv_bfloat162*>(oh + (long)row0 * D + c) =
                __floats2bfloat162_rn(acc[4 * i] / d0, acc[4 * i + 1] / d0);
          if (row0 + 8 < w_end)
            *reinterpret_cast<__nv_bfloat162*>(oh + (long)(row0 + 8) * D +
                                               c) =
                __floats2bfloat162_rn(acc[4 * i + 2] / d1,
                                      acc[4 * i + 3] / d1);
        }
      }
    });
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int BH,
             int S, int Tk, int group, int bq, int causal, int q_offset,
             float scale, dim3 grid, TileSched s, cudaStream_t st) {
  using G = Geom<D>;
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t dims_q[3] = {(cuuint64_t)D, (cuuint64_t)S,
                                (cuuint64_t)BH};
  const cuuint64_t strides_q[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box_q[3] = {64, 64, 1};
  const cuuint64_t dims_kv[3] = {(cuuint64_t)D, (cuuint64_t)Tk,
                                 (cuuint64_t)(BH / group)};
  const cuuint64_t strides_kv[2] = {(cuuint64_t)D * 2,
                                    (cuuint64_t)Tk * D * 2};
  const cuuint32_t box_kv[3] = {64, kKeys, 1};
  int rc = hopper::make_map(&map_q, q, 3, dims_q, strides_q, box_q);
  if (rc == 0)
    rc = hopper::make_map(&map_k, k, 3, dims_kv, strides_kv, box_kv);
  if (rc == 0)
    rc = hopper::make_map(&map_v, v, 3, dims_kv, strides_kv, box_kv);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmem);
  if (e != cudaSuccess) return (int)e;
  flash_tc_kernel<D><<<grid, kThreads, G::kSmem, st>>>(
      map_q, map_k, map_v, (__nv_bfloat16*)o, S, Tk, group, bq, causal,
      q_offset, scale * kLog2e, s);
  return (int)cudaGetLastError();
}

// q, k, v and o bf16, contiguous, 16-byte aligned (FlashKernel.route
// checks)
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int Tk, int D, int group, int bq, int causal, int q_offset,
           float scale, dim3 grid, TileSched s, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return launch_d<64>(q, k, v, o, BH, S, Tk, group, bq, causal, q_offset,
                        scale, grid, s, st);
  if (D == 128)
    return launch_d<128>(q, k, v, o, BH, S, Tk, group, bq, causal, q_offset,
                         scale, grid, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace cores {

constexpr int kThreads = 128;   // 4 threads per query row
constexpr int kRows = 32;       // query rows per sub-tile
constexpr int kCols = 32;       // keys per chunk
constexpr int kMaxD = 128;
constexpr int kDPer = kMaxD / 4;   // head-dim columns per thread

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * (D + 1) + (size_t)kCols * (D + 1) +
                          (size_t)kCols * D + (size_t)kRows * (kCols + 1));
}

__device__ void flash_tile(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int S, int Tk, int D, int group, int bq, int causal,
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
  const float* qh = q + (long)p0 * S * D;
  const float* kh = k + (long)(p0 / group) * Tk * D;
  const float* vh = v + (long)(p0 / group) * Tk * D;
  float* oh = o + (long)p0 * S * D;

  for (int rs = 0; rs < bq; rs += kRows) {
    const int q0 = p1 * bq + rs;
    const int nrows = min(kRows, bq - rs);
    __syncthreads();                   // the last sub-tile is done with Qs
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int rr = e / D, d = e % D;
      float x = 0.f;
      if (rr < nrows) x = qh[(long)(q0 + rr) * D + d] * scale;
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
          kx = kh[(long)(c0 + cc) * D + d];
          vx = vh[(long)(c0 + cc) * D + d];
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
        if (d < D) oh[(long)(q0 + r) * D + d] = acc[i] / denom;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int Tk, int D, int group, int bq, int causal,
                     int q_offset, float scale, TileSched s) {
  extern __shared__ float smem[];
  for_each_task(s, [&](int p0, int p1) {
    flash_tile(q, k, v, o, S, Tk, D, group, bq, causal, q_offset, scale, p0,
               p1, smem);
  });
}

// q, k, v and o f32, D <= 128
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int S, int Tk, int D, int group, int bq, int causal, int q_offset,
           float scale, dim3 grid, TileSched s, void* stream) {
  (void)BH;
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_fma_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, Tk, D,
      group, bq, causal, q_offset, scale, s);
  return (int)cudaGetLastError();
}

}  // namespace cores

}  // namespace

extern "C" {

// bf16 q, k, v, o: tensor cores (wgmma + TMA)
int flash_plain(const void* q, const void* k, const void* v, void* o, int BH,
                int S, int Tk, int D, int group, int bq, int causal,
                int q_offset, float scale, void* stream) {
  const int G0 = BH, G1 = S / bq;
  return tc::launch(q, k, v, o, BH, S, Tk, D, group, bq, causal, q_offset,
                   scale, dim3(G0, G1), plain_sched(G0, G1), stream);
}

int flash_sliced(const void* q, const void* k, const void* v, void* o,
                 int BH, int S, int Tk, int D, int group, int bq,
                 int causal, int q_offset, float scale, int g0, int g1,
                 int off0, int off1, void* stream) {
  return tc::launch(q, k, v, o, BH, S, Tk, D, group, bq, causal, q_offset,
                   scale, dim3(g0, g1), sliced_sched(BH, S / bq, off0, off1),
                   stream);
}

int flash_persistent(const void* q, const void* k, const void* v, void* o,
                     int BH, int S, int Tk, int D, int group, int bq,
                     int causal, int q_offset, float scale, int W,
                     int start, int budget, void* done, void* stream) {
  return tc::launch(q, k, v, o, BH, S, Tk, D, group, bq, causal, q_offset,
                   scale, dim3(W, 1),
                   persistent_sched(BH, S / bq, W, start, budget, done),
                   stream);
}

// f32 q, k, v, o: CUDA-core FMAs
int flash_fma_plain(const void* q, const void* k, const void* v, void* o, int BH,
                    int S, int Tk, int D, int group, int bq, int causal,
                    int q_offset, float scale, void* stream) {
  const int G0 = BH, G1 = S / bq;
  return cores::launch(q, k, v, o, BH, S, Tk, D, group, bq, causal, q_offset,
                      scale, dim3(G0, G1), plain_sched(G0, G1), stream);
}

int flash_fma_sliced(const void* q, const void* k, const void* v, void* o,
                     int BH, int S, int Tk, int D, int group, int bq,
                     int causal, int q_offset, float scale, int g0, int g1,
                     int off0, int off1, void* stream) {
  return cores::launch(q, k, v, o, BH, S, Tk, D, group, bq, causal, q_offset,
                      scale, dim3(g0, g1), sliced_sched(BH, S / bq, off0, off1),
                      stream);
}

int flash_fma_persistent(const void* q, const void* k, const void* v, void* o,
                         int BH, int S, int Tk, int D, int group, int bq,
                         int causal, int q_offset, float scale, int W,
                         int start, int budget, void* done, void* stream) {
  return cores::launch(q, k, v, o, BH, S, Tk, D, group, bq, causal, q_offset,
                      scale, dim3(W, 1),
                      persistent_sched(BH, S / bq, W, start, budget, done),
                      stream);
}

}  // extern "C"
