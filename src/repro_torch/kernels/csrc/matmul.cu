// Tiled matmul C(M,N) f32 = A(M,K) @ B(K,N), row-major, in two routes.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:26 matmul_body /
// :37 matmul_desc (grid (M/bm, N/bn, K/bk); (m, n) parallel, k sequential).
// One task is the (bm x bn) output tile of the descriptor's grid cell
// (p0, p1); the block sweeps the whole K range and overwrites its tile,
// which equals the reference's zero-at-k==0 then +=. A task wider than 128
// in either direction is walked in 128 x 128 sub-tiles, and only the task's
// own rows and columns are written, because the sliced and persistent
// launches fill one shared output buffer. The three launch forms come from
// tile_sched.cuh.
//
// What bounds it on an H100: at the model's shapes (M >= 512, K and N in
// the thousands) a bf16 product does ~900 operations per byte, far past
// the ~295 at which the tensor cores rather than the memory set the pace,
// so operations bound it, and the card's 989 TFLOP/s of bf16 exist only
// through wgmma.
//
// bf16 route (cuda-wgmma-tma; entry points matmul_plain, matmul_sliced,
// matmul_persistent): a block of three warpgroups. Warpgroup 0 is the
// producer: one thread keeps a 4-stage ring of shared-memory tiles full by
// TMA (per stage A 128 x 64 and B 64 x 128, 32 KB, 128-byte swizzle),
// tracked by full/empty mbarriers. Warpgroups 1 and 2 are the consumers,
// 64 rows each of the 128 x 128 sub-tile: per stage four
// wgmma.m64n128k16 (A K-major, B MN-major: the transpose bit) into 64 f32
// registers a thread, one group kept in flight while the next stage is
// issued; the epilogue stores the fragment straight to C. The ring's stage
// and phase come from one running counter that the producer and the
// consumers advance through the same sequence of (task, sub-tile, k-step),
// so the phase carries over from task to task in the persistent form. K
// need not be a multiple of 64: the last stage reads zeros past K.
//
// f32 route (cuda-fma; matmul_fma_*): f32 inputs, on the CUDA cores, for
// the f32 parity shapes, where TF32 would lose the digits the 1e-4 gate
// asks for: shared-memory tiles of 128 x 16 (A) and 16 x 128 (B) and an
// 8 x 8 register tile a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "tile_sched.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kTile = 128;           // sub-tile edge
constexpr int kDepth = 64;           // K per stage (128 bytes of bf16)
constexpr int kStages = 4;
constexpr int kABytes = kTile * kDepth * 2;    // 16 KB
constexpr int kBHalf = kDepth * 64 * 2;        // 8 KB: 64 K rows x 64 N
constexpr int kStageBytes = kABytes + 2 * kBHalf;
constexpr size_t kSmem = 1024 + (size_t)kStages * kStageBytes +
                         2 * kStages * sizeof(uint64_t);

__global__ void __launch_bounds__(kThreads, 1)
    matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     float* __restrict__ C, int K, int N, int bm, int bn,
                     TileSched s) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);      // the producer's arrive + TMA bytes
      mbar_init(&empty[i], 2);     // one arrive per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int nk = (K + kDepth - 1) / kDepth;

  if (threadIdx.x < 128) {
    // ---- producer ---------------------------------------------------------
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for_each_task(s, [&](int p0, int p1) {
        for (int r0 = 0; r0 < bm; r0 += kTile) {
          for (int c0 = 0; c0 < bn; c0 += kTile) {
            const int row = p0 * bm + r0, col = p1 * bn + c0;
            // a B half wholly past N is not loaded: it would feed only
            // columns that the epilogue does not write
            const bool half2 = col + 64 < N;
            const uint32_t bytes = kABytes + (half2 ? 2 : 1) * kBHalf;
            for (int kt = 0; kt < nk; ++kt, ++it) {
              const int st = it % kStages;
              mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
              uint8_t* a = ring + st * kStageBytes;
              uint8_t* b = a + kABytes;
              mbar_arrive_expect_tx(&full[st], bytes);
              tma_load_2d(a, &map_a, &full[st], kt * kDepth, row);
              tma_load_2d(b, &map_b, &full[st], col, kt * kDepth);
              if (half2)
                tma_load_2d(b + kBHalf, &map_b, &full[st], col + 64,
                            kt * kDepth);
            }
          }
        }
      });
    }
  } else {
    // ---- consumers --------------------------------------------------------
    regs_alloc<232>();
    const int t = threadIdx.x - 128;
    const int cw = t / 128;              // which 64 rows of the sub-tile
    const int warp = (t % 128) / 32, lane = t % 32;
    const bool leader = (t % 128) == 0;
    int it = 0;
    for_each_task(s, [&](int p0, int p1) {
      for (int r0 = 0; r0 < bm; r0 += kTile) {
        for (int c0 = 0; c0 < bn; c0 += kTile) {
          float acc[64];
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = 0.f;
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int st = it % kStages;
            mbar_wait(&full[st], (it / kStages) & 1);
            const uint8_t* a = ring + st * kStageBytes + cw * 64 * 128;
            const uint8_t* b = ring + st * kStageBytes + kABytes;
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < kDepth / 16; ++kk) {
              wgmma_m64n128k16_ss<1>(acc, desc_sw128(a + kk * 32, 16, 1024),
                                     desc_sw128(b + kk * 2048, kBHalf, 1024));
            }
            wgmma_commit();
            // the previous stage's products are done: release its slot
            wgmma_wait<1>();
            fence_regs(acc);
            if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % kStages]);
          }
          wgmma_wait<0>();
          fence_regs(acc);
          if (leader) mbar_arrive(&empty[(it - 1) % kStages]);

          // epilogue: the task's own rows and columns only
          const int rows = min(kTile, bm - r0), cols = min(kTile, bn - c0);
          const int ra = cw * 64 + warp * 16 + lane / 4;
          const long row_base = (long)p0 * bm + r0;
          const long col_base = (long)p1 * bn + c0;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int c = 8 * i + 2 * (lane % 4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = ra + 8 * h;
              if (r >= rows || c >= cols) continue;
              float* dst = C + (row_base + r) * N + col_base + c;
              const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
              if (c + 1 < cols) {
                *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
              } else {
                dst[0] = v0;
              }
            }
          }
        }
      }
    });
  }
}

// A (M,K) and B (K,N) bf16, row-major, 16-byte aligned, K and N multiples
// of 8 (TMA's 16-byte row strides; MatmulKernel.route checks).
int launch(const void* a, const void* b, void* c, int M, int K, int N, int bm,
           int bn, dim3 grid, TileSched s, void* stream) {
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides_a[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box_a[2] = {kDepth, kTile};
  const cuuint64_t dims_b[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides_b[1] = {(cuuint64_t)N * 2};
  const cuuint32_t box_b[2] = {64, kDepth};
  int rc = hopper::make_map(&map_a, a, 2, dims_a, strides_a, box_a);
  if (rc == 0) rc = hopper::make_map(&map_b, b, 2, dims_b, strides_b, box_b);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  matmul_tc_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      map_a, map_b, (float*)c, K, N, bm, bn, s);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace cores {

constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int kSub = 128;       // sub-tile edge (rows and columns)
constexpr int kDepth = 16;      // K step per shared-memory stage
constexpr int kPad = 4;

__device__ void matmul_tile(const float* __restrict__ A,
                            const float* __restrict__ B,
                            float* __restrict__ C, int K, int N, int bm,
                            int bn, int p0, int p1,
                            float (*As)[kSub + kPad],
                            float (*Bs)[kSub + kPad]) {
  const int tid = threadIdx.x;
  const int tr = tid / 16;      // thread row: rows tr + 16 i
  const int tc = tid % 16;      // thread col: cols tc + 16 j
  for (int r0 = 0; r0 < bm; r0 += kSub) {
    for (int c0 = 0; c0 < bn; c0 += kSub) {
      const int rows = min(kSub, bm - r0);
      const int cols = min(kSub, bn - c0);
      const long row_base = (long)p0 * bm + r0;
      const long col_base = (long)p1 * bn + c0;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < K; k0 += kDepth) {
        // A tile: kSub rows x kDepth, stored transposed (As[k][m])
        for (int e = tid; e < kSub * kDepth; e += kThreads) {
          const int m = e / kDepth, k = e % kDepth;
          float v = 0.f;
          if (m < rows && k0 + k < K) v = A[(row_base + m) * K + k0 + k];
          As[k][m] = v;
        }
        // B tile: kDepth rows x kSub columns
        for (int e = tid; e < kSub * kDepth; e += kThreads) {
          const int k = e / kSub, n = e % kSub;
          float v = 0.f;
          if (n < cols && k0 + k < K) v = B[(long)(k0 + k) * N + col_base + n];
          Bs[k][n] = v;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          float a[8], b[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = As[k][tr + 16 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = Bs[k][tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tr + 16 * i;
        if (m >= rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tc + 16 * j;
          if (n < cols) C[(row_base + m) * N + col_base + n] = acc[i][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    matmul_fma_kernel(const float* __restrict__ A, const float* __restrict__ B,
                      float* __restrict__ C, int K, int N, int bm, int bn,
                      TileSched s) {
  __shared__ float As[kDepth][kSub + kPad];
  __shared__ float Bs[kDepth][kSub + kPad];
  for_each_task(s, [&](int p0, int p1) {
    matmul_tile(A, B, C, K, N, bm, bn, p0, p1, As, Bs);
  });
}

int launch(const void* a, const void* b, void* c, int M, int K, int N, int bm,
           int bn, dim3 grid, TileSched s, void* stream) {
  (void)M;
  matmul_fma_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)c, K, N, bm, bn, s);
  return (int)cudaGetLastError();
}

}  // namespace cores

}  // namespace

extern "C" {

// bf16 A and B: tensor cores (wgmma + TMA)
int matmul_plain(const void* a, const void* b, void* c, int M, int K, int N,
                 int bm, int bn, void* stream) {
  const int G0 = M / bm, G1 = N / bn;
  return tc::launch(a, b, c, M, K, N, bm, bn, dim3(G0, G1),
                    plain_sched(G0, G1), stream);
}

int matmul_sliced(const void* a, const void* b, void* c, int M, int K, int N,
                  int bm, int bn, int g0, int g1, int off0, int off1,
                  void* stream) {
  return tc::launch(a, b, c, M, K, N, bm, bn, dim3(g0, g1),
                    sliced_sched(M / bm, N / bn, off0, off1), stream);
}

int matmul_persistent(const void* a, const void* b, void* c, int M, int K,
                      int N, int bm, int bn, int W, int start, int budget,
                      void* done, void* stream) {
  return tc::launch(a, b, c, M, K, N, bm, bn, dim3(W, 1),
                    persistent_sched(M / bm, N / bn, W, start, budget, done),
                    stream);
}

// f32 A and B: CUDA-core FMAs
int matmul_fma_plain(const void* a, const void* b, void* c, int M, int K,
                     int N, int bm, int bn, void* stream) {
  const int G0 = M / bm, G1 = N / bn;
  return cores::launch(a, b, c, M, K, N, bm, bn, dim3(G0, G1),
                     plain_sched(G0, G1), stream);
}

int matmul_fma_sliced(const void* a, const void* b, void* c, int M, int K,
                      int N, int bm, int bn, int g0, int g1, int off0,
                      int off1, void* stream) {
  return cores::launch(a, b, c, M, K, N, bm, bn, dim3(g0, g1),
                     sliced_sched(M / bm, N / bn, off0, off1), stream);
}

int matmul_fma_persistent(const void* a, const void* b, void* c, int M,
                          int K, int N, int bm, int bn, int W, int start,
                          int budget, void* done, void* stream) {
  return cores::launch(a, b, c, M, K, N, bm, bn, dim3(W, 1),
                     persistent_sched(M / bm, N / bn, W, start, budget, done),
                     stream);
}

}  // extern "C"
