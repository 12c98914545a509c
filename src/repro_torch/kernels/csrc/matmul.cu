// Tiled matmul C(M,N) f32 = A(M,K) @ B(K,N), A and B f32 or bf16.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:26 matmul_body /
// :37 matmul_desc (grid (M/bm, N/bn, K/bk); (m, n) parallel, k sequential).
// One CUDA block is one task: the (bm x bn) output tile of the descriptor's
// grid cell (p0, p1). The block sweeps the whole K range in registers and
// overwrites its tile, which equals the reference's zero-at-k==0 then +=.
//
// What bounds it on an H100: at the model's shapes (M >= 512, K and N in
// the thousands) the product does far more than the ~295 operations per
// byte that make bf16 work compute-bound, so operations bound it. This first
// version is simple and right rather than fast: CUDA-core FMAs in f32 (not
// the tensor cores), shared-memory tiles of 128 x 16 (A) and 16 x 128 (B),
// and an 8 x 8 register tile per thread. The tile routine takes any
// divisor block size: it walks the task's tile in 128 x 128 sub-tiles and
// masks the ragged edges. wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_sched.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads, 8 x 8 outputs each
constexpr int kSub = 128;       // sub-tile edge (rows and columns)
constexpr int kDepth = 16;      // K step per shared-memory stage
constexpr int kPad = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ void matmul_tile(const T* __restrict__ A, const T* __restrict__ B,
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
          if (m < rows && k0 + k < K)
            v = to_f32(A[(row_base + m) * K + k0 + k]);
          As[k][m] = v;
        }
        // B tile: kDepth rows x kSub columns
        for (int e = tid; e < kSub * kDepth; e += kThreads) {
          const int k = e / kSub, n = e % kSub;
          float v = 0.f;
          if (n < cols && k0 + k < K)
            v = to_f32(B[(long)(k0 + k) * N + col_base + n]);
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  float* __restrict__ C, int K, int N, int bm, int bn,
                  TileSched s) {
  __shared__ float As[kDepth][kSub + kPad];
  __shared__ float Bs[kDepth][kSub + kPad];
  for_each_task(s, [&](int p0, int p1) {
    matmul_tile<T>(A, B, C, K, N, bm, bn, p0, p1, As, Bs);
  });
}

// dtype: 0 = float32, 1 = bfloat16 (A and B alike; C is always float32)
int launch(const void* a, const void* b, void* c, int M, int K, int N,
           int bm, int bn, int dtype, dim3 grid, TileSched s, void* stream) {
  (void)M;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)a, (const float*)b, (float*)c, K, N, bm, bn, s);
  } else if (dtype == 1) {
    matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)c, K, N,
        bm, bn, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matmul_plain(const void* a, const void* b, void* c, int M, int K, int N,
                 int bm, int bn, int dtype, void* stream) {
  const int G0 = M / bm, G1 = N / bn;
  return launch(a, b, c, M, K, N, bm, bn, dtype, dim3(G0, G1),
                plain_sched(G0, G1), stream);
}

int matmul_sliced(const void* a, const void* b, void* c, int M, int K, int N,
                  int bm, int bn, int dtype, int g0, int g1, int off0,
                  int off1, void* stream) {
  return launch(a, b, c, M, K, N, bm, bn, dtype, dim3(g0, g1),
                sliced_sched(M / bm, N / bn, off0, off1), stream);
}

int matmul_persistent(const void* a, const void* b, void* c, int M, int K,
                      int N, int bm, int bn, int dtype, int W, int start,
                      int budget, void* done, void* stream) {
  return launch(a, b, c, M, K, N, bm, bn, dtype, dim3(W, 1),
                persistent_sched(M / bm, N / bn, W, start, budget, done),
                stream);
}

}  // extern "C"
