// Mamba2 SSD chunk scan: y and the final state h of the SSD recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = h_t C_t + D x_t
// in two routes. x (B, S, NH, HD), Bm, Cm (B, S, DS) and y (B, S, NH, HD) in
// one type; dt (B, S, NH), A (NH), D (NH) and h (B, NH, HD, DS) f32.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_scan.py:21
// make_ssd_body / :66 mamba2_scan_desc: grid (B, nc), only the batch axis
// parallel, the chunk axis a sequential sweep with the state carried in
// VMEM scratch. In both routes a task is one batch element and runs its
// whole sweep; blockIdx.z is the head, because heads are independent in
// the recurrence and all 24 heads' state (786 KB for one batch element at
// mamba2-130m width) does not fit in a block's shared memory. The task ->
// batch mapping, the persistent done[w] and the watermark are those of
// csrc/tile_sched.cuh; every z-block of worker w writes the same done[w].
//
// Per chunk of L tokens the reference computes, in f32:
//   cum = cumsum(dt A), tot = cum[L-1];
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s      (intra)
//       + exp(cum_t) C_t . h                                      (state)
//       + D x_t                                                   (skip)
//   h  <- exp(tot) h + sum_s exp(tot - cum_s) dt_s x_s (x) B_s.
// These are the exact recurrence for any chunk length, so a kernel may
// group the tokens in pieces of its own: the result differs only in the
// order of the f32 sums.
//
// What bounds it on an H100, at mamba2-130m width (HD 64, DS 128, 24
// heads) and the BE job's B = 264, S = 512: each tensor moved once is
// 1120 MB (x and y 415 MB each, the f32 state h 208 MB, B, C and dt
// 82 MB): 0.33 ms at 3.35 TB/s. The reference's 221.5 GFLOP (C.B^T once
// per chunk) take 0.22 ms at 989 TFLOP/s; this kernel recomputes C.B^T
// for each head and runs three products twice (hi + lo, below), some
// 425 GFLOP of tensor work: 0.43 ms. Both bounds are of one order, so the
// design keeps every product on the tensor cores and reads each tile of
// x, B and C from device memory once per (batch, head) block, B and C
// mostly from L2 (the 24 head blocks of one batch element share them).
//
// bf16 route (cuda-wgmma-tma; ssd_plain, ssd_sliced, ssd_persistent;
// HD = 64, DS = 64 or 128): three warpgroups. Warpgroup 0 is the producer:
// one thread loads by TMA, with the 128-byte swizzle, a piece of 256
// tokens in 64-row slabs: x through a rank-4 map over (HD, NH, S, B) with
// box (64, 1, 64, 1), B and C through rank-3 maps over (DS, S, B), so that
// rows past S load as zeros and a task never reads the next batch
// element; each slab completes its own mbarrier, so the consumers start on
// slab 0 while the rest arrive. Pieces ignore the chunk length: L = 1 (a
// prime S) costs what L = 256 does. Warpgroups 1 and 2 are the consumers.
// Per piece, for the t-slabs {0, 3} (warpgroup 1) and {1, 2} (warpgroup 2),
// which balances the causal work:
//   (a) S = C_t B_s^T for s-slabs <= t-slab: wgmma.m64n64k16, both
//       operands K-major in shared memory (bf16 inputs: exact products);
//   (b) G = S exp(cum_t - cum_s) dt_s, masked to s <= t before the exp,
//       in registers on the accumulator fragment, split into bf16 hi + lo
//       A fragments; y += G x_s with x N-major (transpose bit);
//   (c) y += exp(cum_t) C_t h^T, h from shared memory as bf16 hi + lo;
//       then D x_t, and one rounding to bf16 at the store;
//   (d) x' = exp(tot - cum_s) dt_s x_s in f32, split hi + lo into the
//       space C leaves, and h <- exp(tot) h + x'^T B: x'^T is an M-major
//       A operand (wgmma's A-transpose bit), B N-major. Each consumer
//       keeps its 64 x 64 half of h (DS = 128; DS = 64: the first
//       consumer holds all of it) in f32 registers for the whole sweep,
//       writes its hi + lo to shared memory for the next piece's (c), and
//       writes h to hout in f32 once, at the end of the task.
// The hi + lo split of an f32 operand leaves a relative error of ~2^-16,
// so every product agrees with the f32 plain version to far below the
// bf16 rounding of y; a single bf16 rounding of G, x' or h would not
// (some 2^-9 of terms that cancel). Shared memory at DS = 128: x 32 KB,
// B 64 KB, C 64 KB (x' hi + lo after (c)), h hi + lo 32 KB, dt, cum and
// the weights 3 KB: 196 KB, one block per SM. The piece's loads do not
// overlap the previous piece's state update yet. The ring's phases come
// from a running piece counter that both roles advance through the same
// (task, piece) sequence, so they carry over from task to task in the
// persistent form.
//
// f32 route (cuda-fma; ssd_fma_*, HD <= 64, DS <= 128, L <= 4096): the
// CUDA cores, for the f32 parity shapes: per chunk, a warp scan of dt A,
// the L x L term formed in 32 x 32 tiles (masked with s <= t before the
// exp, tiles above the diagonal skipped), one head's state (HD x DS f32,
// 32 KB) in shared memory. Any L from 1 up.
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

constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kHD = 64;           // head dim: one 128-byte row of bf16
constexpr int kPiece = 256;       // tokens a piece
constexpr int kSlab = 64;         // rows a slab: wgmma's M
constexpr int kSlabs = kPiece / kSlab;
constexpr int kBox = kSlab * 128; // a 64-row TMA box, 8 KB
constexpr int kBar = 1;           // the consumers' named barrier

template <int DS>
struct Geom {
  static constexpr int kCh = DS / 64;               // boxes across DS
  static constexpr int kXBytes = kSlabs * kBox;     // x of a piece
  static constexpr int kBCSlab = kCh * kBox;        // B or C of a slab
  static constexpr int kBBytes = kSlabs * kBCSlab;
  // C, then x' hi and lo
  static constexpr int kCBytes =
      kBBytes > 2 * kXBytes ? kBBytes : 2 * kXBytes;
  static constexpr int kHBytes = kCh * kBox;        // h hi or lo, 64 x DS
  static constexpr int kOffB = kXBytes;
  static constexpr int kOffC = kOffB + kBBytes;
  static constexpr int kOffH = kOffC + kCBytes;
  static constexpr int kOffF = kOffH + 2 * kHBytes; // dt, cum, weights
  static constexpr int kOffBar = kOffF + 3 * kPiece * (int)sizeof(float);
  static constexpr size_t kSmem =
      1024 + kOffBar + (kSlabs + 1) * sizeof(uint64_t);
};

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled box
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// (x0, x1) as bf16 pairs hi and lo with hi + lo = (x0, x1) to ~2^-16
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// Accumulator fragments below are m64n64 (32 f32 a thread): d[4i + e] at
// row 16 warp + g + 8 (e >> 1), column 8i + 2q + (e & 1).
template <int DS>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Dv, __nv_bfloat16* __restrict__ y,
                  float* __restrict__ hout, int S, int NH, TileSched s) {
  using namespace hopper;
  using G = Geom<DS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = align_1024(smem_raw);
  uint8_t* bs = xs + G::kOffB;
  uint8_t* cs = xs + G::kOffC;
  uint8_t* xph = cs;                      // x' hi and lo, once C is done
  uint8_t* xpl = cs + G::kXBytes;
  uint8_t* hhi = xs + G::kOffH;
  uint8_t* hlo = hhi + G::kHBytes;
  float* dts = reinterpret_cast<float*>(xs + G::kOffF);
  float* cum = dts + kPiece;
  float* wv = cum + kPiece;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + G::kOffBar);
  uint64_t* empty = full + kSlabs;
  const int head = blockIdx.z;
  const int npieces = (S + kPiece - 1) / kPiece;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlabs; ++i) mbar_init(&full[i], 1);
    mbar_init(empty, 2);                  // one arrive per consumer
    mbar_init_fence();
  }
  __syncthreads();
  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform: wgmma under a branch it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (wg == 0) {
    // ---- producer ---------------------------------------------------------
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for_each_task(s, [&](int b, int /*one parallel axis*/) {
        for (int pc = 0; pc < npieces; ++pc, ++it) {
          const int s0 = pc * kPiece;
          const int nslab = (min(kPiece, S - s0) + kSlab - 1) / kSlab;
          mbar_wait(empty, (it & 1) ^ 1);
          // every slab's barrier completes once a piece, loaded or not, so
          // the phases stay in step
          for (int j = 0; j < kSlabs; ++j) {
            if (j >= nslab) {
              mbar_arrive(&full[j]);
              continue;
            }
            const int row = s0 + j * kSlab;
            mbar_arrive_expect_tx(&full[j], kBox + 2 * G::kBCSlab);
            tma_load_4d(xs + j * kBox, &map_x, &full[j], 0, head, row, b);
            for (int c = 0; c < G::kCh; ++c) {
              const int o = j * G::kBCSlab + c * kBox;
              tma_load_3d(bs + o, &map_b, &full[j], c * 64, row, b);
              tma_load_3d(cs + o, &map_c, &full[j], c * 64, row, b);
            }
          }
        }
      });
    }
  } else {
    // ---- consumers --------------------------------------------------------
    regs_alloc<232>();
    const int t = threadIdx.x - 128;      // 0 .. 255
    const int cw = wg - 1;                // which consumer
    const int warp = (t % 128) / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
    const bool leader = (t % 128) == 0;
    const bool owns_h = cw < G::kCh;      // h columns [64 cw, 64 cw + 64)
    const float a = A[head], dskip = Dv[head];
    int it = 0;
    for_each_task(s, [&](int b, int /*one parallel axis*/) {
      float hacc[32];
      zero(hacc);
      for (int pc = 0; pc < npieces; ++pc, ++it) {
        const int s0 = pc * kPiece;
        const int n = min(kPiece, S - s0);
        const int nslab = (n + kSlab - 1) / kSlab;
        const long tok0 = (long)b * S + s0;
        const uint32_t par = it & 1;

        // cum = cumsum(dt a) over the piece; past its end dt = 0, so cum
        // stays at cum[n - 1] = tot
        dts[t] = t < n ? dt[(tok0 + t) * NH + head] : 0.f;
        named_sync(kBar, 256);
        if (t < 32) {
          float carry = 0.f;
          for (int l0 = 0; l0 < kPiece; l0 += 32) {
            float v = dts[l0 + t] * a;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const float u = __shfl_up_sync(0xffffffffu, v, o);
              if (t >= o) v += u;
            }
            v += carry;
            cum[l0 + t] = v;
            carry = __shfl_sync(0xffffffffu, v, 31);
          }
        }
        named_sync(kBar, 256);
        const float tot = cum[kPiece - 1];
        wv[t] = expf(tot - cum[t]) * dts[t];   // read after the y barrier

        // ---- y: t-slabs {0, 3} (first consumer), {1, 2} (second) --------
        for (int i = 0; i < nslab; ++i) {
          if (((i & 3) == 0 || (i & 3) == 3) != (cw == 0)) continue;
          const uint8_t* ci = cs + i * G::kBCSlab;
          const int tr = i * kSlab + warp * 16 + g;   // rows tr, tr + 8
          float acc[32];
          zero(acc);
          for (int j = 0; j <= i; ++j) {
            mbar_wait(&full[j], par);
            if (j == 0) mbar_wait(&full[i], par);
            const uint8_t* bj = bs + j * G::kBCSlab;
            // (a) S = C_t B_s^T
            float sc[32];
            zero(sc);
            fence_regs(sc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DS / 16; ++kk) {
              const int o = (kk / 4) * kBox + (kk % 4) * 32;
              wgmma_m64n64k16_ss<0, 0>(sc, desc_sw128(ci + o, 16, 1024),
                                       desc_sw128(bj + o, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(sc);
            // (b) G, masked before the exp, as hi + lo A fragments
            uint32_t ghi[4][4], glo[4][4];
#pragma unroll
            for (int ii = 0; ii < 8; ++ii) {
              float v[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int tt = tr + 8 * (e >> 1);
                const int ss = j * kSlab + 8 * ii + 2 * q + (e & 1);
                v[e] = (ss <= tt && tt < n)
                           ? sc[4 * ii + e] * expf(cum[tt] - cum[ss]) *
                                 dts[ss]
                           : 0.f;
              }
              split_pack(v[0], v[1], ghi[ii / 2][(ii % 2) * 2],
                         glo[ii / 2][(ii % 2) * 2]);
              split_pack(v[2], v[3], ghi[ii / 2][(ii % 2) * 2 + 1],
                         glo[ii / 2][(ii % 2) * 2 + 1]);
            }
            // y += G x_s
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t dx =
                  desc_sw128(xs + j * kBox + kk * 2048, kBox, 1024);
              wgmma_m64n64k16_rs<1>(acc, ghi[kk], dx);
              wgmma_m64n64k16_rs<1>(acc, glo[kk], dx);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              fence_regs(ghi[kk]);
              fence_regs(glo[kk]);
            }
          }
          // (c) the incoming state: C_t h^T (none at the first piece)
          float yc[32];
          zero(yc);
          if (pc > 0) {
            fence_regs(yc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DS / 16; ++kk) {
              const int o = (kk / 4) * kBox + (kk % 4) * 32;
              const uint64_t dc = desc_sw128(ci + o, 16, 1024);
              wgmma_m64n64k16_ss<0, 0>(yc, dc, desc_sw128(hhi + o, 16, 1024));
              wgmma_m64n64k16_ss<0, 0>(yc, dc, desc_sw128(hlo + o, 16, 1024));
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(yc);
          }
          // y = intra + exp(cum_t) C_t h^T + D x_t, rounded once
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int tl = warp * 16 + g + 8 * e2;    // row in the slab
            const int tt = i * kSlab + tl;
            if (tt >= n) continue;
            const float ec = expf(cum[tt]);
            const uint8_t* xrow = xs + i * kBox;
            __nv_bfloat16* yrow = y + ((tok0 + tt) * NH + head) * kHD;
#pragma unroll
            for (int ii = 0; ii < 8; ++ii) {
              const float2 xf = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(
                      xrow + sw128(tl, ii) + 4 * q));
              const int k = 4 * ii + 2 * e2;
              *reinterpret_cast<__nv_bfloat162*>(yrow + 8 * ii + 2 * q) =
                  __floats2bfloat162_rn(
                      acc[k] + ec * yc[k] + dskip * xf.x,
                      acc[k + 1] + ec * yc[k + 1] + dskip * xf.y);
            }
          }
        }
        named_sync(kBar, 256);            // both are done with C and h

        // (d) x' = w_s x_s, hi + lo, into C's space (x's layout: the same
        // swizzled offsets); every slab of the piece has landed
        for (int j = 0; j < nslab; ++j) mbar_wait(&full[j], par);
        for (int o = t * 16; o < nslab * kBox; o += 256 * 16) {
          const float w = wv[o / 128];
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + o);
          const __nv_bfloat162* xp =
              reinterpret_cast<const __nv_bfloat162*>(&xv);
          uint4 hv, lv;
          uint32_t* hp = reinterpret_cast<uint32_t*>(&hv);
          uint32_t* lp = reinterpret_cast<uint32_t*>(&lv);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = __bfloat1622float2(xp[k]);
            split_pack(f.x * w, f.y * w, hp[k], lp[k]);
          }
          *reinterpret_cast<uint4*>(xph + o) = hv;
          *reinterpret_cast<uint4*>(xpl + o) = lv;
        }
        fence_async_smem();
        named_sync(kBar, 256);
        // h <- exp(tot) h + x'^T B on this consumer's columns
        if (owns_h) {
          const float et = expf(tot);
#pragma unroll
          for (int k = 0; k < 32; ++k) hacc[k] *= et;
          fence_regs(hacc);
          wgmma_fence();
          for (int j = 0; j < nslab; ++j) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int o = j * kBox + kk * 2048;
              const uint64_t db = desc_sw128(
                  bs + j * G::kBCSlab + cw * kBox + kk * 2048, kBox, 1024);
              wgmma_m64n64k16_ss<1, 1>(hacc, desc_sw128(xph + o, kBox, 1024),
                                       db);
              wgmma_m64n64k16_ss<1, 1>(hacc, desc_sw128(xpl + o, kBox, 1024),
                                       db);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(hacc);
        }
        if (leader) mbar_arrive(empty);   // x, B, C and x' are free
        // h hi + lo for the next piece's (c); the next piece's first
        // barrier hands them over
        if (owns_h && pc + 1 < npieces) {
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int p = warp * 16 + g + 8 * e2;
              const int o = cw * kBox + sw128(p, ii) + 4 * q;
              uint32_t hi, lo;
              split_pack(hacc[4 * ii + 2 * e2], hacc[4 * ii + 2 * e2 + 1],
                         hi, lo);
              *reinterpret_cast<uint32_t*>(hhi + o) = hi;
              *reinterpret_cast<uint32_t*>(hlo + o) = lo;
            }
          }
          fence_async_smem();
        }
      }
      // the final state, f32, once
      if (owns_h) {
        float* hb = hout + ((long)b * NH + head) * kHD * DS;
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int p = warp * 16 + g + 8 * e2;
            *reinterpret_cast<float2*>(hb + p * DS + cw * 64 + 8 * ii +
                                       2 * q) =
                make_float2(hacc[4 * ii + 2 * e2], hacc[4 * ii + 2 * e2 + 1]);
          }
        }
      }
    });
  }
}

template <int DS>
int launch_ds(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* Dv, void* y, void* h, int B, int S,
              int NH, dim3 grid, TileSched s, cudaStream_t st) {
  using G = Geom<DS>;
  CUtensorMap map_x, map_b, map_c;
  const cuuint64_t dims_x[4] = {(cuuint64_t)kHD, (cuuint64_t)NH,
                                (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides_x[3] = {(cuuint64_t)kHD * 2,
                                   (cuuint64_t)NH * kHD * 2,
                                   (cuuint64_t)S * NH * kHD * 2};
  const cuuint32_t box_x[4] = {64, 1, kSlab, 1};
  const cuuint64_t dims_bc[3] = {(cuuint64_t)DS, (cuuint64_t)S,
                                 (cuuint64_t)B};
  const cuuint64_t strides_bc[2] = {(cuuint64_t)DS * 2,
                                    (cuuint64_t)S * DS * 2};
  const cuuint32_t box_bc[3] = {64, kSlab, 1};
  int rc = hopper::make_map(&map_x, x, 4, dims_x, strides_x, box_x);
  if (rc == 0)
    rc = hopper::make_map(&map_b, Bm, 3, dims_bc, strides_bc, box_bc);
  if (rc == 0)
    rc = hopper::make_map(&map_c, Cm, 3, dims_bc, strides_bc, box_bc);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_tc_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmem);
  if (e != cudaSuccess) return (int)e;
  ssd_tc_kernel<DS><<<grid, kThreads, G::kSmem, st>>>(
      map_x, map_b, map_c, (const float*)dt, (const float*)A,
      (const float*)Dv, (__nv_bfloat16*)y, (float*)h, S, NH, s);
  return (int)cudaGetLastError();
}

// x, Bm, Cm and y bf16, contiguous, 16-byte aligned (SsdKernel.route
// checks); the chunk length only has to divide S
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, void* y, void* h, int B, int S,
           int NH, int HD, int DS, int L, int dtype, dim3 grid, TileSched s,
           void* stream) {
  if (dtype != 1 || HD != kHD || L < 1 || S % L || NH < 1 || NH > 65535 ||
      B < 1)
    return (int)cudaErrorInvalidValue;
  grid.z = NH;
  cudaStream_t st = (cudaStream_t)stream;
  if (DS == 64)
    return launch_ds<64>(x, dt, A, Bm, Cm, Dv, y, h, B, S, NH, grid, s, st);
  if (DS == 128)
    return launch_ds<128>(x, dt, A, Bm, Cm, Dv, y, h, B, S, NH, grid, s, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace cores {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // t rows of a tile
constexpr int kCols = 32;                 // s columns of a tile
constexpr int kMaxHD = 64;
constexpr int kMaxDS = 128;
constexpr int kYPer = kMaxHD / 8;         // y columns per thread
constexpr int kHRows = kMaxHD / 8;        // state rows per thread
constexpr int kHCols = kMaxDS / 32;       // state columns per thread

size_t smem_bytes(int HD, int DS, int L) {
  const size_t DSp = DS + 1;
  return sizeof(float) * (HD * DSp + kRows * DSp + kCols * DSp +
                          (size_t)kCols * HD + kRows * (kCols + 1) +
                          2 * (size_t)L);
}

// Bs[ss][n] = B_{s0+ss}, xs[ss][p] = x_{s0+ss}[head], zero past ns rows
__device__ void load_cols(const float* __restrict__ x,
                          const float* __restrict__ Bm,
                          long tok, int ns, int NH, int HD, int DS, int head,
                          float* Bs, float* xs) {
  const int DSp = DS + 1;
  for (int e = threadIdx.x; e < kCols * DS; e += kThreads) {
    const int ss = e / DS, n = e - ss * DS;
    Bs[ss * DSp + n] = ss < ns ? Bm[(tok + ss) * DS + n] : 0.f;
  }
  for (int e = threadIdx.x; e < kCols * HD; e += kThreads) {
    const int ss = e / HD, p = e - ss * HD;
    xs[ss * HD + p] =
        ss < ns ? x[((tok + ss) * NH + head) * HD + p] : 0.f;
  }
}

__device__ void ssd_task(const float* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const float* __restrict__ Bm,
                         const float* __restrict__ Cm,
                         const float* __restrict__ Dv, float* __restrict__ y,
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
            rr < nt ? Cm[(tok0 + t0 + rr) * DS + n] : 0.f;
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
            y[off] = acc[i] + ec * ci[i] + x[off] * dskip;
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

__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               float* __restrict__ y, float* __restrict__ hout, int S, int NH,
               int HD, int DS, int L, TileSched s) {
  extern __shared__ float smem[];
  const int head = blockIdx.z;
  for_each_task(s, [&](int p0, int /*p1: the grid has one parallel axis*/) {
    ssd_task(x, dt, A, Bm, Cm, Dv, y, hout, S, NH, HD, DS, L, p0, head,
                smem);
  });
}

int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* Dv, void* y, void* h, int S, int NH,
             int HD, int DS, int L, dim3 grid, TileSched s, cudaStream_t st) {
  const size_t smem = smem_bytes(HD, DS, L);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_kernel<<<grid, kThreads, smem, st>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)Dv, (float*)y, (float*)h, S, NH, HD,
      DS, L, s);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32 (x, Bm, Cm and y alike); bf16 takes the tc route
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, void* y, void* h, int S, int NH,
           int HD, int DS, int L, int dtype, int G0, dim3 grid, TileSched s,
           void* stream) {
  if (HD < 1 || HD > kMaxHD || DS < 1 || DS > kMaxDS || L < 1 || S % L ||
      NH < 1 || NH > 65535 || G0 < 1)
    return (int)cudaErrorInvalidValue;
  grid.z = NH;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0) return (int)cudaErrorInvalidValue;   // bf16: tc::launch
  return launch_f32(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, grid, s,
                    st);
}

}  // namespace cores

}  // namespace

extern "C" {

// bf16 x, Bm, Cm, y: tensor cores (wgmma + TMA)
int ssd_plain(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, const void* Dv, void* y, void* h, int B, int S,
              int NH, int HD, int DS, int L, int dtype, void* stream) {
  return tc::launch(x, dt, A, Bm, Cm, Dv, y, h, B, S, NH, HD, DS, L, dtype,
                    dim3(B, 1), plain_sched(B, 1), stream);
}

int ssd_sliced(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* Dv, void* y, void* h, int B, int S,
               int NH, int HD, int DS, int L, int dtype, int g0, int g1,
               int off0, int off1, void* stream) {
  return tc::launch(x, dt, A, Bm, Cm, Dv, y, h, B, S, NH, HD, DS, L, dtype,
                    dim3(g0, g1), sliced_sched(B, 1, off0, off1), stream);
}

int ssd_persistent(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* Dv, void* y,
                   void* h, int B, int S, int NH, int HD, int DS, int L,
                   int dtype, int W, int start, int budget, void* done,
                   void* stream) {
  return tc::launch(x, dt, A, Bm, Cm, Dv, y, h, B, S, NH, HD, DS, L, dtype,
                    dim3(W, 1), persistent_sched(B, 1, W, start, budget, done),
                    stream);
}

// f32 x, Bm, Cm, y: CUDA-core FMAs
int ssd_fma_plain(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* Dv, void* y,
                  void* h, int B, int S, int NH, int HD, int DS, int L,
                  int dtype, void* stream) {
  return cores::launch(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, dtype,
                       B, dim3(B, 1), plain_sched(B, 1), stream);
}

int ssd_fma_sliced(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, const void* Dv, void* y,
                   void* h, int B, int S, int NH, int HD, int DS, int L,
                   int dtype, int g0, int g1, int off0, int off1,
                   void* stream) {
  return cores::launch(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, dtype,
                       B, dim3(g0, g1), sliced_sched(B, 1, off0, off1),
                       stream);
}

int ssd_fma_persistent(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* Dv,
                       void* y, void* h, int B, int S, int NH, int HD, int DS,
                       int L, int dtype, int W, int start, int budget,
                       void* done, void* stream) {
  return cores::launch(x, dt, A, Bm, Cm, Dv, y, h, S, NH, HD, DS, L, dtype,
                       B, dim3(W, 1),
                       persistent_sched(B, 1, W, start, budget, done), stream);
}

}  // extern "C"
