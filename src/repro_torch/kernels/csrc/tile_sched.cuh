// Task scheduling shared by every kernel family: the three launch forms of
// one tile routine. A task is one cell (p0, p1) of the descriptor's
// two-axis parallel grid (G0, G1); a one-axis grid runs as G1 = 1 with
// off1 = 0. Each task runs its full sequential sweep.
//
//   plain      : task = (blockIdx.x, blockIdx.y)
//   sliced     : task = (blockIdx.x + off0, blockIdx.y + off1)
//                (Tally's blockIdx + offset rewrite along the sliced axis)
//   persistent : W blocks; block w runs the tasks t >= start with
//                t = w (mod W), in order, at most `budget` of them, and
//                writes how many it ran to done[w]. Flat task t maps to
//                (t / G1, t % G1), the reference's _task_to_pids order.
#pragma once

#include <cuda_runtime.h>

struct TileSched {
  int G0, G1;        // full parallel grid
  int off0, off1;    // sliced form: block offsets
  int persistent;    // 0: plain or sliced, 1: persistent workers
  int W, start, budget;
  int* done;         // (W,) int32, persistent form only
};

// Calls tile(p0, p1) for every task this block owns. `tile` must be
// block-uniform (it may __syncthreads); the loop bounds are uniform too.
template <typename Tile>
__device__ __forceinline__ void for_each_task(const TileSched& s, Tile tile) {
  if (!s.persistent) {
    tile((int)blockIdx.x + s.off0, (int)blockIdx.y + s.off1);
    return;
  }
  const int w = blockIdx.x;
  const int total = s.G0 * s.G1;
  const int first = s.start + (((w - s.start) % s.W) + s.W) % s.W;
  int n = 0;
  for (int t = first; t < total && n < s.budget; t += s.W, ++n) {
    tile(t / s.G1, t % s.G1);
  }
  if (threadIdx.x == 0) s.done[w] = n;
}

static inline TileSched plain_sched(int G0, int G1) {
  return TileSched{G0, G1, 0, 0, 0, 1, 0, 0, nullptr};
}

static inline TileSched sliced_sched(int G0, int G1, int off0, int off1) {
  return TileSched{G0, G1, off0, off1, 0, 1, 0, 0, nullptr};
}

static inline TileSched persistent_sched(int G0, int G1, int W, int start,
                                         int budget, void* done) {
  return TileSched{G0, G1, 0, 0, 1, W, start, budget, (int*)done};
}
