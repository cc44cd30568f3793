// The row pass over a RowTasks schedule (ops/segment.py::row_tasks), shared
// by K8 and K9 (pull_sum.cu) and K10 and K5 (gas.cu).
//
// The host cuts the rows of a CSR row pointer into tasks once per graph,
// the n_hub hub rows first. A hub row takes kHubBlocks blocks (a cluster of
// that size when it is more than one; K10 takes one block): blocks
// [h * kHubBlocks, (h + 1) * kHubBlocks) sum hub row tasks[h] with all
// their threads. Every other block runs kWarps warp tasks, warp w of block
// b task n_hub + (b - n_hub * kHubBlocks) * kWarps + w, each up to 32
// consecutive rows, one a lane. A lane sums its own row alone when the row
// is short enough, and the warp sums each longer row of its task together,
// in lane order. Each row is written once, by its lane, its warp or its
// hub's first block: no partials in device memory, no second pass, no
// atomics. Hub blocks come first, so they start first.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace row_pass {

constexpr unsigned kFull = 0xffffffffu;

// Blocks of one launch over n_tasks tasks, the first n_hub of them hubs,
// rounded up to whole clusters of hub_blocks.
inline int64_t grid(int64_t n_tasks, int64_t n_hub, int warps,
                    int hub_blocks = 1) {
  const int64_t b = n_hub * hub_blocks + (n_tasks - n_hub + warps - 1) / warps;
  return (b + hub_blocks - 1) / hub_blocks * hub_blocks;
}

// The hub row this block takes part in, or -1 when it runs warp tasks.
template <int kHubBlocks = 1>
__device__ __forceinline__ int64_t hub_row(const int* __restrict__ tasks,
                                           int64_t n_hub) {
  return (int64_t)blockIdx.x < n_hub * kHubBlocks
             ? tasks[2 * (blockIdx.x / kHubBlocks)]
             : -1;
}

// This warp's task, rows [r0, r1): the lane's row r = r0 + lane and its
// edges [lo, hi), empty when r >= r1. False (for the whole warp) when the
// warp has no task.
template <int kWarps, int kHubBlocks = 1>
__device__ __forceinline__ bool warp_task(const int* __restrict__ tasks,
                                          int64_t n_tasks, int64_t n_hub,
                                          const int64_t* __restrict__ rp,
                                          int64_t& r0, int64_t& r1,
                                          int64_t& lo, int64_t& hi) {
  const int64_t task =
      n_hub + ((int64_t)blockIdx.x - n_hub * kHubBlocks) * kWarps +
      (threadIdx.x >> 5);
  if (task >= n_tasks) return false;
  r0 = tasks[2 * task];
  r1 = tasks[2 * task + 1];
  const int64_t r = r0 + (threadIdx.x & 31);
  lo = hi = 0;
  if (r < r1) {
    lo = rp[r];
    hi = rp[r + 1];
  }
  return true;
}

// Calls f(l, lo_l, hi_l) on the whole warp for each lane l set in `rows`
// (a ballot over the task's lanes), in lane order, with lane l's edges.
template <class F>
__device__ __forceinline__ void each_long_row(unsigned rows, int64_t lo,
                                              int64_t hi, F&& f) {
  for (unsigned m = rows; m; m &= m - 1) {
    const int l = __ffs(m) - 1;
    f(l, __shfl_sync(kFull, lo, l), __shfl_sync(kFull, hi, l));
  }
}

}  // namespace row_pass
