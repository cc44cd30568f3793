// Scalar CSR segmented sums over work items, for segment_sum.cu (K4).
//
// The host cuts each row's elements into work items of at most a few dozen
// elements inside one row (ops/segment.py::segment_items). Pass 1 gives each
// item kGroup threads, which stride over it and add their sums with shuffles
// in a fixed order; pass 2 (items_reduce.cuh) adds each row's item partials
// in item order. No atomics: results are deterministic. A `Fetch` functor
// maps an element index to the f32 value summed.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "items_reduce.cuh"

namespace seg_items {

constexpr int kGroup = 8;       // threads per work item
constexpr int kThreads = 256;   // a multiple of 32 and of kGroup

template <class Fetch>
__global__ void __launch_bounds__(kThreads)
seg_items_kernel(Fetch f, const int64_t* __restrict__ item_lo,
                 int64_t n_items, float* __restrict__ partial) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t item = gid / kGroup;
  const int sub = (int)(gid % kGroup);
  float s = 0.f;
  if (item < n_items) {
    const int64_t hi = item_lo[item + 1];
    for (int64_t e = item_lo[item] + sub; e < hi; e += kGroup) s += f(e);
  }
  // Every thread of the warp reaches the shuffles (no early return).
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (item < n_items && sub == 0) partial[item] = s;
}

// Both passes: y[row] = sum of the row's elements under `f`.
template <class Fetch>
cudaError_t run(Fetch f, const void* item_lo, int64_t n_items,
                const void* row_items, int64_t nrows, void* partial, void* y,
                cudaStream_t st) {
  float* p = static_cast<float*>(partial);
  if (n_items > 0) {
    const int64_t blocks = (n_items * kGroup + kThreads - 1) / kThreads;
    seg_items_kernel<Fetch><<<(unsigned)blocks, kThreads, 0, st>>>(
        f, static_cast<const int64_t*>(item_lo), n_items, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return launch_items_reduce(p, static_cast<const int64_t*>(row_items), nrows,
                             static_cast<float*>(y), st);
}

}  // namespace seg_items
