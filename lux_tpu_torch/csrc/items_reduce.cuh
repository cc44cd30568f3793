// Second pass of the segmented sums over work items (seg_items.cuh, K4 in
// segment_sum.cu).
//
// The first pass writes one partial per work item (a contiguous piece of
// one row's elements; see ops/segment.py::segment_items). This pass gives
// each row one thread:
//   y[row] = sum over the row's items j, in item order, of partial[j]
// so every sum is taken in a fixed order and no atomics are needed. Rows
// without items get 0. Most rows own one item, so the pass reads each
// partial once and the row pointer once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

static __global__ void __launch_bounds__(256)
items_reduce_kernel(const float* __restrict__ partial,
                    const int64_t* __restrict__ row_items, int64_t nrows,
                    float* __restrict__ y) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= nrows) return;
  const int64_t a = row_items[row], b = row_items[row + 1];
  float s = 0.f;
  for (int64_t j = a; j < b; ++j) s += partial[j];
  y[row] = s;
}

static cudaError_t launch_items_reduce(const float* partial,
                                       const int64_t* row_items,
                                       int64_t nrows, float* y,
                                       cudaStream_t stream) {
  if (nrows == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (nrows + threads - 1) / threads;
  items_reduce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      partial, row_items, nrows, y);
  return cudaGetLastError();
}
