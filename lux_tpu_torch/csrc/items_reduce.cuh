// Second pass shared by the segmented sums of this package (strip_spmv.cu,
// segment_sum.cu, pull_sum.cu).
//
// The first pass of each kernel writes one partial per work item (a
// contiguous piece of one row's elements; see ops/segment.py::segment_items)
// and `width` values per item. This pass gives each output value one thread:
//   y[row * width + i] = sum over the row's items j, in item order, of
//                        partial[j * width + i]
// so every sum is taken in a fixed order and no atomics are needed. Rows
// without items get 0. Most rows own one item, so the pass reads each
// partial once and the row pointer once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

static __global__ void __launch_bounds__(256)
items_reduce_kernel(const float* __restrict__ partial,
                    const int64_t* __restrict__ row_items, int64_t nrows,
                    int width, float* __restrict__ y) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nrows * width) return;
  const int64_t row = idx / width;
  const int i = (int)(idx - row * width);
  const int64_t a = row_items[row], b = row_items[row + 1];
  float s = 0.f;
  for (int64_t j = a; j < b; ++j) s += partial[j * width + i];
  y[idx] = s;
}

static cudaError_t launch_items_reduce(const float* partial,
                                       const int64_t* row_items,
                                       int64_t nrows, int width, float* y,
                                       cudaStream_t stream) {
  const int64_t n = nrows * width;
  if (n == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  items_reduce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      partial, row_items, nrows, width, y);
  return cudaGetLastError();
}
