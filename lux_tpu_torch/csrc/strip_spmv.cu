// K1 strip_spmv: the strip-level SpMV of the tiled pull executor.
//
// Replaces lux_tpu/ops/tiled_spmv.py::strip_level_spmv, jnp/lax code shaped
// for the TPU: a per-chunk broadcast-multiply-reduce, transposed Z-stream
// cumsums, boundary gather-diffs and a double-single prefix correction, all
// there to avoid scatters. None of that is needed here.
//
// Computes, for every destination strip-row `row` of an (r, 128) level,
//   y[row * r + i] = sum over strips t in [row_ptr[row], row_ptr[row+1]) of
//                    sum over lanes of strips[t, i, lane] * x2d[cols[t], lane]
//
// Bound on the H100: the int8 strips, read once (r * 128 bytes per strip,
// at 3.35 TB/s). x2d (4 bytes per vertex) fits in the 50 MB L2 at the sizes
// the executor runs, the products are 2 flops per strip byte, far below the
// f32 rate, and everything else is a few bytes per strip or per row.
//
// Design. Strips are sorted by destination strip-row, so a row's strips are
// contiguous. The host cuts each row's range into work items of at most
// STRIP_ITEM strips (ops/tiled_spmv.py), because after the degree relabel a
// hub row holds thousands of strips and one warp must not walk them alone.
//   Pass 1: one warp per item. A strip is r * 8 chunks of 16 bytes; chunk c
//   covers strip row c / 8, lanes 16 * (c % 8) .. +15, and thread l takes
//   chunks l, l + 32, ... — so every load is a coalesced 16-byte load, and a
//   thread always needs the same 16 floats of the source block (lane group
//   l % 8), read as four float4. Each thread accumulates with fmaf in lane
//   order; the 8 threads of a strip row then add their sums by shuffles.
//   Strips are read with an evict-first hint: they are streamed once.
//   Pass 2 (items_reduce.cuh) sums each row's item partials in item order.
// Every addition happens in a fixed order, so results are deterministic.

#include <cstdint>
#include <cuda_runtime.h>

#include "items_reduce.cuh"

namespace {

// Signed byte b of w, as float (little-endian: byte 0 is the lowest lane).
__device__ __forceinline__ float byte_at(int w, int b) {
  return (float)((int)((unsigned)w << (24 - 8 * b)) >> 24);
}

__device__ __forceinline__ float dot4(int w, float4 x, float acc) {
  acc = fmaf(byte_at(w, 0), x.x, acc);
  acc = fmaf(byte_at(w, 1), x.y, acc);
  acc = fmaf(byte_at(w, 2), x.z, acc);
  acc = fmaf(byte_at(w, 3), x.w, acc);
  return acc;
}

constexpr int kWarpsPerBlock = 8;

template <int R>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
strip_items_kernel(const int8_t* __restrict__ strips,
                   const int32_t* __restrict__ cols,
                   const float* __restrict__ x2d,
                   const int64_t* __restrict__ item_lo, int64_t n_items,
                   float* __restrict__ partial) {
  constexpr int kChunks = R * 8;               // 16-byte chunks per strip
  constexpr int kPerThread = (kChunks + 31) / 32;
  const int64_t item =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;                 // uniform across the warp
  const int g = lane & 7;                      // this thread's 16-lane group
  const int64_t lo = item_lo[item], hi = item_lo[item + 1];

  float acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = 0.f;

  for (int64_t t = lo; t < hi; ++t) {
    const float4* xr =
        reinterpret_cast<const float4*>(x2d + (int64_t)__ldg(cols + t) * 128) +
        4 * g;
    const float4 x0 = __ldg(xr), x1 = __ldg(xr + 1);
    const float4 x2 = __ldg(xr + 2), x3 = __ldg(xr + 3);
    const int4* s = reinterpret_cast<const int4*>(strips + t * (R * 128));
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int c = lane + 32 * k;
      if (kChunks >= 32 || c < kChunks) {
        const int4 w = __ldcs(s + c);
        float a = acc[k];
        a = dot4(w.x, x0, a);
        a = dot4(w.y, x1, a);
        a = dot4(w.z, x2, a);
        a = dot4(w.w, x3, a);
        acc[k] = a;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    float v = acc[k];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    const int c = lane + 32 * k;
    if (g == 0 && c < kChunks) partial[item * R + c / 8] = v;
  }
}

template <int R>
cudaError_t launch_items(const int8_t* strips, const int32_t* cols,
                         const float* x2d, const int64_t* item_lo,
                         int64_t n_items, float* partial,
                         cudaStream_t stream) {
  const int64_t blocks = (n_items + kWarpsPerBlock - 1) / kWarpsPerBlock;
  strip_items_kernel<R><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(
      strips, cols, x2d, item_lo, n_items, partial);
  return cudaGetLastError();
}

}  // namespace

// y (nrows * r) from the level's strips; partial is (n_items, r) scratch.
extern "C" int lux_strip_spmv(const void* strips, const void* cols,
                              const void* x2d, const void* item_lo,
                              int64_t n_items, const void* row_items,
                              int64_t nrows, int r, void* partial, void* y,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* s = static_cast<const int8_t*>(strips);
  const int32_t* c = static_cast<const int32_t*>(cols);
  const float* x = static_cast<const float*>(x2d);
  const int64_t* il = static_cast<const int64_t*>(item_lo);
  float* p = static_cast<float*>(partial);
  if (n_items > 0) {
    cudaError_t e;
    switch (r) {
      case 1: e = launch_items<1>(s, c, x, il, n_items, p, st); break;
      case 2: e = launch_items<2>(s, c, x, il, n_items, p, st); break;
      case 4: e = launch_items<4>(s, c, x, il, n_items, p, st); break;
      case 8: e = launch_items<8>(s, c, x, il, n_items, p, st); break;
      case 16: e = launch_items<16>(s, c, x, il, n_items, p, st); break;
      case 32: e = launch_items<32>(s, c, x, il, n_items, p, st); break;
      case 64: e = launch_items<64>(s, c, x, il, n_items, p, st); break;
      case 128: e = launch_items<128>(s, c, x, il, n_items, p, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_items_reduce(p, static_cast<const int64_t*>(row_items),
                                  nrows, r, static_cast<float*>(y), st);
}
