// K2 tail_gather_sum and K4 segment_sum_rowptr: CSR segmented sums.
//
// K2 replaces lux_tpu/ops/tiled_spmv.py::lane_select_tail_sums (jnp/lax: a
// 128-wide row gather per tail edge, a one-hot lane select, then Z-stream
// cumsum-diffs at the tail_row_ptr boundaries with a double-single prefix).
// It computes, per destination v,
//   y[v] = sum over e in [row_ptr[v], row_ptr[v+1]) of
//          x2d[(tail_sb[e] << 7) | tail_lane[e]]
// K4 replaces lux_tpu/ops/merge_tail_kernel.py::root_reduce over
// lux_tpu/ops/segment.py::segment_sum_by_rowptr (jnp cumsum-diff). It
// computes y[v] = sum over the same kind of range of a flat f32 stream; with
// a lane mask, element e of an (S, 128) stream counts as zero when
// (e & 127) >= nvalid[e >> 7] (the grouped tail's root pad lanes).
//
// Bound on the H100: the bytes of the inputs and output read or written
// once — K2: 4 + 1 bytes per tail edge, 8 per row pointer, 4 per output,
// plus the (nvb, 128) operand, whose random 4-byte reads are served by the
// 50 MB L2; K4: 4 bytes per stream slot plus the same per-row terms. The
// adds are one per element, far below the f32 rate.
//
// Design. Rows are skewed (R-MAT, degree-relabelled), so the host cuts the
// elements into work items of at most SEG_ITEM elements, each inside one
// row; seg_items.cuh sums each item with 8 threads, then each row's items in
// item order. No atomics: results are deterministic.

#include <cstdint>
#include <cuda_runtime.h>

#include "seg_items.cuh"

namespace {

struct TailFetch {
  const float* x;
  const int32_t* sb;
  const int8_t* lane;
  __device__ __forceinline__ float operator()(int64_t e) const {
    const int64_t i = ((int64_t)__ldg(sb + e) << 7) | (__ldg(lane + e) & 127);
    return __ldg(x + i);
  }
};

struct MaskedFetch {
  const float* x;
  const int32_t* nvalid;  // null: no mask
  __device__ __forceinline__ float operator()(int64_t e) const {
    const float v = __ldcs(x + e);
    if (nvalid != nullptr && (int)(e & 127) >= __ldg(nvalid + (e >> 7)))
      return 0.f;
    return v;
  }
};

}  // namespace

extern "C" int lux_tail_gather_sum(const void* x2d, const void* sb,
                                   const void* lane, const void* item_lo,
                                   int64_t n_items, const void* row_items,
                                   int64_t nrows, void* partial, void* y,
                                   void* stream) {
  const TailFetch f{static_cast<const float*>(x2d),
                    static_cast<const int32_t*>(sb),
                    static_cast<const int8_t*>(lane)};
  return (int)seg_items::run(f, item_lo, n_items, row_items, nrows, partial,
                             y, static_cast<cudaStream_t>(stream));
}

extern "C" int lux_segment_sum_rowptr(const void* data, const void* nvalid,
                                      const void* item_lo, int64_t n_items,
                                      const void* row_items, int64_t nrows,
                                      void* partial, void* y, void* stream) {
  const MaskedFetch f{static_cast<const float*>(data),
                      static_cast<const int32_t*>(nvalid)};
  return (int)seg_items::run(f, item_lo, n_items, row_items, nrows, partial,
                             y, static_cast<cudaStream_t>(stream));
}
