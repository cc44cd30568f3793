// K8 gather_segment_sum and K9 cf_edge_sum: the flat pull engine's
// per-destination sums over CSC in-edges, with the edge function fused.
//
// K8 replaces the vals[col_src] gather of lux_tpu/engine/pull.py:465
// PullExecutor._step_impl together with lux_tpu/ops/segment.py:347
// segment_sum_by_rowptr (or :59 segment_reduce with kind="sum"), and the
// same sums on the edge-chunked path (pull.py:489) for an identity edge
// function (PageRank). It computes, per destination v,
//   acc[v] = sum over e in [row_ptr[v], row_ptr[v+1]) of vals[col_src[e]]
// K9 replaces pull.py:489 _chunked_step_impl (and the flat step) with the
// edge function of lux_tpu/models/colfilter.py:44 (collaborative filtering):
//   err_e     = (float)w_e - <vals[col_src[e], :], vals[v, :]>
//   acc[v, k] = sum over the same edges of err_e * vals[col_src[e], k]
// Neither kernel materialises per-edge contributions, so the TPU path's
// chunk cumsums, boundary gathers and double-single rebase have no
// counterpart here.
//
// Bound on the H100: bytes. Per edge, 4 bytes of col_src (K9: 4 more of
// weight); per row, 8 bytes of row offset; the (nv, K) table read once and
// the (nv, K) output written once. The table's random row reads are served
// by the 50 MB L2 (the 497,777 x 20 f32 CF table is 39.8 MB). K9 also does
// about 4K f32 operations per edge, under half of its bytes time at K = 20.
//
// Design. Rows are skewed (R-MAT hubs; CF items with up to ~377K ratings),
// so the host cuts each row's edges into work items inside one row
// (ops/segment.py::segment_items). K8 runs at K = 1 (flat PageRank) on the
// 8-thread items of seg_items.cuh. K9 runs at K = 20 (CF's width): a warp
// takes one item, one lane per edge; each lane loads its source row as
// float4, dots it with the destination row (loaded once per item, the same
// address in every lane) and scales it by the error. Each lane keeps K sums
// in registers and the warp adds them with shuffles, in a fixed order, into
// the item's partial row. Pass 2 (items_reduce.cuh) adds each row's item
// partials in item order. No atomics: results are deterministic.

#include <cstdint>
#include <cuda_runtime.h>

#include "items_reduce.cuh"
#include "seg_items.cuh"

namespace {

constexpr int kCfWidth = 20;       // CF's K (ops/segment.py::CF_WIDTH)
constexpr int kWarpThreads = 256;  // 8 warps, 8 work items per block

struct GatherFetch {
  const float* x;
  const int32_t* src;
  __device__ __forceinline__ float operator()(int64_t e) const {
    return __ldg(x + __ldg(src + e));
  }
};

template <int K>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&r)[K]) {
  static_assert(K % 4 == 0, "rows load as float4");
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < K / 4; ++i) {
    const float4 v = __ldg(q + i);
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}

// One warp per work item, one lane per edge: the item's partial row of
// sum over its edges of (w_e - <vals[src_e], vals[v]>) * vals[src_e].
// item_row is the row of vals that holds the item's destination v: v itself
// on one device, part * max_nv + v in a sharded graph's flat table
// (ops/segment.py::SegmentItems). It is read for that load only.
template <int K>
__global__ void __launch_bounds__(kWarpThreads)
cf_items_kernel(const float* __restrict__ vals,
                const int32_t* __restrict__ col_src,
                const int32_t* __restrict__ weights,
                const int64_t* __restrict__ item_lo,
                const int32_t* __restrict__ item_row, int64_t n_items,
                float* __restrict__ partial) {
  const int64_t item =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= n_items) return;  // the same for every lane of the warp
  float dst[K];
  load_row<K>(vals + (int64_t)__ldg(item_row + item) * K, dst);
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const int64_t hi = __ldg(item_lo + item + 1);
  for (int64_t e = __ldg(item_lo + item) + lane; e < hi; e += 32) {
    float src[K];
    load_row<K>(vals + (int64_t)__ldg(col_src + e) * K, src);
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dot = fmaf(src[k], dst[k], dot);
    const float err = (float)__ldg(weights + e) - dot;
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = fmaf(err, src[k], acc[k]);
  }
  float* out = partial + item * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == (k & 31)) out[k] = s;
  }
}

}  // namespace

// K8 at K = 1: vals (nv,) f32.
extern "C" int lux_gather_segment_sum(const void* vals, const void* col_src,
                                      const void* item_lo, int64_t n_items,
                                      const void* row_items, int64_t nrows,
                                      void* partial, void* y, void* stream) {
  const GatherFetch f{static_cast<const float*>(vals),
                      static_cast<const int32_t*>(col_src)};
  return (int)seg_items::run(f, item_lo, n_items, row_items, nrows, partial,
                             y, static_cast<cudaStream_t>(stream));
}

// K9 at K = kCfWidth: vals (nv, K) f32, 16-byte aligned.
extern "C" int lux_cf_edge_sum(const void* vals, const void* col_src,
                               const void* weights, const void* item_lo,
                               const void* item_row, int64_t n_items,
                               const void* row_items, int64_t nrows,
                               void* partial, void* y, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (n_items > 0) {
    const int64_t blocks = (n_items * 32 + kWarpThreads - 1) / kWarpThreads;
    cf_items_kernel<kCfWidth><<<(unsigned)blocks, kWarpThreads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(col_src),
        static_cast<const int32_t*>(weights),
        static_cast<const int64_t*>(item_lo),
        static_cast<const int32_t*>(item_row), n_items, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_items_reduce(p, static_cast<const int64_t*>(row_items),
                                  nrows, kCfWidth, static_cast<float*>(y), st);
}
