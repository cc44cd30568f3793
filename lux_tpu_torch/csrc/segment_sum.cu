// K2 tail_gather_sum and K4 segment_sum_rowptr: CSR segmented sums.
//
// K2 replaces lux_tpu/ops/tiled_spmv.py::lane_select_tail_sums (jnp/lax: a
// 128-wide row gather per tail edge, a one-hot lane select, then Z-stream
// cumsum-diffs at the tail_row_ptr boundaries with a double-single prefix),
// and per part lux_tpu/engine/tiled_sharded.py::_tail_block. It computes, per
// destination v,
//   y[v] (+)= sum over e in [row_ptr[v], row_ptr[v+1]) of x[src[e]]
// where src = (tail_sb << 7) | tail_lane is the flat index of the edge's
// source value: one int32 stream, built once per plan and padded to a
// multiple of 4 entries (ops/tiled_spmv.py::DeviceHybrid). x is the (nv,)
// values on one device, or a part's exchanged (nvb, 128) table.
// K4 replaces lux_tpu/ops/merge_tail_kernel.py::root_reduce over
// lux_tpu/ops/segment.py::segment_sum_by_rowptr (jnp cumsum-diff). It
// computes y[v] = sum over the same kind of range of a flat f32 stream; with
// a lane mask, element e of an (S, 128) stream counts as zero when
// (e & 127) >= nvalid[e >> 7] (the grouped tail's root pad lanes).
//
// Bound on the H100: bytes. K2 reads 4 bytes per tail edge and 8 per row
// pointer, reads and writes y (4 + 4 bytes per row with accumulate) and
// reads the distinct source values of x once: about 0.18 GB, 0.053 ms at
// R-MAT 22. But each gather of x costs a whole 32-byte L2 sector for its 4
// bytes (the sources of one row lie far apart), 0.74 GB of sectors at R-MAT
// 22, served by the 50 MB L2 that holds x; those gathers are what the kernel
// waits on. K4: 4 bytes per stream slot plus the same per-row terms. The
// adds are one per element, far below the f32 rate.
//
// K2 design. One launch, rows straight from the row pointer, no work
// items or partial sums in memory. The blocks are balanced on edges and
// rows together (merge-path positions): row r sits at rp[r] + r, and block
// b owns the rows at positions [b * kBlockItems, (b + 1) * kBlockItems),
// found by two warp-wide searches of the row pointer (32 probes a step).
// So a block owns at most kBlockItems rows whose edges start in its stretch
// of the stream, and a hub row that spans many stretches is owned once and
// leaves the blocks of its other stretches idle. When the owned rows' edges
// fit kStage, the block reads
// their stream with 16-byte loads, coalesced, all its quads loaded before
// their gathers, and stages the gathered values in shared memory; then each
// row is summed from shared memory in edge order by its thread, or, above
// kLaneMax edges, by its warp (the lanes stride the row, then a fixed
// shuffle tree). A block whose rows hold more edges (one of them a hub
// row's kStage or more) sums each row straight from the stream: a short
// row by its thread, four gathers in flight, a longer one by the whole
// block striding its quads two at a time, the warps' sums added in warp
// order. Every row has one writer and
// each sum's order depends only on the row and its block, so the results
// are deterministic without atomics. With accumulate the sums are added
// into y (the strips' sums), which saves an elementwise pass over the rows.
// The shape is measured (python -m lux_tpu_torch.probes.shapes, R-MAT 22 on
// one device and on parts 0 and 3 at P = 4): 1,024 items a block with a
// 1,536-edge stage and 8 resident blocks came fastest everywhere; larger
// stages leave less of the SM's 256 KB to the L1 that caches x, smaller
// blocks pay their row-pointer search more often, and 128-thread blocks
// did no better. A block's search and row pass leave it at about 1.7 times
// K1's time per gather. A first form, a thread per row and 256 rows a
// block, lost to cuSPARSE: the 256 hub rows of block 0 ran alone.
// K4 keeps the work items of seg_items.cuh: the host cuts the elements into
// items of at most SEG_ITEM elements inside one row, 8 threads sum an item,
// then each row's items are added in item order.

#include <cstdint>
#include <cuda_runtime.h>

#include "seg_items.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;       // resident blocks asked of ptxas
constexpr int kBlockItems = 1024;   // rows + edges a block owns
constexpr int kStage = 1536;        // edges a block stages
constexpr int kQuadSteps = (kStage / 4 + kThreads) / kThreads;
constexpr int kLaneMax = 32;     // edges a row may have to take one thread

// The first row i in [0, n] at merge-path position rp[i] + i >= target (n
// if none), by the whole warp: 32 probes a step narrow [lo, hi] 33-fold.
__device__ __forceinline__ int64_t lower_bound_warp(const int64_t* rp,
                                                    int64_t n, int64_t target,
                                                    int lane) {
  int64_t lo = 0, hi = n;
  while (hi - lo > 32) {
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned below = __ballot_sync(0xffffffffu, rp[p] + p < target);
    const int k = __popc(below);   // probes 0 .. k-1 lie below target
    const int64_t plo = __shfl_sync(0xffffffffu, p, k > 0 ? k - 1 : 0);
    const int64_t phi = __shfl_sync(0xffffffffu, p, k < 32 ? k : 31);
    if (k > 0) lo = plo + 1;
    if (k < 32) hi = phi;
  }
  const int64_t p = lo + lane;
  return lo + __popc(
      __ballot_sync(0xffffffffu, p < hi && rp[p] + p < target));
}

// A row's sum, one thread: edges in order, four gathers in flight.
__device__ __forceinline__ float lane_sum(const float* x, const int* src,
                                          int64_t a, int64_t b) {
  float s = 0.f;
  int64_t e = a;
  for (; e + 4 <= b; e += 4) {
    const int i0 = __ldg(src + e), i1 = __ldg(src + e + 1);
    const int i2 = __ldg(src + e + 2), i3 = __ldg(src + e + 3);
    const float v0 = __ldg(x + i0), v1 = __ldg(x + i1);
    const float v2 = __ldg(x + i2), v3 = __ldg(x + i3);
    s += v0;
    s += v1;
    s += v2;
    s += v3;
  }
  for (; e < b; ++e) s += __ldg(x + __ldg(src + e));
  return s;
}

// Adds the edges of quad v (edges e .. e+3) that lie in [lo, hi).
__device__ __forceinline__ float quad_sum(int4 v, const float* x, int64_t e,
                                          int64_t lo, int64_t hi, float s) {
  if (e >= lo && e + 4 <= hi) {
    const float x0 = __ldg(x + v.x), x1 = __ldg(x + v.y);
    const float x2 = __ldg(x + v.z), x3 = __ldg(x + v.w);
    return ((s + x0) + x1 + x2) + x3;
  }
  const int idx[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k >= lo && e + k < hi) s += __ldg(x + idx[k]);
  return s;
}

// Thread t's share of row [lo, hi) when kStride threads stride its quads:
// quads q0 + t, q0 + t + kStride, ..., two loaded before either is gathered.
template <int kStride>
__device__ __forceinline__ float strided_sum(const float* x, const int4* src4,
                                             int64_t lo, int64_t hi, int t) {
  float s = 0.f;
  int64_t q = (lo >> 2) + t;
  for (; 4 * (q + kStride) < hi; q += 2 * kStride) {
    const int4 va = __ldcs(src4 + q), vb = __ldcs(src4 + q + kStride);
    s = quad_sum(va, x, 4 * q, lo, hi, s);
    s = quad_sum(vb, x, 4 * (q + kStride), lo, hi, s);
  }
  if (4 * q < hi) s = quad_sum(__ldcs(src4 + q), x, 4 * q, lo, hi, s);
  return s;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ void put(float* y, int64_t r, float s,
                                    int accumulate) {
  y[r] = accumulate ? y[r] + s : s;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tail_gather_kernel(const float* __restrict__ x, const int* __restrict__ src,
                   const int64_t* __restrict__ rp, int64_t nrows,
                   int accumulate, float* __restrict__ y) {
  __shared__ float stage[kStage];
  __shared__ int64_t owned[2];
  __shared__ int64_t long_rows[kThreads];
  __shared__ int n_long;
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int4* src4 = reinterpret_cast<const int4*>(src);
  // The rows this block owns: [r0, r1).
  if (warp < 2) {
    const int64_t r = lower_bound_warp(
        rp, nrows, (int64_t)(blockIdx.x + warp) * kBlockItems, lane);
    if (lane == 0) owned[warp] = r;
  }
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int64_t r0 = owned[0], r1 = owned[1];
  const int64_t e0 = rp[r0], e1 = rp[r1];
  if (e1 - e0 <= kStage) {
    // Stage the gathered values of the owned rows' edges.
    const int64_t q0 = e0 >> 2, nq = ((e1 + 3) >> 2) - q0;
    int4 v[kQuadSteps];
#pragma unroll
    for (int k = 0; k < kQuadSteps; ++k) {
      const int64_t i = threadIdx.x + (int64_t)k * kThreads;
      if (i < nq) v[k] = __ldcs(src4 + q0 + i);
    }
#pragma unroll
    for (int k = 0; k < kQuadSteps; ++k) {
      const int64_t i = threadIdx.x + (int64_t)k * kThreads;
      if (i < nq) {
        const int64_t e = 4 * (q0 + i);
        const int idx[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e + j >= e0 && e + j < e1) stage[e + j - e0] = __ldg(x + idx[j]);
      }
    }
    __syncthreads();
    for (int64_t base = r0; base < r1; base += kThreads) {
      const int64_t r = base + threadIdx.x;
      int64_t a = 0, b = 0;
      if (r < r1) {
        a = rp[r] - e0;
        b = rp[r + 1] - e0;
      }
      float s = 0.f;
      const bool own = b - a <= kLaneMax;
      if (own)
        for (int64_t e = a; e < b; ++e) s += stage[e];
      unsigned m = __ballot_sync(0xffffffffu, !own);
      while (m) {
        const int l = __ffs(m) - 1;
        m &= m - 1;
        const int64_t la = __shfl_sync(0xffffffffu, a, l);
        const int64_t lb = __shfl_sync(0xffffffffu, b, l);
        float t = 0.f;
        for (int64_t e = la + lane; e < lb; e += 32) t += stage[e];
        t = warp_sum(t);
        if (lane == l) s = t;
      }
      if (r < r1 && (b > a || !accumulate)) put(y, r, s, accumulate);
    }
    return;
  }
  // Rows of a block with a hub row: straight from the stream, a short row
  // by its thread, a longer one by the whole block.
  for (int64_t base = r0; base < r1; base += kThreads) {
    const int64_t r = base + threadIdx.x;
    int64_t a = 0, b = 0;
    if (r < r1) {
      a = rp[r];
      b = rp[r + 1];
    }
    if (b - a <= kLaneMax) {
      if (r < r1 && (b > a || !accumulate))
        put(y, r, lane_sum(x, src, a, b), accumulate);
    } else {
      long_rows[atomicAdd(&n_long, 1)] = r;
    }
    __syncthreads();
    const int nl = n_long;
    for (int i = 0; i < nl; ++i) {
      const int64_t h = long_rows[i];
      const float t = warp_sum(
          strided_sum<kThreads>(x, src4, rp[h], rp[h + 1], threadIdx.x));
      if (lane == 0) red[warp] = t;
      __syncthreads();
      if (threadIdx.x == 0) {
        float u = 0.f;
        for (int w = 0; w < kWarps; ++w) u += red[w];
        put(y, h, u, accumulate);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();
  }
}

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

// x: f32 values, every src index below its length; src: (m4,) int32, m4 a
// multiple of 4 and src 16-byte aligned; rp: (nrows+1,) int64 with rp[nrows]
// <= m4. y: (nrows,) f32, written, or added into with accumulate.
extern "C" int lux_tail_gather_sum(const void* x, const void* src,
                                   int64_t m4, const void* rp, int64_t nrows,
                                   int accumulate, void* y, void* stream) {
  if (nrows <= 0) return (int)cudaSuccess;
  // The last position is rp[nrows] + nrows <= m4 + nrows: every row owned.
  const int64_t blocks = (m4 + nrows) / kBlockItems + 1;
  tail_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(src),
      static_cast<const int64_t*>(rp), nrows, accumulate,
      static_cast<float*>(y));
  return (int)cudaGetLastError();
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
