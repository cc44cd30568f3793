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
// waits on. K4 needs 4 bytes per live element (lane < nvalid, about 31% of
// the root stream at R-MAT 22) plus nvalid and the same per-row terms; it
// reads the whole quads of the stream, pad lanes too. The adds are one per
// element, far below the f32 rate.
//
// Design. One launch, rows straight from the row pointer, no work items or
// partial sums in memory. The blocks are balanced on edges and rows together
// (merge-path positions): row r sits at rp[r] + r, and block b owns the rows
// at positions [b * kBlockItems, (b + 1) * kBlockItems), found by two
// warp-wide searches of the row pointer (32 probes a step). So a block owns
// at most kBlockItems rows whose edges start in its stretch of the stream,
// and a hub row that spans many stretches is owned once and leaves the
// blocks of its other stretches idle. When the owned rows' edges fit kStage,
// the block reads their stream with 16-byte loads, coalesced, all its quads
// loaded before they are fetched, and stages the fetched values in shared
// memory; then each row is summed from shared memory in edge order by its
// thread, or, above kLaneMax edges, by its warp (the lanes stride the row,
// then a fixed shuffle tree). A block whose rows hold more edges (one of
// them a hub row's kStage or more) sums each row straight from the stream: a
// short row by its thread, four fetches in flight, a longer one by the whole
// block striding its quads two at a time, the warps' sums added in warp
// order. Every row has one writer and each sum's order depends only on the
// row and its block, so the results are deterministic without atomics. With
// accumulate the sums are added into y (the strips' sums), which saves an
// elementwise pass over the rows.
// The row pass is one template over a fetch policy (Gather for K2: the
// source values of an index stream; Masked for K4: the stream itself, the
// lane mask applied as it is staged) and the block shape, each kernel with
// its own constants, measured by python -m lux_tpu_torch.probes.shapes
// --only k2 k4 at R-MAT 22.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// K2: threads a block, resident blocks asked of ptxas, rows + edges a block
// owns, edges a block stages. Larger stages leave less of the SM's shared
// memory to the L1 that caches x; smaller blocks search the row pointer more
// often; 128-thread blocks did no better.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;
constexpr int kBlockItems = 1024;
constexpr int kStage = 1536;
// K4's: 256- and 512-thread blocks were slower at every window and stage.
constexpr int kThreads4 = 128;
constexpr int kMinBlocks4 = 12;
constexpr int kBlockItems4 = 1024;
constexpr int kStage4 = 1536;
constexpr int kLaneMax = 32;     // edges a row may have to take one thread

// The fetch policies: what element e of the stream adds, read a 16-byte quad
// (elements 4q .. 4q + 3) at a time by load(q), then value(v, j, q) for
// element j of it, or alone by at(e).
// K2: the source values of an int32 index stream (16-byte aligned, a
// multiple of 4 entries).
struct Gather {
  const float* x;
  const int* src;
  __device__ __forceinline__ int4 load(int64_t q) const {
    return __ldcs(reinterpret_cast<const int4*>(src) + q);
  }
  __device__ __forceinline__ float value(const int4& v, int j,
                                         int64_t) const {
    return __ldg(x + (j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w));
  }
  __device__ __forceinline__ float at(int64_t e) const {
    return __ldg(x + __ldg(src + e));
  }
};

// K4: a contiguous f32 stream of n elements (16-byte aligned); with nvalid,
// an (S, 128) stream whose lanes (e & 127) >= nvalid[e >> 7] count as zero.
// A quad never straddles two rows of 128.
struct Masked {
  const float* x;
  const int* nvalid;   // null: no mask
  int64_t n;
  __device__ __forceinline__ float4 load(int64_t q) const {
    if (4 * q + 4 <= n) return __ldcs(reinterpret_cast<const float4*>(x) + q);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * q < n) v.x = __ldcs(x + 4 * q);
    if (4 * q + 1 < n) v.y = __ldcs(x + 4 * q + 1);
    if (4 * q + 2 < n) v.z = __ldcs(x + 4 * q + 2);
    return v;
  }
  __device__ __forceinline__ float value(const float4& v, int j,
                                         int64_t q) const {
    if (nvalid != nullptr && (int)((4 * q) & 127) + j >= __ldg(nvalid + (q >> 5)))
      return 0.f;
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  __device__ __forceinline__ float at(int64_t e) const {
    if (nvalid != nullptr && (int)(e & 127) >= __ldg(nvalid + (e >> 7)))
      return 0.f;
    return __ldcs(x + e);
  }
};

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

// A row's sum, one thread: elements in order, four fetches in flight.
template <class F>
__device__ __forceinline__ float lane_sum(const F& f, int64_t a, int64_t b) {
  float s = 0.f;
  int64_t e = a;
  for (; e + 4 <= b; e += 4) {
    const float v0 = f.at(e), v1 = f.at(e + 1);
    const float v2 = f.at(e + 2), v3 = f.at(e + 3);
    s += v0;
    s += v1;
    s += v2;
    s += v3;
  }
  for (; e < b; ++e) s += f.at(e);
  return s;
}

// Adds the elements of quad q (elements 4q .. 4q+3, loaded as v) that lie in
// [lo, hi).
template <class F, class V>
__device__ __forceinline__ float quad_sum(const F& f, const V& v, int64_t q,
                                          int64_t lo, int64_t hi, float s) {
  const int64_t e = 4 * q;
  if (e >= lo && e + 4 <= hi) {
    const float x0 = f.value(v, 0, q), x1 = f.value(v, 1, q);
    const float x2 = f.value(v, 2, q), x3 = f.value(v, 3, q);
    return ((s + x0) + x1 + x2) + x3;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k >= lo && e + k < hi) s += f.value(v, k, q);
  return s;
}

// Thread t's share of row [lo, hi) when kStride threads stride its quads:
// quads q0 + t, q0 + t + kStride, ..., two loaded before either is fetched.
template <int kStride, class F>
__device__ __forceinline__ float strided_sum(const F& f, int64_t lo,
                                             int64_t hi, int t) {
  float s = 0.f;
  int64_t q = (lo >> 2) + t;
  for (; 4 * (q + kStride) < hi; q += 2 * kStride) {
    const auto va = f.load(q);
    const auto vb = f.load(q + kStride);
    s = quad_sum(f, va, q, lo, hi, s);
    s = quad_sum(f, vb, q + kStride, lo, hi, s);
  }
  if (4 * q < hi) s = quad_sum(f, f.load(q), q, lo, hi, s);
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

template <class F, int kThr, int kItems, int kSt, int kMin>
__global__ void __launch_bounds__(kThr, kMin)
row_sum_kernel(F f, const int64_t* __restrict__ rp, int64_t nrows,
               int accumulate, float* __restrict__ y) {
  constexpr int kWarps = kThr / 32;
  constexpr int kQuadSteps = (kSt / 4 + kThr) / kThr;
  __shared__ float stage[kSt];
  __shared__ int64_t owned[2];
  __shared__ int64_t long_rows[kThr];
  __shared__ int n_long;
  __shared__ float red[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The rows this block owns: [r0, r1).
  if (warp < 2) {
    const int64_t r = lower_bound_warp(
        rp, nrows, (int64_t)(blockIdx.x + warp) * kItems, lane);
    if (lane == 0) owned[warp] = r;
  }
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int64_t r0 = owned[0], r1 = owned[1];
  // The first kThr rows' bounds, loaded with the block's span.
  const int64_t r = r0 + threadIdx.x;
  int64_t a = 0, b = 0;
  if (r < r1) {
    a = rp[r];
    b = rp[r + 1];
  }
  const int64_t e0 = rp[r0], e1 = rp[r1];
  if (e1 - e0 <= kSt) {
    // Stage the fetched elements of the owned rows.
    const int64_t q0 = e0 >> 2, nq = ((e1 + 3) >> 2) - q0;
    decltype(f.load(0)) v[kQuadSteps];
#pragma unroll
    for (int k = 0; k < kQuadSteps; ++k) {
      const int64_t i = threadIdx.x + (int64_t)k * kThr;
      if (i < nq) v[k] = f.load(q0 + i);
    }
#pragma unroll
    for (int k = 0; k < kQuadSteps; ++k) {
      const int64_t i = threadIdx.x + (int64_t)k * kThr;
      if (i < nq) {
        const int64_t e = 4 * (q0 + i);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (e + j >= e0 && e + j < e1)
            stage[e + j - e0] = f.value(v[k], j, q0 + i);
      }
    }
    __syncthreads();
    for (int64_t base = r0; base < r1; base += kThr) {
      const int64_t rr = base + threadIdx.x;
      if (base > r0) {
        a = b = 0;
        if (rr < r1) {
          a = rp[rr];
          b = rp[rr + 1];
        }
      }
      a -= e0;
      b -= e0;
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
      if (rr < r1 && (b > a || !accumulate)) put(y, rr, s, accumulate);
    }
    return;
  }
  // Rows of a block with a hub row: straight from the stream, a short row
  // by its thread, a longer one by the whole block.
  for (int64_t base = r0; base < r1; base += kThr) {
    const int64_t rr = base + threadIdx.x;
    if (base > r0) {
      a = b = 0;
      if (rr < r1) {
        a = rp[rr];
        b = rp[rr + 1];
      }
    }
    if (b - a <= kLaneMax) {
      if (rr < r1 && (b > a || !accumulate))
        put(y, rr, lane_sum(f, a, b), accumulate);
    } else {
      long_rows[atomicAdd(&n_long, 1)] = rr;
    }
    __syncthreads();
    const int nl = n_long;
    for (int i = 0; i < nl; ++i) {
      const int64_t h = long_rows[i];
      const float t = warp_sum(
          strided_sum<kThr>(f, rp[h], rp[h + 1], threadIdx.x));
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

// One launch over a stream of n elements: every row owned, since the last
// position is rp[nrows] + nrows <= n + nrows.
template <class F, int kThr, int kItems, int kSt, int kMin>
cudaError_t launch_rows(const F& f, int64_t n, const void* rp, int64_t nrows,
                        int accumulate, void* y, cudaStream_t st) {
  if (nrows <= 0) return cudaSuccess;
  const int64_t blocks = (n + nrows) / kItems + 1;
  row_sum_kernel<F, kThr, kItems, kSt, kMin>
      <<<(unsigned)blocks, kThr, 0, st>>>(f, static_cast<const int64_t*>(rp),
                                          nrows, accumulate,
                                          static_cast<float*>(y));
  return cudaGetLastError();
}

}  // namespace

// x: f32 values, every src index below its length; src: (m4,) int32, m4 a
// multiple of 4 and src 16-byte aligned; rp: (nrows+1,) int64 with rp[nrows]
// <= m4. y: (nrows,) f32, written, or added into with accumulate.
extern "C" int lux_tail_gather_sum(const void* x, const void* src,
                                   int64_t m4, const void* rp, int64_t nrows,
                                   int accumulate, void* y, void* stream) {
  const Gather f{static_cast<const float*>(x), static_cast<const int*>(src)};
  return (int)launch_rows<Gather, kThreads, kBlockItems, kStage, kMinBlocks>(
      f, m4, rp, nrows, accumulate, y, static_cast<cudaStream_t>(stream));
}

// data: (n,) f32, 16-byte aligned; with nvalid (n / 128,) int32 (nullable),
// an (S, 128) stream masked by lane. rp: (nrows+1,) int64 with rp[nrows] <=
// n. y: (nrows,) f32, written, or added into with accumulate.
extern "C" int lux_segment_sum_rowptr(const void* data, const void* nvalid,
                                      int64_t n, const void* rp,
                                      int64_t nrows, int accumulate, void* y,
                                      void* stream) {
  const Masked f{static_cast<const float*>(data),
                 static_cast<const int*>(nvalid), n};
  return (int)launch_rows<Masked, kThreads4, kBlockItems4, kStage4,
                                   kMinBlocks4>(
      f, n, rp, nrows, accumulate, y, static_cast<cudaStream_t>(stream));
}
