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
//   err_e     = (float)w_e - <vals[col_src[e], :], vals[row_base + v, :]>
//   acc[v, k] = sum over the same edges of err_e * vals[col_src[e], k]
// row_base is 0 on one device and part * max_nv for a part of a sharded
// graph, whose destinations are its own span of the flat table. Neither
// kernel materialises per-edge contributions, so the TPU path's chunk
// cumsums, boundary gathers and double-single rebase have no counterpart.
//
// Bound on the H100: bytes. Per edge, 4 bytes of col_src (K9: 4 more of
// weight); per row, 8 bytes of row offset; the (nv, K) table read once and
// the (nv, K) output written once. K9 also does about 4K f32 operations
// per edge, under half of its bytes time at K = 20. But every edge gathers
// its source at random, and L2 serves whole 32-byte sectors: K8 reads one
// sector per edge (2.15 GB at R-MAT 22, 67.1 M edges), K9 the three sectors
// an 80-byte row spans (9.66 GB on the NetFlix-shaped ratings graph, 100.7
// M edges). Those sector reads at L2's rate are the floor left, with L1's:
// a warp's load instruction costs L1 one pass per distinct 128-byte line it
// touches, so 32 lanes each loading 16 bytes of its own random row take 32
// passes for 512 bytes. K9 gives an edge a group of five lanes, each
// loading 16 bytes of the row, so one instruction reads six whole rows in
// about nine lines, and each group keeps kUnroll9 edges' rows in flight.
// Its sources go through L1, where the hot item rows stay: a user's
// ratings gather the 17,777 item rows (1.4 MB), most of them the popular
// few.
//
// Design: one writer per row over the RowTasks schedule of row_pass.cuh,
// built once per graph with each kernel's thresholds
// (ops/segment.py::pull_row_tasks). K8: a lane sums a row of up to
// kLaneMax8 edges alone; the warp of a task sums each longer row, lane l
// taking the row's edges l, l + 32, ...; a hub row's block does the same
// with its 256 threads. Each thread adds its edges in order, the lanes of
// a warp are added by an xor butterfly (16, 8, 4, 2, 1), and a hub block's
// eight warp sums in warp order from 0. K9: the warp sums each row of its
// task in turn, group g of its six taking the row's edges g, g + 6, ...;
// per edge, each lane chains its four products, the group adds its five
// in lane order, and each lane folds (w - dot) times its 16 bytes into its
// own sums; the groups are added in group order from 0. A hub row of K9
// (up to 376,611 edges, an item's ratings) is more than one SM can gather
// in time: it takes a cluster of kCluster9 blocks, whose 48 x kCluster9
// groups stride it; each block adds its warps in warp order from 0, and
// the first block adds the blocks' sums from their shared memory in rank
// order from 0 and writes the row. So every sum is taken in an order
// fixed by the row's length and the schedule alone, not by addresses: a
// part of a sharded graph sums its rows exactly as one device does, and
// repeated calls are bitwise equal. (K10 reads col_src in 16-byte quads
// aligned to the address; its combiners do not depend on order, these
// f32 sums do. Lane-strided 4-byte loads are as coalesced: a warp reads
// 128 contiguous bytes.)
//
// The constants are the sweep's (python -m lux_tpu_torch.probes.shapes,
// NVIDIA H100 80GB HBM3 at 700 W): K8 6 resident blocks and evict-first
// index loads, each about 2% faster than 8 blocks and plain loads, on
// tasks of 512 edges (1,024 about 1.5% slower), no cluster (2 blocks a
// hub 3% slower); K9 4 resident blocks (64 registers; 8 spill and take
// up to four times as long), 2 blocks a hub (1 block: 2.56 against 1.84
// ms, the largest item rows run alone; 4 and 8 blocks 5-10% slower, the
// warp tasks' blocks then wait for whole clusters), 6 edges in flight a
// group (4: 3% slower; 8 spills).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "row_pass.cuh"

namespace {

namespace cg = cooperative_groups;
using row_pass::kFull;

constexpr int kCfWidth = 20;      // CF's K (ops/segment.py::CF_WIDTH)
constexpr int kThreads = 256;     // 8 warp tasks, or a share of a hub row
constexpr int kWarps = kThreads / 32;
constexpr int kLaneMax8 = 32;     // K8: edges a row may have to take one lane
constexpr int kMinBlocks8 = 6;    // resident blocks asked of ptxas, K8
constexpr int kMinBlocks9 = 4;    // and K9
constexpr int kCluster8 = 1;      // blocks (one cluster) of a hub row, K8
constexpr int kCluster9 = 2;      // and K9
constexpr int kUnroll9 = 6;       // K9: edges a lane group keeps in flight
// 1: K8 reads col_src evict-first where each load reads whole lines (a
// warp or block striding a row), so the stream leaves the table in L2.
constexpr int kStream8 = 1;

template <int kStream>
__device__ __forceinline__ int ld_stream(const int* p) {
  if constexpr (kStream == 1)
    return __ldcs(p);
  else
    return __ldg(p);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A hub row's sum over the kCluster blocks of its cluster: `part` is this
// block's, in shared memory; block 0 adds the blocks' parts in rank order
// from 0 and returns true with the total in `total` (thread i < n only).
template <int kCluster, class T>
__device__ __forceinline__ bool cluster_total(T* part, int n, T& total) {
  if constexpr (kCluster == 1) {
    __syncthreads();
    if ((int)threadIdx.x < n) total = part[threadIdx.x];
    return true;
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const bool first = cluster.block_rank() == 0;
    if (first && (int)threadIdx.x < n) {
      T t = T{};
      for (int r = 0; r < kCluster; ++r)
        t = add(t, *cluster.map_shared_rank(part + threadIdx.x, r));
      total = t;
    }
    cluster.sync();   // the other blocks' shared memory outlives the reads
    return first;
  }
}

// ---- K8 ----------------------------------------------------------------

// Sum of x[col_src[e]] over e = lo + t, lo + t + kStride, ... < hi, in that
// order, four loaded at a time.
template <int kStride>
__device__ __forceinline__ float gather_sum(const float* __restrict__ x,
                                            const int* __restrict__ cs,
                                            int64_t lo, int64_t hi, int t) {
  // A lane walking its own row reads each line over several loads.
  constexpr int kS = kStride == 1 ? 0 : kStream8;
  float s = 0.f;
  int64_t e = lo + t;
  for (; e + 3 * kStride < hi; e += 4 * kStride) {
    const int s0 = ld_stream<kS>(cs + e);
    const int s1 = ld_stream<kS>(cs + e + kStride);
    const int s2 = ld_stream<kS>(cs + e + 2 * kStride);
    const int s3 = ld_stream<kS>(cs + e + 3 * kStride);
    const float v0 = __ldg(x + s0), v1 = __ldg(x + s1);
    const float v2 = __ldg(x + s2), v3 = __ldg(x + s3);
    s += v0;
    s += v1;
    s += v2;
    s += v3;
  }
  for (; e < hi; e += kStride) s += __ldg(x + ld_stream<kS>(cs + e));
  return s;
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  return s;
}

__global__ void __cluster_dims__(kCluster8, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks8)
gather_rows_kernel(const float* __restrict__ x, const int* __restrict__ cs,
                   const int64_t* __restrict__ rp,
                   const int* __restrict__ tasks, int64_t n_tasks,
                   int64_t n_hub, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t hub = row_pass::hub_row<kCluster8>(tasks, n_hub);
  if (hub >= 0) {
    __shared__ float red[kWarps];
    __shared__ float part;
    const int t = (int)(blockIdx.x % kCluster8) * kThreads + threadIdx.x;
    const float s = warp_sum(
        gather_sum<kThreads * kCluster8>(x, cs, rp[hub], rp[hub + 1], t));
    if (lane == 0) red[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float u = 0.f;
      for (int w = 0; w < kWarps; ++w) u += red[w];
      part = u;
    }
    float total;
    if (cluster_total<kCluster8>(&part, 1, total) && threadIdx.x == 0)
      out[hub] = total;
    return;
  }
  int64_t r0, r1, lo, hi;
  if (!row_pass::warp_task<kWarps, kCluster8>(tasks, n_tasks, n_hub, rp, r0,
                                              r1, lo, hi))
    return;   // the whole warp
  const bool own = hi - lo <= kLaneMax8;
  const unsigned long_rows = __ballot_sync(kFull, !own);
  if (own && r0 + lane < r1) out[r0 + lane] = gather_sum<1>(x, cs, lo, hi, 0);
  row_pass::each_long_row(long_rows, lo, hi,
                          [&](int l, int64_t la, int64_t lb) {
    const float s = warp_sum(gather_sum<32>(x, cs, la, lb, lane));
    if (lane == l) out[r0 + l] = s;
  });
}

// ---- K9 ----------------------------------------------------------------

// A group of kGroup lanes takes one edge, lane j of the group the 16 bytes
// 4j..4j+3 of its 80-byte source row, so one load instruction of a warp
// reads kGroups whole rows (lanes 30 and 31 idle).
constexpr int kGroup = kCfWidth / 4;
constexpr int kGroups = 32 / kGroup;

__device__ __forceinline__ float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(kFull, v.x, src), __shfl_sync(kFull, v.y, src),
                     __shfl_sync(kFull, v.z, src), __shfl_sync(kFull, v.w, src));
}

// Folds one edge into this lane's fifth of the row sum: the
// dot is each lane's four products chained from 0, then the group's five
// partials added in lane order; acc += (w - dot) * src. Every lane of the
// warp takes part in the shuffles; `on` lanes fold.
__device__ __forceinline__ void cf_take(float4& acc, float4 s, int w, bool on,
                                        float4 d, int base) {
  float p = fmaf(s.x, d.x, 0.f);
  p = fmaf(s.y, d.y, p);
  p = fmaf(s.z, d.z, p);
  p = fmaf(s.w, d.w, p);
  float dot = __shfl_sync(kFull, p, base);
#pragma unroll
  for (int j = 1; j < kGroup; ++j) dot += __shfl_sync(kFull, p, base + j);
  const float err = (float)w - dot;
  if (on) {
    acc.x = fmaf(err, s.x, acc.x);
    acc.y = fmaf(err, s.y, acc.y);
    acc.z = fmaf(err, s.z, acc.z);
    acc.w = fmaf(err, s.w, acc.w);
  }
}

// This lane's fifth of the sum over the edges lo + t, lo + t + kStride,
// ... < hi that its group (offset t of kStride groups) takes, in order,
// kUnroll9 loaded before their folds; d is its fifth of the destination
// row.
template <int kStride>
__device__ __forceinline__ float4 cf_edges(const float4* __restrict__ table,
                                           const int* __restrict__ cs,
                                           const int* __restrict__ ws,
                                           int64_t lo, int64_t hi, int t,
                                           bool on, int j, int base,
                                           float4 d) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t e0 = lo + t; e0 - t < hi; e0 += kUnroll9 * kStride) {
    float4 s[kUnroll9];
    int w[kUnroll9];
    bool v[kUnroll9];
#pragma unroll
    for (int u = 0; u < kUnroll9; ++u) {
      const int64_t e = e0 + u * kStride;
      v[u] = on && e < hi;
      s[u] = acc;
      w[u] = 0;
      if (v[u]) {
        s[u] = __ldg(table + (int64_t)__ldg(cs + e) * kGroup + j);
        w[u] = __ldg(ws + e);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll9; ++u) cf_take(acc, s[u], w[u], v[u], d, base);
  }
  return acc;
}

// Lanes j < kGroup: the sum from 0 over the warp's groups, in group order,
// of their lane j's acc (the others get what they get).
__device__ __forceinline__ float4 groups_sum(float4 acc, int j) {
  float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int g = 0; g < kGroups; ++g) u = add(u, shfl4(acc, kGroup * g + j));
  return u;
}

__global__ void __cluster_dims__(kCluster9, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks9)
cf_rows_kernel(const float* __restrict__ vals, const int* __restrict__ cs,
               const int* __restrict__ ws, const int64_t* __restrict__ rp,
               const int* __restrict__ tasks, int64_t n_tasks, int64_t n_hub,
               int64_t row_base, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane / kGroup, j = lane % kGroup;
  const bool on = g < kGroups;
  const int base = kGroup * g;
  const float4* table = reinterpret_cast<const float4*>(vals);
  float4* out4 = reinterpret_cast<float4*>(out);
  const int64_t hub = row_pass::hub_row<kCluster9>(tasks, n_hub);
  if (hub >= 0) {
    __shared__ float4 red[kWarps][kGroup];
    __shared__ float4 part[kGroup];
    const int t =
        ((int)(blockIdx.x % kCluster9) * kWarps + warp) * kGroups + g;
    const float4 d = __ldg(table + (row_base + hub) * kGroup + j);
    const float4 u = groups_sum(
        cf_edges<kWarps * kGroups * kCluster9>(table, cs, ws, rp[hub],
                                               rp[hub + 1], t, on, j, base,
                                               d),
        j);
    if (lane < kGroup) red[warp][lane] = u;
    __syncthreads();
    if (threadIdx.x < kGroup) {
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kWarps; ++w) p = add(p, red[w][threadIdx.x]);
      part[threadIdx.x] = p;
    }
    float4 total;
    if (cluster_total<kCluster9>(part, kGroup, total) && threadIdx.x < kGroup)
      out4[hub * kGroup + threadIdx.x] = total;
    return;
  }
  int64_t r0, r1, lo, hi;
  if (!row_pass::warp_task<kWarps, kCluster9>(tasks, n_tasks, n_hub, rp, r0,
                                              r1, lo, hi))
    return;   // the whole warp
  // The warp sums each row of its task in turn, its groups striding it.
  row_pass::each_long_row(__ballot_sync(kFull, r0 + lane < r1), lo, hi,
                          [&](int l, int64_t la, int64_t lb) {
    const int64_t row = r0 + l;
    const float4 d = __ldg(table + (row_base + row) * kGroup + j);
    const float4 u = groups_sum(
        cf_edges<kGroups>(table, cs, ws, la, lb, g, on, j, base, d), j);
    if (lane < kGroup) out4[row * kGroup + lane] = u;
  });
}

}  // namespace

// vals: (rows,) f32 table the sources index; col_src: (ne,) int32;
// row_ptr: (nrows+1,) int64; tasks: (n_tasks, 2) int32 row ranges, the
// n_hub hub rows first, covering the rows; y: (nrows,) f32, written.
extern "C" int lux_gather_segment_sum(const void* vals, const void* col_src,
                                      const void* row_ptr, const void* tasks,
                                      int64_t n_tasks, int64_t n_hub, void* y,
                                      void* stream) {
  if (n_hub < 0 || n_hub > n_tasks) return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaSuccess;
  gather_rows_kernel<<<(unsigned)row_pass::grid(n_tasks, n_hub, kWarps,
                                                 kCluster8),
                       kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(col_src),
      static_cast<const int64_t*>(row_ptr), static_cast<const int*>(tasks),
      n_tasks, n_hub, static_cast<float*>(y));
  return (int)cudaGetLastError();
}

// K9 at K = kCfWidth: vals (rows, K) f32, 16-byte aligned, holding the
// destinations at row_base onward; weights (ne,) int32; y (nrows, K) f32,
// 16-byte aligned, written. The rest as K8.
extern "C" int lux_cf_edge_sum(const void* vals, const void* col_src,
                               const void* weights, const void* row_ptr,
                               const void* tasks, int64_t n_tasks,
                               int64_t n_hub, int64_t row_base, void* y,
                               void* stream) {
  if (n_hub < 0 || n_hub > n_tasks || row_base < 0)
    return (int)cudaErrorInvalidValue;
  if (n_tasks == 0) return (int)cudaSuccess;
  cf_rows_kernel<<<(unsigned)row_pass::grid(n_tasks, n_hub, kWarps,
                                             kCluster9),
                   kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(vals), static_cast<const int*>(col_src),
          static_cast<const int*>(weights),
          static_cast<const int64_t*>(row_ptr),
          static_cast<const int*>(tasks), n_tasks, n_hub, row_base,
          static_cast<float*>(y));
  return (int)cudaGetLastError();
}
