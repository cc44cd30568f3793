// K6 frontier_queue and K7 queue_relax_scatter: the push engine's sparse
// (push-direction) iteration.
//
// K6 replaces the queue build of lux_tpu/engine/push.py::_s_load
// (jnp.nonzero(frontier, size=Q, fill_value=nv), then the CSR range gathers
// rp[q] and rp[q + 1] - rp[q]). It compacts the bool frontier into the
// ascending ids q[0..cnt) with, per queue slot, start = rp[q], deg =
// rp[q + 1] - rp[q] and the exclusive degree prefix offs[0..cnt] (offs[cnt]
// = the frontier's out-edge total).
// K7 replaces _queue_edge_slots (static-shape expansion of the queued CSR
// ranges into E edge slots by a marks cumsum), _s_comp (relax) and the
// .at[dst].min/max scatter of _s_update. For every live edge slot s < total
// it finds the queue slot i that owns it (offs[i] <= s < offs[i + 1]) and
// combines relax(old[q[i]]) into new[col_dst[start[i] + s - offs[i]]] with
// atomicMin/atomicMax. Candidates read the pre-step values `old`; `new` is a
// copy of them, so a vertex never pushes a value it got in the same step.
//
// Bound on the H100: bytes. K6 reads the nv-byte frontier (twice, once to
// count and once to place) and writes 28 bytes per queue slot plus two
// 16-byte row-pointer reads per slot. K7 reads 4 bytes of col_dst and does
// one 4-byte atomic per live edge, plus 24 bytes and one value per queue
// slot; the binary searches hit the offs table in L1/L2.
//
// Design. The compaction is a hand-written scan: one block per tile of kTile
// flags counts the tile's frontier vertices and their out-edges; one block
// scans the per-tile counts; the tiles then place their vertices in order,
// each thread owning kPer consecutive flags, so the ids come out ascending as
// jnp.nonzero gives them. The expansion is load-balanced on the edge slots,
// not the vertices: every block takes kQueueSlots consecutive slots, finds
// the queue range that covers them once, and each thread binary-searches its
// slot's owner inside that range (merge-path style), so an R-MAT hub's
// out-edges spread over many blocks; the kernel is queue_fold_kernel
// (gas_ops.cuh), which K11 launches too. Integer min/max atomics commute, so
// the result is bitwise that of the plain version whatever the order.

#include <cstdint>
#include <cuda_runtime.h>

#include "gas_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                  // frontier flags per thread
constexpr int kTile = kThreads * kPer;    // flags per tile (block)
constexpr int kScanThreads = 1024;

// Bit k set iff flag base + k is set (flags past n read as unset).
__device__ __forceinline__ unsigned load_flags(const unsigned char* f,
                                               int64_t base, int64_t n) {
  unsigned m = 0;
  if (base + kPer <= n &&
      (reinterpret_cast<uintptr_t>(f + base) & 15) == 0) {
    const uint4 w = *reinterpret_cast<const uint4*>(f + base);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((words[k] >> (8 * b)) & 0xFFu) m |= 1u << (4 * k + b);
  } else {
    for (int k = 0; k < kPer; ++k)
      if (base + k < n && f[base + k] != 0) m |= 1u << k;
  }
  return m;
}

// Sum of the out-degrees of the flagged vertices base + k.
__device__ __forceinline__ int64_t degree_sum(unsigned m, int64_t base,
                                              const int64_t* rp) {
  int64_t d = 0;
  while (m) {
    const int k = __ffs(m) - 1;
    m &= m - 1;
    d += rp[base + k + 1] - rp[base + k];
  }
  return d;
}

// Exclusive block-wide scan of (a, b) over kThreads threads; returns the
// thread's exclusive prefixes. `sh` holds 2 * (kThreads / 32) values.
__device__ __forceinline__ void block_scan2(int64_t a, int64_t b,
                                            int64_t* ea, int64_t* eb,
                                            int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  int64_t sa = a, sb = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t ya = __shfl_up_sync(0xffffffffu, sa, off);
    const int64_t yb = __shfl_up_sync(0xffffffffu, sb, off);
    if (lane >= off) {
      sa += ya;
      sb += yb;
    }
  }
  if (lane == 31) {
    sh[warp] = sa;
    sh[kWarps + warp] = sb;
  }
  __syncthreads();
  int64_t wa = 0, wb = 0;
  for (int w = 0; w < warp; ++w) {
    wa += sh[w];
    wb += sh[kWarps + w];
  }
  *ea = wa + sa - a;
  *eb = wb + sb - b;
}

// Per tile: the number of frontier vertices and the sum of their degrees.
__global__ void __launch_bounds__(kThreads)
count_tiles_kernel(const unsigned char* __restrict__ frontier, int64_t nv,
                   const int64_t* __restrict__ rp,
                   int64_t* __restrict__ tile_cnt,
                   int64_t* __restrict__ tile_deg) {
  __shared__ int64_t sh[2 * (kThreads / 32)];
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kPer;
  const unsigned m = load_flags(frontier, base, nv);
  const int64_t c = __popc(m), d = degree_sum(m, base, rp);
  int64_t ea, eb;
  block_scan2(c, d, &ea, &eb, sh);
  if (threadIdx.x == kThreads - 1) {
    tile_cnt[blockIdx.x] = ea + c;
    tile_deg[blockIdx.x] = eb + d;
  }
}

// In place: data[0..n) becomes its exclusive prefix and data[n] the total.
// One block; it walks the array in chunks of kScanThreads with a carry.
__global__ void __launch_bounds__(kScanThreads)
scan_small_kernel(int64_t* __restrict__ data, int64_t n) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < n; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int64_t x = i < n ? data[i] : 0;
    int64_t s = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane == 31) warp_sums[warp] = s;
    __syncthreads();
    if (warp == 0) {
      int64_t w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int64_t incl = carry + s + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (i < n) data[i] = incl - x;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) data[n] = carry;
}

// Per tile: place the tile's frontier ids in ascending order, with their
// CSR start, degree and exclusive degree prefix. Writes stop at `cap` slots.
__global__ void __launch_bounds__(kThreads)
place_tiles_kernel(const unsigned char* __restrict__ frontier, int64_t nv,
                   const int64_t* __restrict__ rp,
                   const int64_t* __restrict__ tile_cnt,
                   const int64_t* __restrict__ tile_deg, int64_t ntiles,
                   int64_t cap, int* __restrict__ q,
                   int64_t* __restrict__ start, int64_t* __restrict__ deg,
                   int64_t* __restrict__ offs) {
  __shared__ int64_t sh[2 * (kThreads / 32)];
  const int64_t base = (int64_t)blockIdx.x * kTile + threadIdx.x * kPer;
  unsigned m = load_flags(frontier, base, nv);
  int64_t slot, off;
  block_scan2(__popc(m), degree_sum(m, base, rp), &slot, &off, sh);
  slot += tile_cnt[blockIdx.x];
  off += tile_deg[blockIdx.x];
  while (m) {
    const int k = __ffs(m) - 1;
    m &= m - 1;
    const int64_t v = base + k;
    const int64_t s = rp[v], d = rp[v + 1] - s;
    if (slot < cap) {
      q[slot] = (int)v;
      start[slot] = s;
      deg[slot] = d;
      offs[slot] = off;
    }
    ++slot;
    off += d;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && tile_cnt[ntiles] <= cap)
    offs[tile_cnt[ntiles]] = tile_deg[ntiles];
}

using luxk::Add1;
using luxk::Copy;
using MinOp = luxk::MinU32;
using MaxOp = luxk::MaxU32;

}  // namespace

// frontier: (nv,) bool; rp: (nv+1,) int64 CSR row pointer. scratch: 2 *
// (ntiles + 1) int64 with ntiles = ceil(nv / kTile). Outputs, `cap` slots
// each: q int32, start and deg int64; offs int64 with cap + 1 slots.
extern "C" int lux_frontier_queue(const void* frontier, int64_t nv,
                                  const void* rp, void* scratch, int64_t cap,
                                  void* q, void* start, void* deg,
                                  void* offs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t ntiles = (nv + kTile - 1) / kTile;
  int64_t* tile_cnt = static_cast<int64_t*>(scratch);
  int64_t* tile_deg = tile_cnt + ntiles + 1;
  const unsigned char* f = static_cast<const unsigned char*>(frontier);
  const int64_t* r = static_cast<const int64_t*>(rp);
  count_tiles_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(f, nv, r,
                                                            tile_cnt, tile_deg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_small_kernel<<<1, kScanThreads, 0, st>>>(tile_cnt, ntiles);
  scan_small_kernel<<<1, kScanThreads, 0, st>>>(tile_deg, ntiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  place_tiles_kernel<<<(unsigned)ntiles, kThreads, 0, st>>>(
      f, nv, r, tile_cnt, tile_deg, ntiles, cap, static_cast<int*>(q),
      static_cast<int64_t*>(start), static_cast<int64_t*>(deg),
      static_cast<int64_t*>(offs));
  return (int)cudaGetLastError();
}

// q, start: (cnt,) queue; offs: (cnt+1,) exclusive degree prefix with
// offs[cnt] == total > 0; col_dst: CSR destinations; old: (nv,) uint32
// pre-step values; out: (nv,) a copy of old, combined into in place.
// comb: 0 min, 1 max. relax: 0 add1, 1 copy.
extern "C" int lux_queue_relax_scatter(const void* q, const void* start,
                                       const void* offs, int64_t cnt,
                                       int64_t total, const void* col_dst,
                                       const void* old, void* out, int comb,
                                       int relax, void* stream) {
  if (comb < 0 || comb > 1 || relax < 0 || relax > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (comb == 0 && relax == 0)
    return (int)queue_fold<MinOp, Add1>(q, start, offs, cnt, total, col_dst,
                                        nullptr, old, out, st);
  if (comb == 0)
    return (int)queue_fold<MinOp, Copy>(q, start, offs, cnt, total, col_dst,
                                        nullptr, old, out, st);
  if (relax == 0)
    return (int)queue_fold<MaxOp, Add1>(q, start, offs, cnt, total, col_dst,
                                        nullptr, old, out, st);
  return (int)queue_fold<MaxOp, Copy>(q, start, offs, cnt, total, col_dst,
                                      nullptr, old, out, st);
}
