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
// .at[dst].min/max scatter of _s_update; per receiving part, the same of
// _sparse_comp and _sparse_update, all P parts in one launch. For every
// out-edge e of every queued vertex it combines relax(old[q[i]]) into
// new[col_dst[e]] with atomicMin/atomicMax. Candidates read the pre-step
// values `old`; `new` starts as a copy of them, made in the same launch, so a
// vertex never pushes a value it got in the same step.
//
// Bound on the H100: bytes. K6 reads the nv-byte frontier once (twice where
// a block's span outgrows its shared memory) and writes 28
// bytes per queue slot plus two 8-byte row-pointer reads per slot. K7 copies
// the nv (P * max_nv) words of the values, reads 4 bytes of col_dst and does
// one 4-byte atomic per live edge, plus 20 bytes and one value per queue slot
// and receiver. At the main path's frontiers K6's bound is a microsecond or
// less, so its time is launch latency: it is one launch.
//
// K6 design: one cooperative launch of persistent blocks, as many as can be
// resident at once (cudaLaunchCooperativeKernel guarantees it, or refuses).
// Block b owns a contiguous span of the frontier, 32 flags to a word, and
// warp w of the block a contiguous run of the span's words. Each warp walks
// its run a window of kWindow words (32,768 flags) at a time, in shared
// memory of a fixed size, so the grid does not depend on nv and any frontier
// with int32 ids fits. The count pass reads each window (16-byte loads where
// aligned) and adds up the warp's vertices and their out-degrees; each block
// publishes its totals. Then one grid barrier: an arrival counter that the
// last block resets and a generation word the others wait on, so the scratch
// needs no zeroing between calls. Each block then adds the totals of the
// blocks before it (one parallel read of a few hundred words), and each warp
// places its vertices in order, ids ascending as jnp.nonzero gives them: it
// walks its run a word at a time, lane j taking flag j, so a lane's slot is
// a popcount and its degree prefix a warp scan, and the writes of a dense
// word are coalesced. The place pass keeps the count pass's window where one
// window holds the warp's whole run, that is up to 262,144 flags a block
// (every frontier of the main path), so the frontier is read once; a longer
// run re-reads its windows from the frontier. The last block writes
// the total into offs[cnt]. The grid is computed once per device, from the
// kernel's occupancy at its fixed shared memory; the cache is lock-free.
// Two designs measured worse on the H100: a decoupled look-back over 1,024
// tiles of 4,096 flags spent its time walking back through tiles that had
// all published at once (slower than torch.nonzero with 145 K of 4.2 M
// vertices queued), and a thread placing its own 32 flags one by one was
// several times slower than this on a half-full frontier. An earlier form
// kept a block's whole span in shared memory, so it refused frontiers above
// about 2.4e8 vertices, where the span outgrew the 227 KB a block may have.
// K7 is the queue expansion queue_fold_kernel (gas_ops.cuh), which K11
// launches too: one cooperative launch that copies the values, waits at a
// grid barrier on K6's scratch and folds the edges, balanced on edge slots
// (a hub's out-edges spread over many blocks) over a stage of the queue in
// shared memory. Integer min/max atomics commute, so the result is bitwise
// that of the plain version whatever the order.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gas_ops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 1024;   // frontier words a warp holds: 32 KB a block

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// 32 frontier flags from f[base..), bit k for flag base + k (flags past n
// read as unset).
__device__ __forceinline__ unsigned load_word(const unsigned char* f,
                                              int64_t base, int64_t n) {
  if (base + 32 <= n && (reinterpret_cast<uintptr_t>(f + base) & 15) == 0) {
    const uint4 a = __ldcs(reinterpret_cast<const uint4*>(f + base));
    const uint4 b = __ldcs(reinterpret_cast<const uint4*>(f + base) + 1);
    const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if ((w[k] >> (8 * j)) & 0xFFu) m |= 1u << (4 * k + j);
    return m;
  }
  unsigned m = 0;
  for (int k = 0; k < 32; ++k)
    if (base + k < n && f[base + k] != 0) m |= 1u << k;
  return m;
}

// Block-wide sum of (a, b); every thread gets the totals. `sh` holds
// 2 * kWarps values.
__device__ __forceinline__ void block_sum2(int64_t* a, int64_t* b,
                                           int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t sa = *a, sb = *b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  __syncthreads();
  if (lane == 0) {
    sh[warp] = sa;
    sh[kWarps + warp] = sb;
  }
  __syncthreads();
  sa = sb = 0;
  for (int w = 0; w < kWarps; ++w) {
    sa += sh[w];
    sb += sh[kWarps + w];
  }
  *a = sa;
  *b = sb;
}

// The scratch of K6, in int64 words: [0] arrivals at the grid barrier, [1]
// its generation, then the per-block count and degree totals.
struct Scratch {
  luxk::Barrier bar;
  long long* tot_c;
  long long* tot_d;
};

// Loads words [b, e) of the frontier (32 flags each, word k of the block's
// span at (w0 + k) * 32) into this warp's window, one word a lane.
__device__ __forceinline__ void load_window(unsigned* win,
                                            const unsigned char* frontier,
                                            int64_t nv, int64_t w0, int64_t b,
                                            int64_t e, int lane) {
  for (int64_t k = b + lane; k < e; k += 32)
    win[k - b] = load_word(frontier, (w0 + k) * 32, nv);
  __syncwarp();
}

// One cooperative launch: the frontier's ascending ids with their CSR
// start, degree and exclusive degree prefix, and offs[cnt] = the total.
// Block b owns the words [b * span, (b + 1) * span) of the frontier (32
// flags each); warp w of the block owns a contiguous run of those words and
// walks it a window of kWindow words at a time, then a word at a time, lane
// j taking flag j. Writes stop at `cap` slots.
__global__ void __launch_bounds__(kThreads)
frontier_queue_kernel(const unsigned char* __restrict__ frontier, int64_t nv,
                      const int64_t* __restrict__ rp, int64_t span,
                      Scratch sc, int64_t cap, int* __restrict__ q,
                      int64_t* __restrict__ start, int64_t* __restrict__ deg,
                      int64_t* __restrict__ offs) {
  __shared__ unsigned masks[kWarps][kWindow];
  __shared__ int64_t sh[2 * kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t words = (nv + 31) / 32;
  const int64_t w0 = min64((int64_t)blockIdx.x * span, words);
  const int64_t nw = min64(span, words - w0);
  const int64_t per = (nw + kWarps - 1) / kWarps;
  const int64_t k0 = min64(warp * per, nw), k1 = min64(k0 + per, nw);
  unsigned* win = masks[warp];
  // Count this warp's vertices (c, the same in every lane) and out-degrees
  // (d, summed over the lanes), a window at a time.
  int64_t c = 0, d = 0;
  for (int64_t b = k0; b < k1; b += kWindow) {
    const int64_t e = min64(b + kWindow, k1);
    load_window(win, frontier, nv, w0, b, e, lane);
    for (int64_t k = b; k < e; ++k) {
      const unsigned m = win[k - b];
      if (m == 0) continue;
      c += __popc(m);
      if ((m >> lane) & 1u) {
        const int64_t v = (w0 + k) * 32 + lane;
        d += rp[v + 1] - rp[v];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) {
    sh[warp] = c;
    sh[kWarps + warp] = d;
  }
  __syncthreads();
  // The block's totals, and this warp's prefix inside the block.
  int64_t bc = 0, bd = 0, xc = 0, xd = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) {
      xc = bc;
      xd = bd;
    }
    bc += sh[w];
    bd += sh[kWarps + w];
  }
  if (threadIdx.x == 0) {
    __stcg(sc.tot_c + blockIdx.x, (long long)bc);
    __stcg(sc.tot_d + blockIdx.x, (long long)bd);
  }
  luxk::grid_barrier(sc.bar);
  // The totals of the blocks before this one.
  int64_t pc = 0, pd = 0;
  for (int64_t j = threadIdx.x; j < blockIdx.x; j += kThreads) {
    pc += __ldcg(sc.tot_c + j);
    pd += __ldcg(sc.tot_d + j);
  }
  block_sum2(&pc, &pd, sh);
  // Place, a word at a time: lane j's slot is the count of set flags below
  // it, its degree prefix a warp scan, so the writes are coalesced. A run
  // of one window still has it; a longer run reads its windows again.
  const bool kept = k1 - k0 <= kWindow;
  int64_t slot = pc + xc, off = pd + xd;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t b = k0; b < k1; b += kWindow) {
    const int64_t e = min64(b + kWindow, k1);
    if (!kept) load_window(win, frontier, nv, w0, b, e, lane);
    for (int64_t k = b; k < e; ++k) {
      const unsigned m = win[k - b];
      if (m == 0) continue;
      const bool set = (m >> lane) & 1u;
      const int64_t v = (w0 + k) * 32 + lane;
      int64_t s = 0, dv = 0;
      if (set) {
        s = rp[v];
        dv = rp[v + 1] - s;
      }
      int64_t inc = dv;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const int64_t my = slot + __popc(m & below);
      if (set && my < cap) {
        q[my] = (int)v;
        start[my] = s;
        deg[my] = dv;
        offs[my] = off + inc - dv;
      }
      slot += __popc(m);
      off += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (!kept) __syncwarp();
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0 && pc + bc <= cap)
    offs[pc + bc] = pd + bd;
}

// Resident blocks of frontier_queue_kernel on each device, 0 until asked.
std::atomic<int> g_resident[luxk::kMaxDevices];

using luxk::Add1;
using luxk::Copy;
using MinOp = luxk::MinU32;
using MaxOp = luxk::MaxU32;

}  // namespace

// frontier: (nv,) bool; rp: (nv+1,) int64 CSR row pointer. scratch: 2 +
// 2 * scratch_blocks int64 words, zeroed when allocated; one call at a time
// on it. Outputs, `cap` slots each: q int32, start and deg int64; offs int64
// with cap + 1 slots.
extern "C" int lux_frontier_queue(const void* frontier, int64_t nv,
                                  const void* rp, void* scratch,
                                  int64_t scratch_blocks, int64_t cap,
                                  void* q, void* start, void* deg, void* offs,
                                  void* stream) {
  if (nv <= 0) return (int)cudaSuccess;
  if (nv > INT32_MAX) return (int)cudaErrorInvalidValue;  // int32 ids
  int resident = 0;
  const cudaError_t e = luxk::resident_blocks(frontier_queue_kernel, kThreads,
                                              g_resident, &resident);
  if (e != cudaSuccess) return (int)e;
  // Blocks: one per 256 words, at most as many as are resident at once.
  const int64_t words = (nv + 31) / 32;
  const int64_t grid = min64(min64((words + kThreads - 1) / kThreads,
                                   (int64_t)resident), scratch_blocks);
  int64_t span = (words + grid - 1) / grid;
  long long* w = static_cast<long long*>(scratch);
  Scratch sc{{reinterpret_cast<unsigned long long*>(w),
              reinterpret_cast<unsigned long long*>(w + 1)},
             w + 2, w + 2 + scratch_blocks};
  const unsigned char* f = static_cast<const unsigned char*>(frontier);
  const int64_t* r = static_cast<const int64_t*>(rp);
  int* qp = static_cast<int*>(q);
  int64_t* sp = static_cast<int64_t*>(start);
  int64_t* dp = static_cast<int64_t*>(deg);
  int64_t* op = static_cast<int64_t*>(offs);
  void* args[] = {&f, &nv, &r, &span, &sc, &cap, &qp, &sp, &dp, &op};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(frontier_queue_kernel), dim3((unsigned)grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
}

// q: (cnt,) queue of rows of `old`, cnt >= 1; per receiver p < parts (1 to
// kQueueMaxParts, more is refused): start (parts, cnt) and offs (parts,
// cnt + 1) its CSR ranges at the queue and their exclusive prefix
// (offs[p][cnt] its edge total), col_dst (parts, dst_stride) its CSR
// destinations, rows of its own row of out. old: (parts * n,) uint32
// pre-step values; out: (parts * n,) written, a copy of old with receiver
// p's candidates combined into words [p * n, (p + 1) * n). total: the
// receivers' edges together (sizes the grid only). scratch: K6's, whose
// first two words are the grid barrier's. comb: 0 min, 1 max. relax: 0
// add1, 1 copy.
extern "C" int lux_queue_relax_scatter(const void* q, const void* start,
                                       const void* offs, int64_t cnt,
                                       int parts, const void* col_dst,
                                       int64_t dst_stride, const void* old,
                                       void* out, int64_t n, int64_t total,
                                       void* scratch, int comb, int relax,
                                       void* stream) {
  if (comb < 0 || comb > 1 || relax < 0 || relax > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Receivers r{static_cast<const int64_t*>(start),
                    static_cast<const int64_t*>(offs),
                    static_cast<const int*>(col_dst), nullptr, cnt,
                    dst_stride, n, parts};
#define LUX_K7(C, G) \
  queue_fold<C, G, kInitCopy>(q, r, old, out, parts * n, total, scratch, st)
  if (comb == 0)
    return (int)(relax == 0 ? LUX_K7(MinOp, Add1) : LUX_K7(MinOp, Copy));
  return (int)(relax == 0 ? LUX_K7(MaxOp, Add1) : LUX_K7(MaxOp, Copy));
#undef LUX_K7
}
