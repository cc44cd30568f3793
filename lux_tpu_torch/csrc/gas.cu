// K10 gas_pull_acc and K11 gas_push_acc: the GAS engine's accumulator, built
// from either direction; and K5 segment_minmax_relax, the push engine's
// dense (pull-direction) step, on K10's row pass.
//
// K10 replaces lux_tpu/engine/gas.py::AdaptiveExecutor._pull_acc (and
// MultiSourceGasExecutor._one_iter's reduce) over
// lux_tpu/ops/segment.py::segment_reduce (jnp: gather val[col_src] and
// frontier[col_src], gather(), a where() to the combiner identity, then
// segment_min/max/sum, including DeltaSSSP's float min). For every
// CSC destination v and column c < k it computes
//   acc[v, c] = comb over e in [row_ptr[v], row_ptr[v+1]) of
//               (front[src_e, c] ? gather(val[src_e, c], w_e) : ident)
// K11 replaces AdaptiveExecutor._push_acc with
// lux_tpu/engine/push.py::_queue_edge_slots (jnp: the bounded queue's CSR
// ranges laid into static edge slots by a marks cumsum, gather(), and
// .at[dst].min/max/add into an identity-filled (nv,) array). Over the queue
// of K6 (frontier.cu) it folds gather(val[q[i]], csr_w[e]) into acc[col_dst[e]]
// for every out-edge e of every queued vertex. Both directions fold the same
// message multiset with an order-free combine, so their results are equal
// bit for bit.
//
// K5 replaces lux_tpu/engine/push.py::_blocked_candidates (jnp/lax: per edge
// a 128-lane row gather from the packed value | frontier << 31 table, a
// one-hot lane select, unpack, relax, identity mask) together with
// lux_tpu/ops/segment.py::segment_minmax_blockmin (a 128-block reduce, a
// block-level segmented min/max scan, masked head/tail row gathers), the
// plain dense _d_load/_d_comp over segment_reduce, and per part push.py's
// _dense_comp. It is K10's function with one column, a uint32 min or max and
// the relax add1 or copy (all four pairs), read from either the packed
// table (blocked_dense) or values and a bool frontier.
//
// The (combiner, value type, gather op) triples of K10 and K11 are those of
// the registered programs: (min, u32, add1) BFS and SSSP, (max, u32, copy)
// CC, (min, f32, add_w) DeltaSSSP, (max, u32, decay) label propagation,
// (sum, u32, one) k-core; op codes 0-4 in that order
// (ops/segment.py::GAS_KERNEL_OPS).
//
// Bound on the H100: bytes. K10 reads per edge 4 bytes of col_src and, per
// active edge, a random value (4 bytes a column) and for add_w a 4-byte
// weight; it reads the row pointer and the (n_tab, k) frontier once (to pack
// it) and writes the (nv, k) accumulator once. But every edge also tests
// its source's frontier bit, one random read of a 32-byte L2 sector, and
// every active edge gathers a sector of values: those reads, served by the
// 50 MB L2, are what the kernel waits on. K5 on the packed table reads per
// edge 4 bytes of col_src and one random 4-byte word of an nv-word table
// (16.8 MB at R-MAT 22, so it stays in L2), which costs a whole 32-byte
// sector: its two calls of chip_smoke.py (SSSP after 2 iterations, 67.1 M
// edges; CC's first iteration on the closure, 134.2 M) read 6.44 GB of
// sectors, the floor left once col_src streams. On values and a bool
// frontier it reads the bits as K10 does, then a sector of values per
// active edge only. K11 reads 24 bytes per queue slot, per out-edge 4 bytes
// of col_dst (and a weight) and does one 4-byte atomic; it writes the nv
// words of the accumulator (and, for f32, reads and writes them again).
//
// Design of the pull (K10 and K5). One pass over a row schedule built once
// per graph (ops/segment.py::row_tasks; the pass over it is row_pass.cuh,
// shared with K8 and K9). A warp task is up to 32 consecutive rows, one a
// lane, whose edges are at most 2 * TASK_EDGES: a lane sums a row of up
// to kLaneMax edges itself, its source indices loaded four at a
// time before their tests and gathers; the warp sums each longer row of
// its task, the lanes striding its 16-byte quads of col_src (any head and
// tail that do not fill an aligned quad are read singly), two quads loaded
// before their eight tests. A hub row (more than HUB_EDGES edges) is a
// block's task, summed by the 256 threads the same way. Each row is written
// once, by the lane that owns it or by thread 0 of its block: the identity
// where no source was active, so no fill launch and no atomics. Sums are
// taken in registers, then by shuffles and (hub rows) shared memory; min,
// max and wrapping uint32 sums do not depend on order, and f32 min folds the
// order-preserving keys of gas_ops.cuh and decodes them in the same store,
// so the results are bitwise those of the plain version. What a source
// contributes is read by the pull's fetch policy: Bits (K10, and K5 on
// values and a bool frontier) packs the frontier into bits in a first
// launch of the same call (k = 1: 32 vertices a word, 0.5 MB at R-MAT 22
// against 4.2 MB of bools, so many more of the sources' tests hit in L1;
// k > 1: a byte per vertex and chunk of 8 columns), tests a source's bit
// and loads its value only when it is set; Packed (K5 on blocked_dense's
// table) loads one word and tests its bit 31, one random sector an edge
// and no pack. Columns run kChunk at a time (k = 1 runs one column; any
// k > 1 runs ceil(k / 8) chunks of 8, each walking the rows again). Hub
// rows take the first blocks, so they start first. K10's thresholds and
// occupancy are measured (python -m lux_tpu_torch.probes.shapes, R-MAT
// 22): kLaneMax 32 (16 up to 9% slower), TASK_EDGES 1,024 (512 within 2%,
// 2,048 up to 6% slower), HUB_EDGES 4,096 (8,192 up to 4% slower) and 8
// resident blocks for one column, 6 for K (no bound: up to twice as slow).
// The bit tests are one random read an edge whatever the density: at
// density 0.01 they take most of the time. K5 keeps its own kLaneMax5,
// kMinBlocks5 and schedule thresholds (ops/segment.py::PUSH_TASK_EDGES),
// the --only k5 sweep's on SSSP's, CC's and a sharded part's dense states:
// 6 resident blocks (40 registers, no spill) up to 3% faster than 8 on the
// packed table; lane rows up to 32 edges; tasks of 256 edges 1-6% faster
// than K10's 1,024.
// K11 is K7's kernel (queue_fold_kernel, gas_ops.cuh) with the GAS gather
// ops, in one cooperative launch: it fills the accumulator with the
// identity (its key for f32 min), waits at a grid barrier, folds the edges
// over a stage of the queue in shared memory and, for f32 min, decodes the
// keys after a second barrier. It takes one receiver (the single-device
// engine) or, as K7 does, the P receiving parts of a sharded graph in the
// same launch: lux_tpu/engine/gas_sharded.py::_push_comp runs once per
// shard over the all-gathered queue, each into its own (max_nv,)
// accumulator; here receiver p folds through its own push CSR into row p of
// one (P, max_nv) accumulator, and the fill and the decode cover all rows.

#include <cstdint>
#include <cuda_runtime.h>

#include "gas_ops.cuh"
#include "row_pass.cuh"

namespace {

using namespace luxk;

constexpr int kThreads = 256;   // the pull: 8 warp tasks, or one hub row
constexpr int kMinBlocks = 8;   // K10's resident blocks asked of ptxas,
constexpr int kMinBlocksK = 6;  // with one column and with K
constexpr int kWarps = kThreads / 32;
constexpr int kLaneMax = 32;    // edges a row may have to take one lane
constexpr int kMinBlocks5 = 6;  // K5's, in both forms
constexpr int kLaneMax5 = 32;

// What the pull folds: the message itself, or the order-preserving key of an
// f32 message; `out` is what the accumulator word stores.
template <class C>
struct Fold {
  using T = typename C::T;
  __device__ __forceinline__ static unsigned ident() {
    if constexpr (C::kKeyed)
      return f32_key(C::ident());
    else
      return C::ident();
  }
  __device__ __forceinline__ static unsigned key(T v) {
    if constexpr (C::kKeyed)
      return f32_key(v);
    else
      return v;
  }
  __device__ __forceinline__ static unsigned comb(unsigned a, unsigned b) {
    if constexpr (C::kKeyed)
      return a < b ? a : b;
    else
      return C::apply(a, b);
  }
  __device__ __forceinline__ static unsigned out(unsigned a) {
    if constexpr (C::kKeyed)
      return f32_unkey(a);
    else
      return a;
  }
};

// 32 frontier flags from f[base..), bit j for flag base + j (flags past n
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

// The frontier's bits (ops/segment.py::frontier_bits_plain): k = 1, word i
// holds vertices 32 i .. 32 i + 31; k > 1, byte v * nch + c holds columns
// 8 c .. 8 c + 7 of vertex v.
__global__ void __launch_bounds__(kThreads)
pack_bits_kernel(const unsigned char* __restrict__ front, int64_t n, int k,
                 unsigned* __restrict__ bits) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (k == 1) {
    if (i < (n + 31) / 32) bits[i] = load_word(front, 32 * i, n);
    return;
  }
  const int nch = (k + 7) / 8;
  if (i >= n * nch) return;
  const int64_t v = i / nch;
  const int c0 = 8 * (int)(i - v * nch);
  const unsigned char* f = front + v * k + c0;
  const int nc = k - c0 < 8 ? k - c0 : 8;
  unsigned m = 0;
  for (int j = 0; j < nc; ++j)
    if (f[j]) m |= 1u << j;
  reinterpret_cast<unsigned char*>(bits)[i] = (unsigned char)m;
}

cudaError_t pack_bits(const void* front, int64_t n, int k, void* bits,
                      cudaStream_t st) {
  const int64_t m = k == 1 ? (n + 31) / 32 : n * ((k + 7) / 8);
  if (m == 0) return cudaSuccess;
  pack_bits_kernel<<<(unsigned)((m + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>(static_cast<const unsigned char*>(front), n, k,
                           static_cast<unsigned*>(bits));
  return cudaGetLastError();
}

// The fetch policies of the pull: for source s in column chunk c, f(j, v)
// for each column j < kChunk in which s is active, with its value v.
//
// Bits: the frontier's bits (frontier_bits_plain's layout), then a value
// load for an active column only.
template <class T, int kChunk>
struct Bits {
  const T* val;
  const unsigned* bits;
  int k, nch;

  template <class F>
  __device__ __forceinline__ void operator()(int s, int c, F&& f) const {
    if constexpr (kChunk == 1) {
      if ((__ldg(bits + (s >> 5)) >> (s & 31)) & 1u) f(0, __ldg(val + s));
    } else {
      const unsigned m = __ldg(reinterpret_cast<const unsigned char*>(bits) +
                               (int64_t)s * nch + c);
      if (m == 0) return;
      const T* vs = val + (int64_t)s * k + 8 * c;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if ((m >> j) & 1u) f(j, __ldg(vs + j));
    }
  }
};

// Packed: one word a vertex, the value in bits 0-30 and the frontier in
// bit 31 (one column).
struct Packed {
  const unsigned* word;

  template <class F>
  __device__ __forceinline__ void operator()(int s, int, F&& f) const {
    const unsigned w = __ldg(word + s);
    if (w >> 31) f(0, w & 0x7FFFFFFFu);
  }
};

// The operands of one pull, for columns [8 c, 8 c + kChunk) of chunk c.
template <class C, class G, int kChunk, class Src>
struct Pull {
  using F = Fold<C>;
  Src src;
  const int* col_src;
  const int* weights;
  int c;

  // Folds edge e (source s) into a[].
  __device__ __forceinline__ void take(unsigned (&a)[kChunk], int64_t e,
                                       int s) const {
    const int w = G::kWeighted ? __ldg(weights + e) : 0;
    src(s, c, [&](int j, typename C::T v) {
      a[j] = F::comb(a[j], F::key(G::apply(v, w)));
    });
  }

  // A row's fold by one thread: edges in order, four loaded at a time.
  __device__ __forceinline__ void lane_row(unsigned (&a)[kChunk], int64_t lo,
                                           int64_t hi) const {
    int64_t e = lo;
    for (; e + 4 <= hi; e += 4) {
      const int s0 = __ldg(col_src + e), s1 = __ldg(col_src + e + 1);
      const int s2 = __ldg(col_src + e + 2), s3 = __ldg(col_src + e + 3);
      take(a, e, s0);
      take(a, e + 1, s1);
      take(a, e + 2, s2);
      take(a, e + 3, s3);
    }
    for (; e < hi; ++e) take(a, e, __ldg(col_src + e));
  }

  // Thread t's share of row [lo, hi) when kStride threads share it: the
  // aligned quads of col_src inside the row, strided, two loaded before
  // their tests; the head and tail edges outside whole quads, one a thread.
  template <int kStride>
  __device__ __forceinline__ void strided_row(unsigned (&a)[kChunk],
                                              int64_t lo, int64_t hi,
                                              int t) const {
    const int mis = (int)((reinterpret_cast<uintptr_t>(col_src) >> 2) & 3);
    const int4* q4 = reinterpret_cast<const int4*>(col_src - mis);
    const int64_t qlo = (lo + mis + 3) >> 2, qhi = (hi + mis) >> 2;
    int64_t head = hi, tail = hi;   // edges [lo, head) and [tail, hi)
    if (qlo < qhi) {
      head = 4 * qlo - mis;
      tail = 4 * qhi - mis;
    }
    if (lo + t < head) take(a, lo + t, __ldg(col_src + lo + t));
    if (tail + t < hi && qlo < qhi) take(a, tail + t, __ldg(col_src + tail + t));
    // With no whole quad, head == hi covers the row: strided singles.
    if (qlo >= qhi)
      for (int64_t e = lo + t + kStride; e < hi; e += kStride)
        take(a, e, __ldg(col_src + e));
    int64_t q = qlo + t;
    for (; q + kStride < qhi; q += 2 * kStride) {
      const int4 va = __ldcs(q4 + q), vb = __ldcs(q4 + q + kStride);
      const int64_t ea = 4 * q - mis, eb = 4 * (q + kStride) - mis;
      take(a, ea, va.x);
      take(a, ea + 1, va.y);
      take(a, ea + 2, va.z);
      take(a, ea + 3, va.w);
      take(a, eb, vb.x);
      take(a, eb + 1, vb.y);
      take(a, eb + 2, vb.z);
      take(a, eb + 3, vb.w);
    }
    if (q < qhi) {
      const int4 va = __ldcs(q4 + q);
      const int64_t ea = 4 * q - mis;
      take(a, ea, va.x);
      take(a, ea + 1, va.y);
      take(a, ea + 2, va.z);
      take(a, ea + 3, va.w);
    }
  }
};

template <class C, int kChunk>
__device__ __forceinline__ void warp_fold(unsigned (&a)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a[j] = Fold<C>::comb(a[j], __shfl_xor_sync(0xffffffffu, a[j], off));
}

// The pull of K10 and K5: block b < n_hub sums hub row tasks[b]; every other
// block runs kWarps warp tasks, warp w task n_hub + (b - n_hub) * kWarps + w.
template <class C, class G, int kChunk, class Src, int kMin, int kLane>
__global__ void __launch_bounds__(kThreads, kMin)
pull_acc_kernel(Src src, const int* __restrict__ col_src,
                const int* __restrict__ weights,
                const int64_t* __restrict__ rp,
                const int* __restrict__ tasks, int64_t n_tasks,
                int64_t n_hub, int k, unsigned* __restrict__ out) {
  using F = Fold<C>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nch = kChunk == 1 ? 1 : (k + 7) / 8;
  Pull<C, G, kChunk, Src> p{src, col_src, weights, 0};
  const int64_t r = row_pass::hub_row(tasks, n_hub);
  if (r >= 0) {
    __shared__ unsigned red[kWarps][kChunk];
    const int64_t lo = rp[r], hi = rp[r + 1];
    for (int c = 0; c < nch; ++c) {
      p.c = c;
      unsigned a[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) a[j] = F::ident();
      p.template strided_row<kThreads>(a, lo, hi, threadIdx.x);
      warp_fold<C>(a);
      if (lane == 0)
#pragma unroll
        for (int j = 0; j < kChunk; ++j) red[warp][j] = a[j];
      __syncthreads();
      const int j = threadIdx.x;
      if (j < kChunk && 8 * c + j < k) {
        unsigned u = F::ident();
        for (int w = 0; w < kWarps; ++w) u = F::comb(u, red[w][j]);
        out[r * k + 8 * c + j] = F::out(u);
      }
      __syncthreads();
    }
    return;
  }
  int64_t r0, r1, lo, hi;
  if (!row_pass::warp_task<kWarps>(tasks, n_tasks, n_hub, rp, r0, r1, lo, hi))
    return;   // the whole warp
  const int64_t row = r0 + lane;
  const bool own = hi - lo <= kLane;
  const unsigned long_rows = __ballot_sync(row_pass::kFull, !own);
  for (int c = 0; c < nch; ++c) {
    p.c = c;
    unsigned a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = F::ident();
    if (own) p.lane_row(a, lo, hi);
    row_pass::each_long_row(long_rows, lo, hi,
                            [&](int l, int64_t la, int64_t lb) {
      unsigned t[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) t[j] = F::ident();
      p.template strided_row<32>(t, la, lb, lane);
      warp_fold<C>(t);
      if (lane == l)
#pragma unroll
        for (int j = 0; j < kChunk; ++j) a[j] = t[j];
    });
    if (row < r1)
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if (kChunk == 1 || 8 * c + j < k)
          out[row * k + 8 * c + j] = F::out(a[j]);
  }
}

// Launches the pull over n_tasks tasks (none when there are none).
template <class C, class G, int kChunk, int kMin, int kLane, class Src>
cudaError_t launch_pull(Src src, const void* col_src, const void* weights,
                        const void* row_ptr, const void* tasks,
                        int64_t n_tasks, int64_t n_hub, int k, void* acc,
                        cudaStream_t st) {
  if (n_tasks == 0) return cudaSuccess;
  const int64_t blocks = row_pass::grid(n_tasks, n_hub, kWarps);
  pull_acc_kernel<C, G, kChunk, Src, kMin, kLane>
      <<<(unsigned)blocks, kThreads, 0, st>>>(
          src, static_cast<const int*>(col_src),
          static_cast<const int*>(weights),
          static_cast<const int64_t*>(row_ptr),
          static_cast<const int*>(tasks), n_tasks, n_hub, k,
          static_cast<unsigned*>(acc));
  return cudaGetLastError();
}

template <class C, class G>
cudaError_t run_pull(const void* val, const void* front, int64_t n_tab,
                     const void* col_src, const void* weights,
                     const void* row_ptr, const void* tasks, int64_t n_tasks,
                     int64_t n_hub, int k, void* bits, void* acc,
                     cudaStream_t st) {
  using T = typename C::T;
  const cudaError_t e = pack_bits(front, n_tab, k, bits, st);
  if (e != cudaSuccess) return e;
  const auto* v = static_cast<const T*>(val);
  const auto* b = static_cast<const unsigned*>(bits);
  if (k == 1)
    return launch_pull<C, G, 1, kMinBlocks, kLaneMax>(
        Bits<T, 1>{v, b, 1, 1}, col_src, weights, row_ptr, tasks, n_tasks,
        n_hub, k, acc, st);
  return launch_pull<C, G, 8, kMinBlocksK, kLaneMax>(
      Bits<T, 8>{v, b, k, (k + 7) / 8}, col_src, weights, row_ptr, tasks,
      n_tasks, n_hub, k, acc, st);
}

// K5 in either form: the packed table alone, or the bits of the frontier
// (packed first) and the values.
template <class C, class G>
cudaError_t run_relax(const void* packed, const void* values,
                      const void* frontier, int64_t n_tab,
                      const void* col_src, const void* row_ptr,
                      const void* tasks, int64_t n_tasks, int64_t n_hub,
                      void* bits, void* acc, cudaStream_t st) {
  if (packed != nullptr)
    return launch_pull<C, G, 1, kMinBlocks5, kLaneMax5>(
        Packed{static_cast<const unsigned*>(packed)}, col_src, nullptr,
        row_ptr, tasks, n_tasks, n_hub, 1, acc, st);
  const cudaError_t e = pack_bits(frontier, n_tab, 1, bits, st);
  if (e != cudaSuccess) return e;
  return launch_pull<C, G, 1, kMinBlocks5, kLaneMax5>(
      Bits<unsigned, 1>{static_cast<const unsigned*>(values),
                        static_cast<const unsigned*>(bits), 1, 1},
      col_src, nullptr, row_ptr, tasks, n_tasks, n_hub, 1, acc, st);
}

template <class C, class G>
cudaError_t run_push(const void* q, const void* start, const void* offs,
                     int64_t cnt, int parts, int64_t total,
                     const void* col_dst, int64_t dst_stride,
                     const void* weights, const void* val, void* acc,
                     int64_t acc_stride, int64_t n_acc, void* scratch,
                     cudaStream_t st) {
  const Receivers r{static_cast<const int64_t*>(start),
                    static_cast<const int64_t*>(offs),
                    static_cast<const int*>(col_dst),
                    static_cast<const int*>(weights), cnt, dst_stride,
                    acc_stride, parts};
  return queue_fold<C, G, kInitFill>(q, r, val, acc, n_acc, total, scratch,
                                     st);
}

}  // namespace

// values: (n_tab, k) uint32 or f32 by op; frontier: (n_tab, k) bool;
// col_src: (ne,) int32 rows of the table; weights: (ne,) int32 for add_w,
// else unused; row_ptr: (nrows+1,) int64; tasks: (n_tasks, 2) int32 row
// ranges, the n_hub hub rows first (ops/segment.py::row_tasks), covering
// the rows; k >= 1. op: 0-4 (see above). bits: scratch of (n_tab + 31) / 32
// words (k = 1) or n_tab * ceil(k / 8) bytes. acc: (nrows, k) words,
// written (as f32 for f32 ops).
extern "C" int lux_gas_pull_acc(const void* values, const void* frontier,
                                int64_t n_tab, const void* col_src,
                                const void* weights, const void* row_ptr,
                                const void* tasks, int64_t n_tasks,
                                int64_t n_hub, int k, int op, void* bits,
                                void* acc, void* stream) {
  if (k < 1 || op < 0 || op > 4 || n_hub < 0 || n_hub > n_tasks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LUX_PULL(C, G)                                                      \
  run_pull<C, G>(values, frontier, n_tab, col_src, weights, row_ptr, tasks, \
                 n_tasks, n_hub, k, bits, acc, st)
  switch (op) {
    case 0:
      return (int)LUX_PULL(MinU32, Add1);
    case 1:
      return (int)LUX_PULL(MaxU32, Copy);
    case 2:
      return (int)LUX_PULL(MinF32, AddW);
    case 3:
      return (int)LUX_PULL(MaxU32, Decay);
    default:
      return (int)LUX_PULL(SumU32, One);
  }
#undef LUX_PULL
}

// packed: (n_tab,) words value | frontier << 31, or null; then values
// (n_tab,) uint32 and frontier (n_tab,) bool are read instead, through
// bits, scratch of (n_tab + 31) / 32 words. col_src: (ne,) int32 rows of
// the table; row_ptr: (nrows+1,) int64; tasks: (n_tasks, 2) int32 row
// ranges, the n_hub hub rows first, covering the rows. comb: 0 min, 1 max;
// relax: 0 add1, 1 copy. acc: (nrows,) words, written.
extern "C" int lux_segment_minmax_relax(
    const void* packed, const void* values, const void* frontier,
    int64_t n_tab, const void* col_src, const void* row_ptr,
    const void* tasks, int64_t n_tasks, int64_t n_hub, int comb, int relax,
    void* bits, void* acc, void* stream) {
  if (comb < 0 || comb > 1 || relax < 0 || relax > 1 || n_hub < 0 ||
      n_hub > n_tasks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LUX_RELAX(C, G)                                                    \
  run_relax<C, G>(packed, values, frontier, n_tab, col_src, row_ptr, tasks, \
                  n_tasks, n_hub, bits, acc, st)
  if (comb == 0)
    return (int)(relax == 0 ? LUX_RELAX(MinU32, Add1)
                            : LUX_RELAX(MinU32, Copy));
  return (int)(relax == 0 ? LUX_RELAX(MaxU32, Add1) : LUX_RELAX(MaxU32, Copy));
#undef LUX_RELAX
}

// frontier: (n, k) bool; bits: its pack, as K10 reads it.
extern "C" int lux_frontier_bits(const void* frontier, int64_t n, int k,
                                 void* bits, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  return (int)pack_bits(frontier, n, k, bits,
                        static_cast<cudaStream_t>(stream));
}

// q: (cnt,) queue of K6 (rows of val), cnt >= 1; per receiver p < parts (1
// to kQueueMaxParts, more is refused): start (parts, cnt) and offs (parts,
// cnt + 1) its CSR ranges at the queue and their exclusive prefix
// (offs[p][cnt] its edge total), col_dst and weights (parts, dst_stride) its
// CSR destinations and weights (weights read for add_w only). val: uint32 or
// f32 by op, the rows q indexes. acc: (parts, acc_stride) words, n_acc =
// parts * acc_stride, written: receiver p's row the identity combined with
// its messages, as f32 for f32 ops (the identity fill and the f32 decode run
// over all n_acc words). One receiver: parts 1, strides unused (0). total:
// the receivers' edges together (sizes the grid only). scratch: K6's, whose
// first two words are the grid barrier's.
extern "C" int lux_gas_push_acc(const void* q, const void* start,
                                const void* offs, int64_t cnt, int parts,
                                int64_t total, const void* col_dst,
                                int64_t dst_stride, const void* weights,
                                const void* values, int op, void* acc,
                                int64_t acc_stride, int64_t n_acc,
                                void* scratch, void* stream) {
  if (op < 0 || op > 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LUX_PUSH(C, G)                                                     \
  run_push<C, G>(q, start, offs, cnt, parts, total, col_dst, dst_stride,   \
                 weights, values, acc, acc_stride, n_acc, scratch, st)
  switch (op) {
    case 0:
      return (int)LUX_PUSH(MinU32, Add1);
    case 1:
      return (int)LUX_PUSH(MaxU32, Copy);
    case 2:
      return (int)LUX_PUSH(MinF32, AddW);
    case 3:
      return (int)LUX_PUSH(MaxU32, Decay);
    default:
      return (int)LUX_PUSH(SumU32, One);
  }
#undef LUX_PUSH
}
