// K10 gas_pull_acc and K11 gas_push_acc: the GAS engine's accumulator, built
// from either direction.
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
// The (combiner, value type, gather op) triples are those of the registered
// programs: (min, u32, add1) BFS and SSSP, (max, u32, copy) CC, (min, f32,
// add_w) DeltaSSSP, (max, u32, decay) label propagation, (sum, u32, one)
// k-core; op codes 0-4 in that order (ops/segment.py::GAS_KERNEL_OPS).
//
// Bound on the H100: bytes. K10 reads per edge 4 bytes of col_src and one
// frontier byte per column, and per active edge a random value (4 bytes a
// column) and, for add_w, a 4-byte weight; the value and frontier tables are
// nv * k * 5 bytes (21 MB at R-MAT scale 22 and k = 1), so their random
// reads mostly hit the 50 MB L2. K11 reads 20 bytes per queue slot, per
// out-edge 4 bytes of col_dst (and a weight) and does one 4-byte atomic; the
// accumulator it folds into is nv words.
//
// Design. K10 walks the CSC's work items as K5 does (push_dense.cu): rows cut
// into items of at most SEG_ITEM edges inside one row, kGroup threads per
// item striding over it and combining in registers, then with shuffles; one
// thread folds each item's result into acc[row] with one atomic, skipped for
// the identity. A hub's items spread over many warps and meet only in their
// atomics. Columns are processed kChunk at a time (k = 1 runs one column;
// any k > 1 runs ceil(k / 8) chunks of 8), each chunk walking the item again.
// K11 is K7's kernel (queue_fold_kernel, gas_ops.cuh), balanced on edge
// slots, over an identity-filled accumulator with the GAS gather ops. f32
// min folds order-preserving keys (gas_ops.cuh); the entry points then decode
// the accumulator back to f32 in place. The wrappers fill the accumulator
// with the identity (or its key) first.

#include <cstdint>
#include <cuda_runtime.h>

#include "gas_ops.cuh"

namespace {

using namespace luxk;

constexpr int kGroup = 8;       // K10 threads per work item
constexpr int kThreads = 256;   // a multiple of 32 and of kGroup

template <class C, class G, int kChunk>
__global__ void __launch_bounds__(kThreads)
pull_acc_kernel(const typename C::T* __restrict__ val,
                const unsigned char* __restrict__ front,
                const int* __restrict__ col_src,
                const int* __restrict__ weights,
                const int64_t* __restrict__ item_lo,
                const int* __restrict__ item_row, int64_t n_items, int k,
                unsigned* __restrict__ acc) {
  using T = typename C::T;
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t item = gid / kGroup;
  const int sub = (int)(gid % kGroup);
  const bool live = item < n_items;
  const int64_t lo = live ? item_lo[item] : 0;
  const int64_t hi = live ? item_lo[item + 1] : 0;
  // c0 and k are the same in every thread, so every thread of the warp
  // reaches the shuffles (no early return).
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    T a[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) a[j] = C::ident();
    for (int64_t e = lo + sub; e < hi; e += kGroup) {
      const int64_t base = (int64_t)__ldg(col_src + e) * k + c0;
      const int w = G::kWeighted ? __ldg(weights + e) : 0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if ((kChunk == 1 || c0 + j < k) && __ldg(front + base + j))
          a[j] = C::apply(a[j], G::apply(__ldg(val + base + j), w));
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        a[j] = C::apply(a[j], __shfl_xor_sync(0xffffffffu, a[j], off));
    if (live && sub == 0) {
      unsigned* out = acc + (int64_t)item_row[item] * k + c0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        if ((kChunk == 1 || c0 + j < k) && a[j] != C::ident())
          C::atomic(out + j, a[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
decode_f32_keys(unsigned* __restrict__ a, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] = f32_unkey(a[i]);
}

// After the fold: decode the accumulator's f32 keys in place.
template <class C>
cudaError_t finish(unsigned* acc, int64_t n, cudaStream_t st) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !C::kKeyed || n == 0) return e;
  decode_f32_keys<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    st>>>(acc, n);
  return cudaGetLastError();
}

template <class C, class G>
cudaError_t run_pull(const void* val, const void* front, const void* col_src,
                     const void* weights, const void* item_lo,
                     const void* item_row, int64_t n_items, int k, void* acc,
                     int64_t n_acc, cudaStream_t st) {
  using T = typename C::T;
  const int64_t blocks = (n_items * kGroup + kThreads - 1) / kThreads;
  const auto* v = static_cast<const T*>(val);
  const auto* f = static_cast<const unsigned char*>(front);
  const auto* cs = static_cast<const int*>(col_src);
  const auto* w = static_cast<const int*>(weights);
  const auto* il = static_cast<const int64_t*>(item_lo);
  const auto* ir = static_cast<const int*>(item_row);
  auto* a = static_cast<unsigned*>(acc);
  if (k == 1)
    pull_acc_kernel<C, G, 1><<<(unsigned)blocks, kThreads, 0, st>>>(
        v, f, cs, w, il, ir, n_items, k, a);
  else
    pull_acc_kernel<C, G, 8><<<(unsigned)blocks, kThreads, 0, st>>>(
        v, f, cs, w, il, ir, n_items, k, a);
  return finish<C>(a, n_acc, st);
}

template <class C, class G>
cudaError_t run_push(const void* q, const void* start, const void* offs,
                     int64_t cnt, int64_t total, const void* col_dst,
                     const void* weights, const void* val, void* acc,
                     int64_t n_acc, cudaStream_t st) {
  const cudaError_t e = queue_fold<C, G>(q, start, offs, cnt, total, col_dst,
                                         weights, val, acc, st);
  if (e != cudaSuccess) return e;
  return finish<C>(static_cast<unsigned*>(acc), n_acc, st);
}

}  // namespace

// values: (nv, k) uint32 or f32 by op; frontier: (nv, k) bool; col_src:
// (ne,) int32; weights: (ne,) int32 for add_w, else unused; item_lo:
// (n_items+1,) int64 edge offsets; item_row: (n_items,) int32 rows;
// n_items > 0; k >= 1. op: 0-4 (see above). acc: n_acc = nv * k words filled
// with the identity (the key of the identity for f32), combined into in place
// and left as f32 for f32 ops.
extern "C" int lux_gas_pull_acc(const void* values, const void* frontier,
                                const void* col_src, const void* weights,
                                const void* item_lo, const void* item_row,
                                int64_t n_items, int k, int op, void* acc,
                                int64_t n_acc, void* stream) {
  if (k < 1 || op < 0 || op > 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0:
      return (int)run_pull<MinU32, Add1>(values, frontier, col_src, weights,
                                         item_lo, item_row, n_items, k, acc,
                                         n_acc, st);
    case 1:
      return (int)run_pull<MaxU32, Copy>(values, frontier, col_src, weights,
                                         item_lo, item_row, n_items, k, acc,
                                         n_acc, st);
    case 2:
      return (int)run_pull<MinF32, AddW>(values, frontier, col_src, weights,
                                         item_lo, item_row, n_items, k, acc,
                                         n_acc, st);
    case 3:
      return (int)run_pull<MaxU32, Decay>(values, frontier, col_src, weights,
                                          item_lo, item_row, n_items, k, acc,
                                          n_acc, st);
    default:
      return (int)run_pull<SumU32, One>(values, frontier, col_src, weights,
                                        item_lo, item_row, n_items, k, acc,
                                        n_acc, st);
  }
}

// q, start: (cnt,) queue of K6; offs: (cnt+1,) exclusive degree prefix with
// offs[cnt] == total > 0; col_dst, weights: the CSR's (weights read for add_w
// only); values: (nv,) uint32 or f32 by op. acc: n_acc = nv words filled with
// the identity (its key for f32), combined into in place and left as f32 for
// f32 ops.
extern "C" int lux_gas_push_acc(const void* q, const void* start,
                                const void* offs, int64_t cnt, int64_t total,
                                const void* col_dst, const void* weights,
                                const void* values, int op, void* acc,
                                int64_t n_acc, void* stream) {
  if (op < 0 || op > 4) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case 0:
      return (int)run_push<MinU32, Add1>(q, start, offs, cnt, total, col_dst,
                                         weights, values, acc, n_acc, st);
    case 1:
      return (int)run_push<MaxU32, Copy>(q, start, offs, cnt, total, col_dst,
                                         weights, values, acc, n_acc, st);
    case 2:
      return (int)run_push<MinF32, AddW>(q, start, offs, cnt, total, col_dst,
                                         weights, values, acc, n_acc, st);
    case 3:
      return (int)run_push<MaxU32, Decay>(q, start, offs, cnt, total,
                                          col_dst, weights, values, acc,
                                          n_acc, st);
    default:
      return (int)run_push<SumU32, One>(q, start, offs, cnt, total, col_dst,
                                        weights, values, acc, n_acc, st);
  }
}
