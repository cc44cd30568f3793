// K5 segment_minmax_relax: the push engine's dense (pull-direction) iteration.
//
// Replaces lux_tpu/engine/push.py::_blocked_candidates (jnp/lax: per edge a
// 128-lane row gather from the packed value | frontier << 31 table, a one-hot
// lane select, unpack, relax, identity mask) together with
// lux_tpu/ops/segment.py::segment_minmax_blockmin (a 128-block reduce, a
// block-level segmented min/max scan, masked head/tail row gathers from
// sub-cliff table slices), and the plain dense _d_load/_d_comp over
// segment_reduce. For every destination v of the CSC it computes
//   acc[v] = comb over e in [row_ptr[v], row_ptr[v+1]) of
//            (active(src_e) ? relax(val(src_e)) : ident)
// with comb = min or max over uint32, relax = add1 (v + 1, wrapping) or copy,
// and (val, active) read either from one packed word (value | frontier << 31)
// or from a value array plus a bool frontier.
//
// Bound on the H100: bytes. Per edge a 4-byte col_src read and a 4-byte
// random read of the source's word; the table is nv words (16.8 MB at R-MAT
// scale 22), so it stays in the 50 MB L2 and those random reads mostly cost
// L2, not HBM. Per row an 8-byte row pointer (the kernel reads its work
// items instead, 12 bytes each) and a 4-byte output. One compare per edge,
// far below the integer rate.
//
// Design. The TPU version's row gathers, lane selects, block-min layout and
// segmented scans exist only because the TPU has no fast scalar gather; here
// an edge's word is one direct load. Rows are skewed (R-MAT hubs hold 10^5
// in-edges), so the host cuts the edges into work items of at most SEG_ITEM
// edges inside one row (ops/segment.py::segment_items) and records each
// item's row. Each item gets kGroup threads that stride over it and combine
// in registers, then with shuffles; one thread then folds the item's result
// into acc[row] with atomicMin/atomicMax (skipped when it is the identity).
// The wrapper fills acc with the identity first, so rows without edges keep
// it. A hub's items spread over many warps and meet only in its atomics.
// Integer min/max do not depend on order, so the result is bitwise that of
// the plain version. The combiners and relax ops are gas_ops.cuh's, shared
// with K7, K10 and K11.

#include <cstdint>
#include <cuda_runtime.h>

#include "gas_ops.cuh"

namespace {

constexpr int kGroup = 8;       // threads per work item
constexpr int kThreads = 256;   // a multiple of 32 and of kGroup

using luxk::Add1;
using luxk::Copy;
using MinOp = luxk::MinU32;
using MaxOp = luxk::MaxU32;

// One packed word per vertex: value in bits 0-30, frontier in bit 31.
struct Packed {
  const unsigned* word;
  __device__ __forceinline__ bool fetch(int src, unsigned* v) const {
    const unsigned w = __ldg(word + src);
    *v = w & 0x7FFFFFFFu;
    return (w >> 31) != 0u;
  }
};

// Values plus a bool (one byte) frontier.
struct Unpacked {
  const unsigned* val;
  const unsigned char* front;
  __device__ __forceinline__ bool fetch(int src, unsigned* v) const {
    if (__ldg(front + src) == 0) return false;
    *v = __ldg(val + src);
    return true;
  }
};

template <class Comb, class Relax, class Src>
__global__ void __launch_bounds__(kThreads)
relax_items_kernel(Src src, const int* __restrict__ col_src,
                   const int64_t* __restrict__ item_lo,
                   const int* __restrict__ item_row, int64_t n_items,
                   unsigned* __restrict__ acc) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t item = gid / kGroup;
  const int sub = (int)(gid % kGroup);
  unsigned a = Comb::ident();
  if (item < n_items) {
    const int64_t hi = item_lo[item + 1];
    for (int64_t e = item_lo[item] + sub; e < hi; e += kGroup) {
      unsigned v;
      if (src.fetch(__ldg(col_src + e), &v))
        a = Comb::apply(a, Relax::apply(v));
    }
  }
  // Every thread of the warp reaches the shuffles (no early return).
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    a = Comb::apply(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (item < n_items && sub == 0 && a != Comb::ident())
    Comb::atomic(acc + item_row[item], a);
}

template <class Comb, class Relax, class Src>
cudaError_t run(Src src, const void* col_src, const void* item_lo,
                const void* item_row, int64_t n_items, void* acc,
                cudaStream_t st) {
  const int64_t blocks = (n_items * kGroup + kThreads - 1) / kThreads;
  relax_items_kernel<Comb, Relax, Src><<<(unsigned)blocks, kThreads, 0, st>>>(
      src, static_cast<const int*>(col_src),
      static_cast<const int64_t*>(item_lo), static_cast<const int*>(item_row),
      n_items, static_cast<unsigned*>(acc));
  return cudaGetLastError();
}

template <class Src>
cudaError_t dispatch(Src src, int comb, int relax, const void* col_src,
                     const void* item_lo, const void* item_row,
                     int64_t n_items, void* acc, cudaStream_t st) {
  if (comb == 0 && relax == 0)
    return run<MinOp, Add1>(src, col_src, item_lo, item_row, n_items, acc, st);
  if (comb == 0)
    return run<MinOp, Copy>(src, col_src, item_lo, item_row, n_items, acc, st);
  if (relax == 0)
    return run<MaxOp, Add1>(src, col_src, item_lo, item_row, n_items, acc, st);
  return run<MaxOp, Copy>(src, col_src, item_lo, item_row, n_items, acc, st);
}

}  // namespace

// packed: (nv,) words value | frontier << 31, or null; then values (nv,)
// uint32 and frontier (nv,) bool are read instead. item_lo: (n_items+1,)
// int64 edge offsets; item_row: (n_items,) int32 rows; n_items > 0.
// comb: 0 min, 1 max. relax: 0 add1, 1 copy. acc: (nv,) filled with the
// identity, combined into in place.
extern "C" int lux_segment_minmax_relax(
    const void* packed, const void* values, const void* frontier,
    const void* col_src, const void* item_lo, const void* item_row,
    int64_t n_items, int comb, int relax, void* acc, void* stream) {
  if (comb < 0 || comb > 1 || relax < 0 || relax > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed != nullptr)
    return (int)dispatch(Packed{static_cast<const unsigned*>(packed)}, comb,
                         relax, col_src, item_lo, item_row, n_items, acc, st);
  return (int)dispatch(
      Unpacked{static_cast<const unsigned*>(values),
               static_cast<const unsigned char*>(frontier)},
      comb, relax, col_src, item_lo, item_row, n_items, acc, st);
}
