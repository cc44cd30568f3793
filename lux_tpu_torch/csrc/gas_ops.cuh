// Functors and helpers shared by the frontier kernels: K7 (frontier.cu), K5,
// K10 and K11 (gas.cu); and the queue expansion kernel K7 and K11 both
// launch.
//
// A combiner names its value type T, its identity, the combine of two values
// and the atomic fold of a value into an accumulator word. uint32 values fold
// with atomicMin/atomicMax/atomicAdd, which do not depend on order. f32 min
// folds the order-preserving uint32 key of the float (the sign-flip map: flip
// every bit of a negative float, only the sign bit of any other), so an
// integer atomicMin on keys is a float min (and atomicMax a float max, which
// no program needs yet); the caller decodes the keys afterwards
// (decode_f32_keys). The map orders -0.0 below +0.0 and puts NaNs outside
// the infinities: NaN values are not supported.
//
// A gather op maps a source value (and, when kWeighted, the edge's int32
// weight) to the message sent along the edge.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace luxk {

struct MinU32 {
  using T = unsigned;
  static constexpr bool kKeyed = false;  // folds values, not keys
  __device__ __forceinline__ static unsigned ident() { return 0xFFFFFFFFu; }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return a < b ? a : b;
  }
  __device__ __forceinline__ static void atomic(unsigned* p, unsigned v) {
    atomicMin(p, v);
  }
};

struct MaxU32 {
  using T = unsigned;
  static constexpr bool kKeyed = false;
  __device__ __forceinline__ static unsigned ident() { return 0u; }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return a > b ? a : b;
  }
  __device__ __forceinline__ static void atomic(unsigned* p, unsigned v) {
    atomicMax(p, v);
  }
};

struct SumU32 {
  using T = unsigned;
  static constexpr bool kKeyed = false;
  __device__ __forceinline__ static unsigned ident() { return 0u; }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return a + b;
  }
  __device__ __forceinline__ static void atomic(unsigned* p, unsigned v) {
    atomicAdd(p, v);
  }
};

__device__ __forceinline__ unsigned f32_key(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ unsigned f32_unkey(unsigned k) {
  return k ^ ((k >> 31) ? 0x80000000u : 0xFFFFFFFFu);
}

struct MinF32 {
  using T = float;
  static constexpr bool kKeyed = true;   // folds f32_key(v)
  __device__ __forceinline__ static float ident() {
    return __uint_as_float(0x7F800000u);  // +inf
  }
  __device__ __forceinline__ static float apply(float a, float b) {
    return a < b ? a : b;
  }
  __device__ __forceinline__ static void atomic(unsigned* p, float v) {
    atomicMin(p, f32_key(v));
  }
};

// Gather ops (relax ops of the push engine).
struct Add1 {  // v + 1, wrapping at 2^32: BFS depths, SSSP hop counts
  static constexpr bool kWeighted = false;
  __device__ __forceinline__ static unsigned apply(unsigned v, int = 0) {
    return v + 1u;
  }
};

struct Copy {  // v: CC labels
  static constexpr bool kWeighted = false;
  __device__ __forceinline__ static unsigned apply(unsigned v, int = 0) {
    return v;
  }
};

struct AddW {  // v + float(w): DeltaSSSP distances
  static constexpr bool kWeighted = true;
  __device__ __forceinline__ static float apply(float v, int w) {
    return v + (float)w;
  }
};

struct Decay {  // label propagation: spend one hop of the low byte
  static constexpr bool kWeighted = false;
  __device__ __forceinline__ static unsigned apply(unsigned v, int = 0) {
    const unsigned hops = v & 0xFFu;
    return hops ? ((v & ~0xFFu) | (hops - 1u)) : 0u;
  }
};

struct One {  // k-core: one decrement per removed in-edge
  static constexpr bool kWeighted = false;
  __device__ __forceinline__ static unsigned apply(unsigned, int = 0) {
    return 1u;
  }
};

// The largest i in [lo, hi) with offs[i] <= s, given offs[lo] <= s: the
// queue slot owning edge slot s (K7, K11).
__device__ __forceinline__ int64_t owner(const int64_t* offs, int64_t lo,
                                         int64_t hi, int64_t s) {
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (offs[mid] <= s)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

}  // namespace luxk

// The queue expansion of K7 and K11, over the queue of K6 (q, start, offs):
// folds G(val[q[i]], weights[e]) into acc[col_dst[e]] with C's atomic for
// every out-edge e of every queued vertex, skipping the identity (a no-op
// fold). Balanced on edge slots: each block takes kQueueSlots consecutive
// slots s < total, finds the queue range covering them once, and each
// thread binary-searches its slot's owner inside that range (merge-path
// style), so a hub's out-edges spread over many blocks. In an unnamed
// namespace: each kernel source keeps its own copy.
namespace {

constexpr int kQueueThreads = 256;
constexpr int kQueueSlots = 1024;

template <class C, class G>
__global__ void __launch_bounds__(kQueueThreads)
queue_fold_kernel(const int* __restrict__ q, const int64_t* __restrict__ start,
                  const int64_t* __restrict__ offs, int64_t cnt, int64_t total,
                  const int* __restrict__ col_dst,
                  const int* __restrict__ weights,
                  const typename C::T* __restrict__ val,
                  unsigned* __restrict__ acc) {
  using T = typename C::T;
  __shared__ int64_t range[2];
  const int64_t s0 = (int64_t)blockIdx.x * kQueueSlots;
  const int64_t s1 = s0 + kQueueSlots < total ? s0 + kQueueSlots : total;
  if (threadIdx.x == 0) {
    range[0] = luxk::owner(offs, 0, cnt, s0);
    range[1] = luxk::owner(offs, range[0], cnt, s1 - 1) + 1;
  }
  __syncthreads();
  const int64_t lo = range[0], hi = range[1];
  for (int64_t s = s0 + threadIdx.x; s < s1; s += kQueueThreads) {
    const int64_t i = luxk::owner(offs, lo, hi, s);
    const int64_t e = start[i] + (s - offs[i]);
    const int w = G::kWeighted ? __ldg(weights + e) : 0;
    const T m = G::apply(__ldg(val + q[i]), w);
    if (m != C::ident()) C::atomic(acc + col_dst[e], m);
  }
}

// Launches queue_fold_kernel over total > 0 edge slots.
template <class C, class G>
cudaError_t queue_fold(const void* q, const void* start, const void* offs,
                       int64_t cnt, int64_t total, const void* col_dst,
                       const void* weights, const void* val, void* acc,
                       cudaStream_t st) {
  const int64_t blocks = (total + kQueueSlots - 1) / kQueueSlots;
  queue_fold_kernel<C, G><<<(unsigned)blocks, kQueueThreads, 0, st>>>(
      static_cast<const int*>(q), static_cast<const int64_t*>(start),
      static_cast<const int64_t*>(offs), cnt, total,
      static_cast<const int*>(col_dst), static_cast<const int*>(weights),
      static_cast<const typename C::T*>(val), static_cast<unsigned*>(acc));
  return cudaGetLastError();
}

}  // namespace
