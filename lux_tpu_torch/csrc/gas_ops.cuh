// Functors and helpers shared by the frontier kernels: K6 and K7
// (frontier.cu), K5, K10 and K11 (gas.cu); the grid barrier of the
// cooperative launches (K6, K7, K11); and the queue expansion kernel K7 and
// K11 both launch.
//
// A combiner names its value type T, its identity, the combine of two values,
// the accumulator word a value folds as (key), the atomic fold of a word and
// whether a word already settles a fold (settled: folding k into cur would
// leave cur as it is; never for a sum). uint32 values fold with
// atomicMin/atomicMax/atomicAdd, which do not depend on order. f32 min folds
// the order-preserving uint32 key of the float (the sign-flip map: flip every
// bit of a negative float, only the sign bit of any other), so an integer
// atomicMin on keys is a float min (and atomicMax a float max, which no
// program needs yet); the keys are decoded afterwards (f32_unkey). The map
// orders -0.0 below +0.0 and puts NaNs outside the infinities: NaN values are
// not supported.
//
// A gather op maps a source value (and, when kWeighted, the edge's int32
// weight) to the message sent along the edge.
#pragma once

#include <atomic>
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
  __device__ __forceinline__ static unsigned key(unsigned v) { return v; }
  __device__ __forceinline__ static bool settled(unsigned cur, unsigned k) {
    return cur <= k;
  }
  __device__ __forceinline__ static void atomic_key(unsigned* p, unsigned k) {
    atomicMin(p, k);
  }
};

struct MaxU32 {
  using T = unsigned;
  static constexpr bool kKeyed = false;
  __device__ __forceinline__ static unsigned ident() { return 0u; }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return a > b ? a : b;
  }
  __device__ __forceinline__ static unsigned key(unsigned v) { return v; }
  __device__ __forceinline__ static bool settled(unsigned cur, unsigned k) {
    return cur >= k;
  }
  __device__ __forceinline__ static void atomic_key(unsigned* p, unsigned k) {
    atomicMax(p, k);
  }
};

struct SumU32 {
  using T = unsigned;
  static constexpr bool kKeyed = false;
  __device__ __forceinline__ static unsigned ident() { return 0u; }
  __device__ __forceinline__ static unsigned apply(unsigned a, unsigned b) {
    return a + b;
  }
  __device__ __forceinline__ static unsigned key(unsigned v) { return v; }
  __device__ __forceinline__ static bool settled(unsigned, unsigned) {
    return false;
  }
  __device__ __forceinline__ static void atomic_key(unsigned* p, unsigned k) {
    atomicAdd(p, k);
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
  __device__ __forceinline__ static unsigned key(float v) { return f32_key(v); }
  __device__ __forceinline__ static bool settled(unsigned cur, unsigned k) {
    return cur <= k;
  }
  __device__ __forceinline__ static void atomic_key(unsigned* p, unsigned k) {
    atomicMin(p, k);
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

// The count of i in [0, n) with a[i] <= s, a non-decreasing, by the whole
// warp: 32 probes a step narrow [lo, hi] 33-fold, so a queue of 2^18 slots
// takes four dependent rounds of loads.
__device__ __forceinline__ int64_t count_le_warp(const int64_t* a, int64_t n,
                                                 int64_t s, int lane) {
  int64_t lo = 0, hi = n;
  while (hi - lo > 32) {
    const int64_t p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned le = __ballot_sync(0xffffffffu, a[p] <= s);
    const int k = __popc(le);   // probes 0 .. k-1 are <= s
    const int64_t plo = __shfl_sync(0xffffffffu, p, k > 0 ? k - 1 : 0);
    const int64_t phi = __shfl_sync(0xffffffffu, p, k < 32 ? k : 31);
    if (k > 0) lo = plo + 1;
    if (k < 32) hi = phi;
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, p < hi && a[p] <= s));
}

// The largest i in [lo, hi) with offs[i] <= s, given offs[lo] <= s: the
// queue slot owning edge slot s, by one thread.
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

// The two words of a grid barrier, in a scratch tensor zeroed when it is
// allocated (ops/frontier.py::_queue_scratch): arrivals and a generation.
struct Barrier {
  unsigned long long* arrived;
  unsigned long long* generation;
};

// Every block of the (co-resident) grid waits here for all the others; what
// a block wrote before it is visible to every block after it. The last block
// to arrive resets the count and bumps the generation the others wait on, so
// the words need no zeroing between calls; calls on one stream run one after
// another, so they may share the words.
__device__ __forceinline__ void grid_barrier(const Barrier& b) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned long long* gen = b.generation;
    const unsigned long long g0 = *gen;
    __threadfence();
    if (atomicAdd(b.arrived, 1ull) == gridDim.x - 1) {
      *b.arrived = 0;
      __threadfence();
      atomicAdd(b.generation, 1ull);
    } else {
      while (*gen == g0) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

constexpr int kMaxDevices = 64;

// The blocks of `kernel` (`threads` a block, no dynamic shared memory) that
// can be resident at once on the current device: the grid of a cooperative
// launch. Computed once per device into cache[device]; two threads that ask
// at once compute the same number.
template <class K>
cudaError_t resident_blocks(K kernel, int threads, std::atomic<int>* cache,
                            int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int r = cache[dev].load(std::memory_order_relaxed);
  if (r == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (e != cudaSuccess) return e;
    r = sms * per_sm;
    if (r <= 0) return cudaErrorInvalidConfiguration;
    cache[dev].store(r, std::memory_order_relaxed);
  }
  *out = r;
  return cudaSuccess;
}

}  // namespace luxk

// The queue expansion of K7 and K11, over the queue of K6 (q, and per
// receiver start and offs): for every receiver p and every out-edge e of
// every queued vertex in p's CSR, folds G(val[q[i]], weights_p[e]) into
// acc_p[col_dst_p[e]] with C's atomic, skipping the identity (a no-op fold).
// One cooperative launch of persistent blocks in up to three passes split by
// grid barriers:
// 1. the accumulator's start, every word of it: a copy of the values (K7:
//    new = old before the fold) or the identity's word (K11), 16 bytes a
//    thread where both tables are aligned;
// 2. the fold, balanced on edge slots: receiver p's slots [0, total_p), its
//    total offs_p[cnt] read on the card, are cut into chunks of kQueueSlots,
//    and the blocks take the chunks of every receiver in turn. A block finds
//    the queue range [lo, hi) covering its chunk by two warp-wide searches of
//    offs_p, then stages the range in shared memory once: offs, start - offs
//    and the queued value val[q[i]], so each queued value is read once a
//    chunk, not once an edge. Thread t takes slots s0 + t + k * 256, so a
//    warp's slots are consecutive and its destination loads coalesce; it
//    finds each slot's owner by a binary search of the stage from the
//    previous slot's owner, then loads its edges' destinations (and
//    weights) together before their atomics. A range of more than
//    kQueueStage slots (many queued vertices without out-edges inside one
//    chunk) is searched per slot in device memory instead;
// 3. for keyed (f32) combiners, the decode of every word back to f32.
// A min/max candidate first reads its target (in L2) and skips the atomic
// when the word already settles it: words only move toward the fold, so a
// word read at any time that settles a candidate still does.
// The constants are measured (python -m lux_tpu_torch.probes.shapes --only
// k7 k11, R-MAT 22: SSSP's queues, the sharded step's four parts, three GAS
// frontiers).
// In an unnamed namespace: each kernel source keeps its own copy.
namespace {

constexpr int kQueueThreads = 256;
constexpr int kQueueSlots = 1024;     // edge slots of a chunk: 512 and
                                      // 2,048 were slower at the cap
constexpr int kQueueStage = 512;      // queue slots a chunk stages: 256
                                      // to 1,024 came within 2%
constexpr int kQueueMinBlocks = 4;    // resident blocks asked of ptxas:
                                      // 6 or 8 were slower
constexpr int kQueueMaxParts = 64;    // receivers of one launch
constexpr int kQueuePer = kQueueSlots / kQueueThreads;
static_assert(kQueueSlots % kQueueThreads == 0, "whole runs a thread");

constexpr int kInitCopy = 0;   // acc starts as a copy of val (K7)
constexpr int kInitFill = 1;   // acc starts as the identity (K11)

// The receivers of one launch. Receiver p reads start + p * cnt,
// offs + p * (cnt + 1) (offs_p[cnt] its edge total), col_dst and weights +
// p * dst_stride, and folds into acc + p * acc_stride.
struct Receivers {
  const int64_t* start;
  const int64_t* offs;
  const int* col_dst;
  const int* weights;   // null unless G is weighted
  int64_t cnt, dst_stride, acc_stride;
  int parts;
};

template <class C>
__device__ __forceinline__ unsigned ident_key() {
  return C::key(C::ident());
}

// Folds candidate message m (its edge's destination d) into acc.
template <class C>
__device__ __forceinline__ void fold(unsigned* acc, int d,
                                     typename C::T m) {
  const unsigned k = C::key(m);
  if (k == ident_key<C>()) return;
  if (C::settled(__ldcg(acc + d), k)) return;
  C::atomic_key(acc + d, k);
}

// acc[0, n) = src[0, n), or `word` everywhere when src is null; thread g of
// `stride` threads.
__device__ __forceinline__ void init_words(unsigned* acc, const unsigned* src,
                                           unsigned word, int64_t n,
                                           int64_t g, int64_t stride) {
  int64_t i0 = 0;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(acc) |
                        reinterpret_cast<uintptr_t>(src);
  if ((mis & 15) == 0) {
    const int64_t n4 = n >> 2;
    uint4* a4 = reinterpret_cast<uint4*>(acc);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    for (int64_t i = g; i < n4; i += stride)
      a4[i] = src ? s4[i] : make_uint4(word, word, word, word);
    i0 = n4 << 2;
  }
  for (int64_t i = i0 + g; i < n; i += stride) acc[i] = src ? src[i] : word;
}

template <class C, class G, int kInit>
__global__ void __launch_bounds__(kQueueThreads, kQueueMinBlocks)
queue_fold_kernel(const int* __restrict__ q, Receivers r,
                  const typename C::T* __restrict__ val,
                  unsigned* __restrict__ acc, int64_t n_words,
                  luxk::Barrier bar) {
  using T = typename C::T;
  __shared__ int64_t s_off[kQueueStage + 1];
  __shared__ int64_t s_base[kQueueStage];
  __shared__ T s_val[kQueueStage];
  __shared__ int64_t s_total[kQueueMaxParts];
  __shared__ int64_t s_chunks[kQueueMaxParts];   // inclusive prefix
  __shared__ int64_t range[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t stride = (int64_t)gridDim.x * kQueueThreads;
  const int64_t g = (int64_t)blockIdx.x * kQueueThreads + tid;

  // 1. The accumulator's start.
  init_words(acc,
             kInit == kInitCopy ? reinterpret_cast<const unsigned*>(val)
                                : nullptr,
             ident_key<C>(), n_words, g, stride);
  if (tid < r.parts) {
    const int64_t t = r.offs[tid * (r.cnt + 1) + r.cnt];
    s_total[tid] = t;
    s_chunks[tid] = (t + kQueueSlots - 1) / kQueueSlots;
  }
  __syncthreads();
  if (tid == 0)
    for (int p = 1; p < r.parts; ++p) s_chunks[p] += s_chunks[p - 1];
  luxk::grid_barrier(bar);

  // 2. The fold, a chunk of one receiver's slots at a time.
  const int64_t n_chunks = s_chunks[r.parts - 1];
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int p = 0;
    while (s_chunks[p] <= c) ++p;
    const int64_t s0 = (c - (p ? s_chunks[p - 1] : 0)) * kQueueSlots;
    const int64_t s1 = s0 + kQueueSlots < s_total[p] ? s0 + kQueueSlots
                                                    : s_total[p];
    const int64_t* offs = r.offs + p * (r.cnt + 1);
    const int64_t* start = r.start + p * r.cnt;
    const int* col = r.col_dst + p * r.dst_stride;
    const int* wts = G::kWeighted ? r.weights + p * r.dst_stride : nullptr;
    unsigned* out = acc + p * r.acc_stride;
    if (warp < 2) {
      const int64_t i =
          luxk::count_le_warp(offs, r.cnt, warp ? s1 - 1 : s0, lane) - 1;
      if (lane == 0) range[warp] = i;
    }
    __syncthreads();
    const int64_t lo = range[0], hi = range[1] + 1, n_st = hi - lo;
    if (n_st <= kQueueStage) {
      for (int64_t j = tid; j < n_st; j += kQueueThreads) {
        const int64_t o = offs[lo + j];
        s_off[j] = o;
        s_base[j] = start[lo + j] - o;
        s_val[j] = val[q[lo + j]];
      }
      if (tid == 0) s_off[n_st] = offs[hi];
      __syncthreads();
      // Slots s0 + tid + k * kQueueThreads: a warp's slots are
      // consecutive, so are its edges inside one queued vertex. Each
      // slot's owner is the stage's last entry <= it, searched from the
      // previous slot's.
      int64_t e[kQueuePer];
      T m[kQueuePer];
      int64_t j0 = 0;
#pragma unroll
      for (int k = 0; k < kQueuePer; ++k) {
        const int64_t s = s0 + tid + (int64_t)k * kQueueThreads;
        if (s < s1) {
          int64_t j1 = n_st;
          while (j1 - j0 > 1) {
            const int64_t mid = (j0 + j1) >> 1;
            if (s_off[mid] <= s)
              j0 = mid;
            else
              j1 = mid;
          }
          e[k] = s + s_base[j0];
          m[k] = s_val[j0];
        }
      }
      int d[kQueuePer], w[kQueuePer];
#pragma unroll
      for (int k = 0; k < kQueuePer; ++k)
        if (s0 + tid + (int64_t)k * kQueueThreads < s1) {
          d[k] = __ldg(col + e[k]);
          w[k] = G::kWeighted ? __ldg(wts + e[k]) : 0;
        }
#pragma unroll
      for (int k = 0; k < kQueuePer; ++k)
        if (s0 + tid + (int64_t)k * kQueueThreads < s1)
          fold<C>(out, d[k], G::apply(m[k], w[k]));
    } else {
      // A range outgrowing the stage: each slot's owner from offs itself.
      for (int64_t s = s0 + tid; s < s1; s += kQueueThreads) {
        const int64_t i = luxk::owner(offs, lo, hi, s);
        const int64_t e = start[i] + (s - offs[i]);
        const int w = G::kWeighted ? __ldg(wts + e) : 0;
        fold<C>(out, __ldg(col + e), G::apply(__ldg(val + q[i]), w));
      }
    }
    __syncthreads();
  }

  // 3. Keys back to f32.
  if constexpr (C::kKeyed) {
    luxk::grid_barrier(bar);
    for (int64_t i = g; i < n_words; i += stride)
      acc[i] = luxk::f32_unkey(__ldcg(acc + i));
  }
}

// One cooperative launch of queue_fold_kernel over the receivers, as many
// blocks as are resident at once (cudaLaunchCooperativeKernel guarantees it,
// or refuses) but no more than the larger pass needs: `total`, the receivers'
// edges together, only sizes the grid. n_words: the accumulator's words, all
// receivers' rows (and, for K7, the values' words).
template <class C, class G, int kInit>
cudaError_t queue_fold(const void* q, const Receivers& r, const void* val,
                       void* acc, int64_t n_words, int64_t total,
                       void* scratch, cudaStream_t st) {
  static std::atomic<int> cache[luxk::kMaxDevices];
  if (r.parts < 1 || r.parts > kQueueMaxParts || r.cnt < 1 || total < 0)
    return cudaErrorInvalidValue;
  auto kernel = queue_fold_kernel<C, G, kInit>;
  int resident = 0;
  const cudaError_t e =
      luxk::resident_blocks(kernel, kQueueThreads, cache, &resident);
  if (e != cudaSuccess) return e;
  const int64_t for_words = (n_words + 16 * kQueueThreads - 1) /
                            (16 * kQueueThreads);   // four 16-byte stores
  const int64_t for_slots = (total + kQueueSlots - 1) / kQueueSlots + r.parts;
  int64_t grid = for_words > for_slots ? for_words : for_slots;
  grid = grid < resident ? grid : resident;
  unsigned long long* w = static_cast<unsigned long long*>(scratch);
  luxk::Barrier bar{w, w + 1};
  const int* qp = static_cast<const int*>(q);
  Receivers rr = r;
  const auto* vp = static_cast<const typename C::T*>(val);
  unsigned* ap = static_cast<unsigned*>(acc);
  void* args[] = {&qp, &rr, &vp, &ap, &n_words, &bar};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3((unsigned)grid),
                                     dim3(kQueueThreads), args, 0, st);
}

}  // namespace
