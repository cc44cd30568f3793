// The gather probes: block_take (P2-P5) and merge4 (P6).
//
// Replaces the Pallas kernels of the TPU gather probes:
//   block_take: tools/probe_dgather.py::make_ta (body kernel_ta),
//               tools/probe_dgather2.py::lane_call (k_lane), lane8_call
//               (k_lane8) and sub_call (k_sub);
//   merge4:     tools/probe_dgather2.py::merge_call (k_merge).
// On the TPU they measured how fast Mosaic's dynamic gather moves data
// within a (S, 128) block; here they measure the same functions on the H100.
//
// block_take computes, for x and idx of shape (rows, L), rows a multiple of
// S (the Pallas BlockSpec's block), out = take_along_axis(x, idx, axis)
// within each (S, L) block:
//   axis 1: out[r, j] = x[r, idx[r, j]]
//   axis 0: out[b*S + i, j] = x[b*S + idx[b*S + i, j], j]
// with an int32 or int8 index.
// merge4 computes, for cand (R, 4, 128) f32 and l, s (R, 128) int32,
//   out[i, j] = sum over k < 4 of (s[i, j] == k ? cand[i, k, l[i, j]] : 0)
// in k_merge's order: acc = 0, then acc += each masked term. At most one
// term is nonzero, so that is 0 + the selected value (which turns -0 into
// +0, as the Pallas sum does), or +0 when s is outside [0, 4).
// Both only move data, so they are bitwise equal to their plain versions.
// Indices are taken to lie in range, as the probes draw them; an index
// outside it is clamped into the block, so no read leaves the array.
//
// Bound on the H100: bytes. block_take reads x and idx once and writes out
// once; merge4 reads cand, l and s and writes out. No arithmetic.
//
// block_take's design. One thread per 4 consecutive elements of a row
// (L % 4 == 0): a 16-byte (int32) or 4-byte (int8) index load, four
// gathers through the read-only cache, one 16-byte store. A warp covers one
// 128-wide row, so an axis-1 gather touches one 512-byte row of x, and an
// axis-0 gather the S rows of its block, both reused from L1/L2. That suits
// axis 1 and axis 0 over small blocks (8 rows, 4 KB), which stay in L1.
//
// block_take_strip: axis 0 over large blocks (int32 indices; an int8
// index reaches only a block's first 128 rows, which stay in L1). There
// every element of the row kernel reads its own 32-byte sector from a block
// of S * 512 bytes that L1 cannot hold: at S = 8192, 33.5 M elements ask for
// about 1.07 GB of L2 sectors to use 134 MB of x. So a CTA owns one (S, W)
// column strip of one block (W = 32, 16 or 8 floats: 128, 64 or 32 bytes a
// row): it copies the strip's first R rows into shared memory once with
// cp.async in 16-byte pieces (L2 only), then streams idx[i, c:c+W] and
// writes out[i, c:c+W] in 16-byte pieces, gathering from shared memory. The
// wider the strip, the fuller the lines idx and out are read and written in
// (python -m lux_tpu_torch.probes.shapes --only p2 times each width), so the
// caller takes the widest strip that fits. Where even W = 8 does not fit
// (S = 8192 needs 256 KB of the 227 KB a block may use), the first R rows
// live in shared memory and a pick of a later row reads x through L1 and L2
// (R = 6144 leaves 64 KB of the SM's L1 for the rest).
//
// merge4's design. Its picks are uniform over a row's 512 candidates, so
// 128 picks touch 1 - (1 - 8/512)^128, about 87%, of the row's 32-byte
// sectors, and gathering them one 4-byte load at a time asks for scattered
// sectors, not whole lines (at R = 65,536 the touched sectors give a floor
// of 0.065 ms, all of cand streamed 0.070 ms, against 0.039 ms for the
// distinct elements alone). So the kernel streams every row's 2 KB whole:
// a block of 256 threads takes kMergeRows = 8 rows (16 KB of cand), each
// thread copying four 16-byte pieces into shared memory with cp.async (L2
// only) while it loads its 16 bytes of l and s; then it picks its four
// outputs from shared memory and stores them as one 16-byte streaming
// store. The blocks resident on an SM keep each other's copies in flight,
// so a block needs no second buffer.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const int32_t* p, int v[4]) {
  const int4 w = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ void load4(const int8_t* p, int v[4]) {
  const char4 w = __ldcs(reinterpret_cast<const char4*>(p));
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}

__device__ __forceinline__ int clamp_to(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

template <int Axis, typename IdxT>
__global__ void __launch_bounds__(kThreads)
block_take_kernel(const float* __restrict__ x, const IdxT* __restrict__ idx,
                  int64_t n4, int L, int S, float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n4) return;
  const int64_t e = t * 4;
  const int64_t row = e / L;
  const int col = (int)(e - row * L);
  int v[4];
  load4(idx + e, v);
  float r[4];
  if (Axis == 1) {
    const float* xr = x + row * L;
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = __ldg(xr + clamp_to(v[k], L));
  } else {
    const float* xb = x + (row - row % S) * L + col;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = __ldg(xb + (int64_t)clamp_to(v[k], S) * L + k);
  }
  reinterpret_cast<float4*>(out)[t] = make_float4(r[0], r[1], r[2], r[3]);
}

constexpr int kStripThreads = 1024;
constexpr int kStripUnroll = 4;                        // pieces in flight
constexpr int kStripSmemMax = 227 * 1024;              // per block, sm_90

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}

template <int W>
__global__ void __launch_bounds__(kStripThreads)
block_take_strip_kernel(const float* __restrict__ x,
                        const int32_t* __restrict__ idx, int L, int S, int R,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float strip[];       // R * W floats
  constexpr int P = W / 4;                             // pieces a row
  const int strips = L / W;
  const int64_t blk = blockIdx.x / strips;
  const int c = (int)(blockIdx.x % strips) * W;
  const int64_t base = blk * S * (int64_t)L + c;       // x[blk * S, c]
  for (int p = threadIdx.x; p < R * P; p += kStripThreads) {
    const int r = p / P, q = p - r * P;
    cp_async16(strip + r * W + q * 4, x + base + (int64_t)r * L + q * 4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int n = S * P;
  for (int p0 = threadIdx.x; p0 < n; p0 += kStripThreads * kStripUnroll) {
    int v[kStripUnroll][4];
    int64_t e[kStripUnroll];
#pragma unroll
    for (int u = 0; u < kStripUnroll; ++u) {
      const int p = p0 + u * kStripThreads;
      const int r = p / P, q = p - r * P;
      e[u] = base + (int64_t)r * L + q * 4;
      if (p < n) load4(idx + e[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kStripUnroll; ++u) {
      const int p = p0 + u * kStripThreads;
      if (p >= n) break;
      const int q = (p % P) * 4;
      float r[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = clamp_to(v[u][k], S);
        r[k] = j < R ? strip[j * W + q + k]
                     : __ldg(x + base + (int64_t)j * L + q + k);
      }
      __stcs(reinterpret_cast<float4*>(out + e[u]),
             make_float4(r[0], r[1], r[2], r[3]));
    }
  }
}

constexpr int kMergeRows = kThreads / 32;             // rows of cand a block
constexpr int kBlockFloats = kMergeRows * 512;         // 16 KB
constexpr int kPieces = kBlockFloats / 4 / kThreads;   // 16-byte copies

__global__ void __launch_bounds__(kThreads)
merge4_kernel(const float* __restrict__ cand, const int32_t* __restrict__ l,
              const int32_t* __restrict__ s, int64_t R,
              float* __restrict__ out) {
  __shared__ __align__(16) float buf[kBlockFloats];
  const int64_t row0 = (int64_t)blockIdx.x * kMergeRows;
  const int64_t base = row0 * 512, end = R * 512;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int off = 4 * (threadIdx.x + i * kThreads);
    if (base + off < end) cp_async16(buf + off, cand + base + off);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int sub = threadIdx.x >> 5;            // the thread's row
  const int col = 4 * (threadIdx.x & 31);      // its first of four lanes
  const int64_t row = row0 + sub;
  int lv[4], sv[4];
  if (row < R) {
    load4(l + row * 128 + col, lv);
    load4(s + row * 128 + col, sv);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (row >= R) return;
  const float* c = buf + sub * 512;
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int sk = sv[k];
    const float v = (sk >= 0 && sk < 4) ? c[sk * 128 + clamp_to(lv[k], 128)]
                                        : 0.f;
    r[k] = __fadd_rn(0.f, v);   // not folded away: -0 becomes +0
  }
  __stcs(reinterpret_cast<float4*>(out + row * 128 + col),
         make_float4(r[0], r[1], r[2], r[3]));
}

template <int Axis>
cudaError_t launch_take(const float* x, const void* idx, int idx_bytes,
                        int64_t n4, int L, int S, float* out,
                        cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n4 + kThreads - 1) / kThreads);
  if (idx_bytes == 4)
    block_take_kernel<Axis, int32_t><<<blocks, kThreads, 0, stream>>>(
        x, static_cast<const int32_t*>(idx), n4, L, S, out);
  else
    block_take_kernel<Axis, int8_t><<<blocks, kThreads, 0, stream>>>(
        x, static_cast<const int8_t*>(idx), n4, L, S, out);
  return cudaGetLastError();
}

// Lets block_take_strip_kernel<W> take up to kStripSmemMax bytes of dynamic
// shared memory, once per device (bit d of the mask: device d).
template <int W>
cudaError_t allow_strip_smem() {
  static std::atomic<uint64_t> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(block_take_strip_kernel<W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStripSmemMax);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int W>
cudaError_t launch_strip(const float* x, const int32_t* idx, int64_t rows,
                         int L, int S, int R, float* out,
                         cudaStream_t stream) {
  const size_t smem = (size_t)R * W * sizeof(float);
  cudaError_t err = allow_strip_smem<W>();
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)(rows / S * (L / W));
  block_take_strip_kernel<W><<<blocks, kStripThreads, smem, stream>>>(
      x, idx, L, S, R, out);
  return cudaGetLastError();
}

}  // namespace

// x, idx: (rows, L) with rows a multiple of S and L a multiple of 4;
// idx_bytes 4 (int32) or 1 (int8); axis 0 or 1.
extern "C" int lux_block_take(const void* x, const void* idx, int64_t rows,
                              int L, int S, int axis, int idx_bytes,
                              void* out, void* stream) {
  const int64_t n4 = rows * L / 4;
  if (n4 == 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto of = static_cast<float*>(out);
  return (int)(axis == 1
                   ? launch_take<1>(xf, idx, idx_bytes, n4, L, S, of, st)
                   : launch_take<0>(xf, idx, idx_bytes, n4, L, S, of, st));
}

// cand: (R, 4, 128) f32; l, s: (R, 128) int32; out: (R, 128) f32; all
// 16-byte aligned.
extern "C" int lux_merge4(const void* cand, const void* l, const void* s,
                          int64_t R, void* out, void* stream) {
  if (R == 0) return (int)cudaSuccess;
  merge4_kernel<<<(unsigned)((R + kMergeRows - 1) / kMergeRows), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const int32_t*>(l),
      static_cast<const int32_t*>(s), R, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Axis 0 through column strips of W (32, 16 or 8) floats, the first R
// rows of each in shared memory: x, idx (int32), out (rows, L) with rows a
// multiple of S, L a multiple of W, all 16-byte aligned, 0 < R <= S and
// R * W * 4 <= 227 KB.
extern "C" int lux_block_take_strip(const void* x, const void* idx,
                                    int64_t rows, int L, int S, int W, int R,
                                    void* out, void* stream) {
  if (rows == 0) return (int)cudaSuccess;
  if (L % W || R < 1 || R > S || (int64_t)R * W * 4 > kStripSmemMax)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto ix = static_cast<const int32_t*>(idx);
  auto of = static_cast<float*>(out);
  switch (W) {
    case 32: return (int)launch_strip<32>(xf, ix, rows, L, S, R, of, st);
    case 16: return (int)launch_strip<16>(xf, ix, rows, L, S, R, of, st);
    case 8: return (int)launch_strip<8>(xf, ix, rows, L, S, R, of, st);
  }
  return (int)cudaErrorInvalidValue;
}
