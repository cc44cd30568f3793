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
// Design. One thread per 4 consecutive elements of a row (L % 4 == 0): a
// 16-byte (int32) or 4-byte (int8) index load, four gathers through the
// read-only cache, one 16-byte store. A warp covers one 128-wide row, so
// an axis-1 gather touches one 512-byte row of x, and an axis-0 gather the
// S rows of its block, both reused from L1/L2; merge4's warp reads only the
// selected candidate of each element, within its row's 2 KB of cand.

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

__global__ void __launch_bounds__(kThreads)
merge4_kernel(const float* __restrict__ cand, const int32_t* __restrict__ l,
              const int32_t* __restrict__ s, int64_t n4,
              float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n4) return;
  const int64_t e = t * 4;
  const int64_t row = e >> 7;
  int lv[4], sv[4];
  load4(l + e, lv);
  load4(s + e, sv);
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = sv[k];
    const float g = (c >= 0 && c < 4)
        ? __ldg(cand + (row * 4 + c) * 128 + clamp_to(lv[k], 128)) : 0.f;
    r[k] = __fadd_rn(0.f, g);   // not folded away: -0 becomes +0
  }
  reinterpret_cast<float4*>(out)[t] = make_float4(r[0], r[1], r[2], r[3]);
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

// cand: (R, 4, 128) f32; l, s: (R, 128) int32; out: (R, 128) f32.
extern "C" int lux_merge4(const void* cand, const void* l, const void* s,
                          int64_t R, void* out, void* stream) {
  const int64_t n4 = R * 32;
  if (n4 == 0) return (int)cudaSuccess;
  merge4_kernel<<<(unsigned)((n4 + kThreads - 1) / kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cand), static_cast<const int32_t*>(l),
      static_cast<const int32_t*>(s), n4, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
