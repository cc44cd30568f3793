// K1 strip_spmv: the strip-level SpMV of the tiled pull executors, over a
// destination-major cell stream.
//
// Replaces lux_tpu/ops/tiled_spmv.py::strip_level_spmv, jnp/lax code shaped
// for the TPU: a per-chunk broadcast-multiply-reduce over dense (r, 128)
// int8 strips, transposed Z-stream cumsums, boundary gather-diffs and a
// double-single prefix correction, all there to avoid scatters.
//
// Computes the same function: for every destination row of a level,
//   y[row] = sum over the row's nonzero strip cells c of cnt[c] * x[src[c]]
// where src = cols[t] * 128 + lane is the flat index of the cell's source
// vertex in the (nvb, 128) operand x. The host builds the cell stream once
// per plan (ops/tiled_spmv.py::build_level): per row, its cells in strip
// then lane order, with a CSR row pointer over the rows [row0, row0+nrows).
//
// Why not the strips. The TPU wanted dense 128-lane rows for its vector unit,
// so the plan stores (8, 128) int8 strips. At R-MAT 22 they hold 5.6 nonzero
// cells per 1,024 bytes (0.55% dense): streaming them moves 174 bytes per
// edge, 7.66 GB per iteration, 2.3 ms at 3.35 TB/s. A cell takes 5 bytes.
//
// Bound on the H100: bytes. The cells (4 + 1 bytes each) and the row pointer
// (8 bytes per row) are read once, y (4 bytes per row) written once, and the
// distinct source values of x read once: about 0.26 GB, 0.08 ms at R-MAT 22.
// The products are 2 flops per cell, far below the f32 rate. Tensor cores and
// TMA do not apply: the gathers of x are random.
//
// Design.
//   Pass 1: the host cuts each row's cells into work items of at most
//   CELL_ITEM cells (so a hub row, thousands of cells after the degree
//   relabel, spreads over many warps), and G = kGroup threads share an
//   item. The
//   streams are padded to a multiple of 4 cells, so a thread reads 4 cells
//   with one 16-byte load of src and one 4-byte load of cnt, both
//   evict-first (__ldcs: the stream is read once, which keeps the 50 MB L2
//   for x, 16.8 MB at R-MAT 22, whose reads go through the read-only path).
//   Quads are aligned to the stream, not to the item: a thread takes the
//   quads q0 + sub, q0 + sub + G, ... of its item, two per step with both
//   loaded before either is gathered, and masks the cells outside [lo, hi).
//   The G threads then add their sums by shuffles. The gathers of x, one
//   4-byte read of a 32-byte sector per cell (a hub row's neighbouring
//   cells are in different 128-blocks), are what the kernel waits on:
//   items of 1,024 cells with G = 4 came close to the fastest of the
//   shapes tried on the H100 (G 4-32, items 256-1,024, one or two quads a
//   step, or a cell a thread) on one device, on the hub part and on a leaf
//   part at P = 4, and an L2 access-policy window keeping x persisting did
//   not change the time.
//   Pass 2: one thread per row adds its item partials in item order; a row
//   with more than 4 items is added by its whole warp (lanes stride the
//   items, then a fixed shuffle tree), so the rows of a hub part (tens of
//   items each) do not serialise a thread on a chain of L2 reads. It writes y[row0 + row], or adds into it (several levels, or a
//   part's band of a full-height partial).
// Every addition happens in a fixed order, so results are deterministic. No
// atomics, few registers, 256-thread blocks: full occupancy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;      // threads per work item (CELL_GROUP)
constexpr int kLongRow = 4;    // items above which pass 2 takes a warp

// Signed byte b of w, as float (little-endian: byte 0 is the first cell).
__device__ __forceinline__ float byte_at(int w, int b) {
  return (float)((int)((unsigned)w << (24 - 8 * b)) >> 24);
}

// Adds the cells of quad q (cells 4q .. 4q+3) that lie in [lo, hi).
__device__ __forceinline__ float quad_sum(int4 v, int c, const float* x,
                                          int64_t e, int64_t lo, int64_t hi,
                                          float s) {
  if (e >= lo && e + 4 <= hi) {
    const float x0 = __ldg(x + v.x), x1 = __ldg(x + v.y);
    const float x2 = __ldg(x + v.z), x3 = __ldg(x + v.w);
    s = fmaf(byte_at(c, 0), x0, s);
    s = fmaf(byte_at(c, 1), x1, s);
    s = fmaf(byte_at(c, 2), x2, s);
    return fmaf(byte_at(c, 3), x3, s);
  }
  const int idx[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (e + k >= lo && e + k < hi)
      s = fmaf(byte_at(c, k), __ldg(x + idx[k]), s);
  return s;
}

__global__ void __launch_bounds__(kThreads)
cell_items_kernel(const int32_t* __restrict__ src,
                  const int8_t* __restrict__ cnt,
                  const float* __restrict__ x,
                  const int64_t* __restrict__ item_lo, int64_t n_items,
                  float* __restrict__ partial) {
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t item = gid / kGroup;
  const int sub = (int)(gid % kGroup);
  const int4* src4 = reinterpret_cast<const int4*>(src);
  const int* cnt4 = reinterpret_cast<const int*>(cnt);
  float s = 0.f;
  if (item < n_items) {
    const int64_t lo = item_lo[item], hi = item_lo[item + 1];
    int64_t q = (lo >> 2) + sub;
    // Two quads a step, both loaded before either is gathered: 8 gathers
    // in flight per thread.
    for (; 4 * (q + kGroup) < hi; q += 2 * kGroup) {
      const int4 va = __ldcs(src4 + q), vb = __ldcs(src4 + q + kGroup);
      const int ca = __ldcs(cnt4 + q), cb = __ldcs(cnt4 + q + kGroup);
      s = quad_sum(va, ca, x, 4 * q, lo, hi, s);
      s = quad_sum(vb, cb, x, 4 * (q + kGroup), lo, hi, s);
    }
    if (4 * q < hi)
      s = quad_sum(__ldcs(src4 + q), __ldcs(cnt4 + q), x, 4 * q, lo, hi, s);
  }
  // Every thread of the warp reaches the shuffles (no early return).
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (item < n_items && sub == 0) partial[item] = s;
}

__global__ void __launch_bounds__(kThreads)
cell_rows_kernel(const float* __restrict__ partial,
                 const int64_t* __restrict__ row_items, int64_t nrows,
                 int64_t row0, int accumulate, float* __restrict__ y) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int64_t a = 0, b = 0;
  if (row < nrows) {
    a = row_items[row];
    b = row_items[row + 1];
  }
  const bool long_row = b - a > kLongRow;
  float s = 0.f;
  if (!long_row)
    for (int64_t j = a; j < b; ++j) s += partial[j];
  unsigned m = __ballot_sync(0xffffffffu, long_row);
  while (m) {
    const int l = __ffs(m) - 1;
    m &= m - 1;
    const int64_t la = __shfl_sync(0xffffffffu, a, l);
    const int64_t lb = __shfl_sync(0xffffffffu, b, l);
    float t = 0.f;
    for (int64_t j = la + lane; j < lb; j += 32) t += partial[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == l) s = t;
  }
  if (row < nrows) {
    float* out = y + row0 + row;
    *out = accumulate ? *out + s : s;
  }
}

}  // namespace

// src (int32) and cnt (int8): the cell stream, padded to a multiple of 4
// cells, src 16-byte aligned. item_lo: (n_items+1,) cell offsets of the work
// items; row_items: (nrows+1,) item offsets of the rows. y: the level's
// (height,) output, of which rows [row0, row0 + nrows) are written (or added
// into, with accumulate). partial: (n_items,).
extern "C" int lux_strip_spmv(const void* src, const void* cnt,
                              const void* x2d, const void* item_lo,
                              int64_t n_items, const void* row_items,
                              int64_t nrows, int64_t row0, int accumulate,
                              void* partial, void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (n_items > 0) {
    const int64_t blocks = (n_items * kGroup + kThreads - 1) / kThreads;
    cell_items_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const int32_t*>(src), static_cast<const int8_t*>(cnt),
        static_cast<const float*>(x2d), static_cast<const int64_t*>(item_lo),
        n_items, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (nrows == 0) return (int)cudaSuccess;
  const int64_t blocks = (nrows + kThreads - 1) / kThreads;
  cell_rows_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      p, static_cast<const int64_t*>(row_items), nrows, row0, accumulate,
      static_cast<float*>(y));
  return (int)cudaGetLastError();
}
