// K3 level_apply: one level of the grouped (merge-network) tail.
//
// Replaces the Pallas kernel lux_tpu/ops/merge_tail_kernel.py::
// level_apply_pallas (body _k_level): a grid over output rows whose
// (1, 128) input blocks are chosen by scalar-prefetched row offsets.
//
// Computes, for each output row o and lane j, with c = codes[o, j] (int8):
//   out[o, j] = x[arow[o], c & 127]   if c >= 0
//               x[brow[o], c & 127]   otherwise
// It only moves data, so it is bitwise equal to its plain version.
//
// Bound on the H100: bytes — per output row 128 bytes of codes, 8 bytes of
// offsets and 512 bytes written, plus the input rows it reads (512 bytes
// each, once per input row that is read at all); no arithmetic.
//
// Design. One warp per output row, 8 rows per block. The warp stages the
// two 512-byte input rows in shared memory with coalesced float4 loads (one
// row when arow == brow, a copy row), then each thread takes 4 lanes: one
// char4 of codes, four shared-memory reads, one float4 store. Level 0 reads
// the (nvb, 128) value operand; later levels read the previous level's
// stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float pick(const float* ra, const float* rb,
                                      signed char c) {
  return (c >= 0 ? ra : rb)[c & 127];
}

__global__ void __launch_bounds__(32 * kRowsPerBlock)
level_apply_kernel(const float* __restrict__ x,
                   const int32_t* __restrict__ arow,
                   const int32_t* __restrict__ brow,
                   const int8_t* __restrict__ codes, int64_t S,
                   float* __restrict__ out) {
  __shared__ float4 stage[kRowsPerBlock][2][32];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int64_t o = (int64_t)blockIdx.x * kRowsPerBlock + w;
  if (o >= S) return;                          // uniform across the warp
  const int a = __ldg(arow + o), b = __ldg(brow + o);
  stage[w][0][l] =
      __ldg(reinterpret_cast<const float4*>(x + (int64_t)a * 128) + l);
  if (b != a)
    stage[w][1][l] =
        __ldg(reinterpret_cast<const float4*>(x + (int64_t)b * 128) + l);
  const char4 c = __ldcs(reinterpret_cast<const char4*>(codes + o * 128) + l);
  __syncwarp();
  const float* ra = reinterpret_cast<const float*>(stage[w][0]);
  const float* rb = reinterpret_cast<const float*>(stage[w][b != a ? 1 : 0]);
  float4 r;
  r.x = pick(ra, rb, c.x);
  r.y = pick(ra, rb, c.y);
  r.z = pick(ra, rb, c.z);
  r.w = pick(ra, rb, c.w);
  reinterpret_cast<float4*>(out + o * 128)[l] = r;
}

}  // namespace

extern "C" int lux_level_apply(const void* x, const void* arow,
                               const void* brow, const void* codes, int64_t S,
                               void* out, void* stream) {
  if (S == 0) return (int)cudaSuccess;
  const int64_t blocks = (S + kRowsPerBlock - 1) / kRowsPerBlock;
  level_apply_kernel<<<(unsigned)blocks, 32 * kRowsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(arow),
      static_cast<const int32_t*>(brow), static_cast<const int8_t*>(codes), S,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
