// dynamic_quant: per group of G values along K of x f32 [M, K], the absmax,
// scale = max(absmax, tiny) / qmax, xq = clip(round_half_even(x / scale))
// as int8, and the group's effective bits (K6).
//
// Replaces the TPU kernel src/repro/kernels/dynamic_quant.py
// `dynamic_quant`: there a grid step staged a [bm, K] block of rows in
// VMEM and reduced each group along the lanes.
//
// What bounds it on an H100: it reads 4 bytes and writes 1 per value, and
// 8 bytes of scale and bits per group, with a handful of operations per
// value, so it is bound by the bytes: (4 M K + M K + 8 M K/G) / 3.35 TB/s.
//
// Design: one warp per (row, group); the groups of a row are independent,
// so a ragged M needs no mask beyond the last warp. Lane l holds values
// l, l + 32, ... of its group in registers (up to 8 per lane, G <= 256;
// a longer group reads its tail twice), so a group crosses device memory
// once. The absmax and max|xq| are warp-shuffle reductions.
//
// Numerics are the reference's on XLA:CPU, written out because this build
// does not flush subnormals (no -ftz): a subnormal input reads as zero, a
// scale below FLT_MIN is 0.0, 0 / 0 gives 0 and +-x / 0 clips to qmax /
// qmin. The division is IEEE (__fdiv_rn), the rounding half to even
// (rintf). The effective bits come from the integer max|xq| (its bit
// length plus the sign bit, at least 1), which equals the reference's
// ceil(log2(mag + 1)) + 1 with no log2f rounding to worry about.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace dynamic_quant {

constexpr int WARPS = 8;     // warps (groups) per block
constexpr int CACHED = 8;    // values a lane keeps in registers

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? 0.0f : v;
}

__device__ __forceinline__ int quantize(float v, float scale, int qmin, int qmax) {
  const float r = rintf(__fdiv_rn(v, scale));
  if (isnan(r)) return 0;                      // 0 / 0
  return (int)fminf(fmaxf(r, (float)qmin), (float)qmax);
}

__global__ void __launch_bounds__(WARPS * 32)
kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
       float* __restrict__ scale_out, int32_t* __restrict__ eff_out, int m,
       int k, int g, int bits) {
  const int lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int groups = k / g;
  if (item >= (long long)m * groups) return;   // whole warps leave together
  const size_t base = (size_t)(item / groups) * k + (size_t)(item % groups) * g;
  const float* src = x + base;

  float cache[CACHED];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < CACHED; ++j) {
    const int e = lane + 32 * j;
    cache[j] = e < g ? flush(src[e]) : 0.0f;
    amax = fmaxf(amax, fabsf(cache[j]));
  }
  for (int e = lane + 32 * CACHED; e < g; e += 32) amax = fmaxf(amax, fabsf(flush(src[e])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const int qmax = (1 << (bits - 1)) - 1, qmin = -(1 << (bits - 1));
  const float scale = flush(__fdiv_rn(fmaxf(amax, FLT_MIN), (float)qmax));
  int mag = 0;
#pragma unroll
  for (int j = 0; j < CACHED; ++j) {
    const int e = lane + 32 * j;
    if (e < g) {
      const int v = quantize(cache[j], scale, qmin, qmax);
      xq[base + e] = (int8_t)v;
      mag = max(mag, abs(v));
    }
  }
  for (int e = lane + 32 * CACHED; e < g; e += 32) {
    const int v = quantize(flush(src[e]), scale, qmin, qmax);
    xq[base + e] = (int8_t)v;
    mag = max(mag, abs(v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mag = max(mag, __shfl_xor_sync(0xffffffffu, mag, off));
  if (lane == 0) {
    scale_out[item] = scale;
    eff_out[item] = (32 - __clz(mag)) + 1;    // bit length + sign; mag 0 -> 1
  }
}

}  // namespace dynamic_quant

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
// x f32 [m, k] -> xq int8 [m, k], scale f32 [m, k/g], eff int32 [m, k/g];
// k % g == 0 and 2 <= bits <= 8 are the caller's to check.
extern "C" int dynamic_quant_launch(const void* x, void* xq, void* scale, void* eff,
                                    int m, int k, int g, int bits, void* stream) {
  const long long items = (long long)m * (k / g);
  const unsigned blocks =
      (unsigned)((items + dynamic_quant::WARPS - 1) / dynamic_quant::WARPS);
  dynamic_quant::kernel<<<blocks, dynamic_quant::WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(scale), static_cast<int32_t*>(eff), m, k, g, bits);
  return static_cast<int>(cudaGetLastError());
}
