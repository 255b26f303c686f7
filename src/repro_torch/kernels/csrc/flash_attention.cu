// flash_attention: online-softmax attention over q, k, v [B, H, S, D] with
// one head count, causal and/or a sliding window (keys in (i - w, i]), in
// float32 or bf16, output in q's dtype (K7).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// `flash_attention`: there the grid was (B*H, S/bq) with an inner loop over
// the KV blocks between a causal upper and a window lower bound, the
// running max, sum and accumulator held in VMEM.
//
// What bounds it on an H100: 4 S^2 D H operations per (batch, head) pair
// set (half that causal), which at [1, 16, 4096, 128] is ~69 GFLOP, or
// 0.07 ms at the bf16 tensor-core peak; the bytes (q, k, v read once, the
// output written once) are far less. This first kernel multiplies on the
// CUDA cores in float32, so it is far from that bound; mma/wgmma tiles are
// a later step.
//
// Design: one block per (b*h, tile of BQ = 32 queries), 128 threads; the
// four threads of a query row each hold a quarter of its D (padded to DP,
// 32/64/128/256) in registers as float4 chunks, for q and for the float32
// accumulator. The block loops over tiles of BK = 32 keys from the window's
// lower bound to the causal upper bound (tiles outside them are never
// loaded), staging each K and V tile in shared memory as float32. Per
// tile a thread computes its row's 32 scores (a quarter dot product, then
// two shuffles), masks them (causal, window, S), and folds the tile into
// the running max m, sum l and accumulator with exp2 on log2(e)-scaled
// scores. Rows and keys past S are masked, so S needs no tile multiple.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

constexpr int LANES = 4;                 // threads per query row
constexpr int BQ = 32;                   // query rows per block
constexpr int BK = 32;                   // keys per staged tile
constexpr int THREADS = BQ * LANES;      // 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       T* __restrict__ out, int s, int d, float scale_log2, int causal, int window) {
  constexpr int V4 = DP / 4;             // float4 chunks in a row
  constexpr int C = V4 / LANES;          // float4 chunks a thread holds
  extern __shared__ float4 smem[];
  float4* ks = smem;                     // [BK][V4]
  float4* vs = smem + BK * V4;           // [BK][V4]

  const int lane = threadIdx.x % LANES, row = threadIdx.x / LANES;
  const int q0 = blockIdx.x * BQ, qi = q0 + row;
  const size_t head = (size_t)blockIdx.y * s * d;

  // Chunk c of this thread covers dims 4 * (lane + LANES * c) .. + 3.
  float4 qr[C], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float e[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int dd = 4 * (lane + LANES * c) + t;
      e[t] = (qi < s && dd < d) ? to_f32(q[head + (size_t)qi * d + dd]) : 0.0f;
    }
    qr[c] = make_float4(e[0], e[1], e[2], e[3]);
    acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float m = -INFINITY, l = 0.0f;

  const int hi = causal ? min(s, q0 + BQ) : s;                 // keys < hi
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;     // keys >= lo
  for (int k0 = lo / BK * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    for (int e = threadIdx.x; e < BK * DP; e += THREADS) {
      const int j = e / DP, dd = e % DP;
      float kv = 0.0f, vv = 0.0f;
      if (k0 + j < s && dd < d) {
        const size_t off = head + (size_t)(k0 + j) * d + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      kf[e] = kv;
      vf[e] = vv;
    }
    __syncthreads();

    float sc[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk = ks[j * V4 + lane + LANES * c];
        part = fmaf(qr[c].x, kk.x, part);
        part = fmaf(qr[c].y, kk.y, part);
        part = fmaf(qr[c].z, kk.z, part);
        part = fmaf(qr[c].w, kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool ok = kj < s && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
      sc[j] = ok ? part * scale_log2 : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, tmax);
    if (m_new == -INFINITY) continue;    // no key of this row yet
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha; acc[c].y *= alpha; acc[c].z *= alpha; acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = exp2f(sc[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vs[j * V4 + lane + LANES * c];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (qi >= s) return;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float e[4] = {acc[c].x, acc[c].y, acc[c].z, acc[c].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int dd = 4 * (lane + LANES * c) + t;
      if (dd < d) store(out + head + (size_t)qi * d + dd, e[t] * inv);
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
           int d, float scale, int causal, int window, cudaStream_t stream) {
  const int smem = 2 * BK * DP * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, d, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int s,
             int d, float scale, int causal, int window, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  return launch<T, 256>(q, k, v, out, bh, s, d, scale, causal, window, stream);
}

}  // namespace flash

// Launch on `stream`; returns cudaGetLastError() (0 = launched). q, k, v,
// out: contiguous [bh, s, d] of one dtype (bf16 = 1: __nv_bfloat16, else
// float), d <= 256, bh <= 65535; window <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int bh, int s, int d, float scale,
                                      int causal, int window, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? flash::dispatch<__nv_bfloat16>(q, k, v, out, bh, s, d, scale, causal,
                                               window, st)
              : flash::dispatch<float>(q, k, v, out, bh, s, d, scale, causal, window, st);
}
