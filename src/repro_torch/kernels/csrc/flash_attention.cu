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
// 0.07 ms at the bf16 tensor-core peak (989 TFLOP/s); the bytes (q, k, v
// read once, the output written once) are far less. So the bf16 route
// must run on the tensor cores and keep them fed from shared memory.
// On an NVIDIA H100 80GB HBM3 at 700 W, a first mma.sync.m16n8k16 version
// (4 warps of 16 rows, ldmatrix) ran [1, 16, 4096, 128] causal in 0.53 ms;
// wgmma with three warpgroups and the pipeline below in 0.41 ms.
//
// Two routes, chosen by dtype (an explicit dispatch, not a fallback):
//
// bf16 -- `tc_kernel`, FlashAttention-2 style on warpgroup products
//   (wgmma m64nNk16, bf16 x bf16 -> f32). One block per (b*h, tile of
//   64 x WGS queries): WGS = 3 warpgroups (2 at D = 256, where three would
//   spill), each owning 64 query rows, share the K and V tiles. Q is
//   staged once; K and V tiles of BK = 64 keys (32 at D = 256) are staged
//   as bf16 by cp.async into a ring of three, in the no-swizzle core-matrix
//   layout the wgmma descriptors read. S = Q K^T runs from shared memory
//   (both operands K-major) into f32 accumulator fragments; the online
//   softmax works on them with exp2 of scores scaled by scale * log2(e).
//   P feeds P V from registers as the A operand, V read transposed from
//   shared memory, split into two bf16 parts, P = P_hi + P_lo: one bf16
//   rounding of P (2^-9 of each probability) moves outputs near zero by
//   more than the 1e-4 + 2^-7 |out| the route is held to (thousands of
//   elements at S = 512 and 4096); the split keeps P to ~16 bits for one
//   more product per tile. The loop is software-pipelined as in
//   FlashAttention-3: tile i's softmax runs while P V of tile i - 1 is on
//   the tensor cores, and tile i + 2 loads. Key tiles outside the causal
//   and window bounds are never loaded; only a tile that crosses the
//   diagonal, the window's edge or S is masked element by element. Rows
//   and keys past S and dims past D (padded to 32/64/128/256) are
//   zero-filled, so S needs no tile multiple. Blocks run the longest
//   causal rows first. It reaches about a quarter of the tensor-core peak
//   (PERF.md).
//
// float32 -- `simt_kernel`, float32 FMAs on the CUDA cores: TF32 tensor
//   cores would break the route's 2e-5 tolerance. One block per (b*h, 32
//   queries), four threads per query row each holding a quarter of its D
//   in registers; K and V tiles of 32 keys staged in shared memory.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

namespace flash {

constexpr int LANES = 4;                 // threads per query row
constexpr int BQ = 32;                   // query rows per block
constexpr int BK = 32;                   // keys per staged tile
constexpr int THREADS = BQ * LANES;      // 128

template <int DP>
__global__ void __launch_bounds__(THREADS)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int s, int d,
            float scale_log2, int causal, int window) {
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
      e[t] = (qi < s && dd < d) ? q[head + (size_t)qi * d + dd] : 0.0f;
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
        kv = k[off];
        vv = v[off];
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
      if (dd < d) out[head + (size_t)qi * d + dd] = e[t] * inv;
    }
  }
}

namespace tca {

template <int DP>
struct Shape {
  // Warpgroups per block, 64 query rows each (warp w owns rows 16w..16w+15):
  // 3 where their registers fit (3 beat 1 and 2 on the card), 2 at D = 256.
  static constexpr int WGS = DP == 256 ? 2 : 3;
  static constexpr int BQ = 64 * WGS;               // query rows per block
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BK = DP == 256 ? 32 : 64;   // keys per staged tile
  static constexpr int GSTR = DP / 8 * 128;         // bytes between 8-row groups
  static constexpr int SMEM = (BQ + 6 * BK) * DP * 2;   // Q, 3 x (K, V)
};

// Stage rows [r0, r0 + rows) of a [s, d] bf16 matrix into shared memory as
// 8 x 8 core matrices (the wgmma no-swizzle layout): element (r, c) at byte
// (r / 8 * DP / 8 + c / 8) * 128 + r % 8 * 16 + c % 8 * 2. Zeros past s and
// past d. `vec`: d % 8 == 0 and 16-byte aligned rows, so every 8-element
// chunk is one cp.async; else the ragged chunks are copied element by
// element.
template <int DP>
__device__ __forceinline__ void stage(unsigned char* dst, const __nv_bfloat16* src, int r0,
                                      int rows, int s, int d, bool vec) {
  constexpr int CH = DP / 8;             // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += Shape<DP>::THREADS) {
    const int r = e / CH, c = e % CH, gr = r0 + r, c0 = 8 * c;
    __nv_bfloat16* to =
        reinterpret_cast<__nv_bfloat16*>(dst + (r / 8 * CH + c) * 128 + r % 8 * 16);
    const __nv_bfloat16* from = src + (size_t)gr * d + c0;
    const bool ok = gr < s && c0 < d;
    if (vec || !ok) {
      tc::cp_async16(to, ok ? from : src, ok ? 16 : 0);
    } else {
      for (int j = 0; j < 8; ++j) to[j] = c0 + j < d ? from[j] : __float2bfloat16_rn(0.0f);
    }
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int DP>
__global__ void __launch_bounds__(Shape<DP>::THREADS)
tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int s, int d,
          float scale_log2, int causal, int window) {
  using S = Shape<DP>;
  constexpr int BQ = S::BQ, BK = S::BK, GSTR = S::GSTR, NT = BK / 8, DT = DP / 8;
  constexpr int TILE_K = BK * DP * 2;    // bytes of a staged K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* qs = smem_raw;                    // [BQ x DP] core matrices
  unsigned char* ks = qs + BQ * DP * 2;            // [3][BK x DP] ring
  unsigned char* vs = ks + 3 * TILE_K;             // [3][BK x DP] ring

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest causal rows first
  const size_t head = (size_t)blockIdx.y * s * d;
  const __nv_bfloat16 *qh = q + head, *kh = k + head, *vh = v + head;
  const bool vec = d % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                   reinterpret_cast<uintptr_t>(v)) % 16) == 0;

  const int hi = causal ? min(s, q0 + BQ) : s;                 // keys < hi
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;     // keys >= lo
  const int t0 = lo / BK;
  const int nt = (hi + BK - 1) / BK - t0;

  // Prologue: Q and the first two key tiles, then S of the first.
  stage<DP>(qs, qh, q0, BQ, s, d, vec);
  stage<DP>(ks, kh, t0 * BK, BK, s, d, vec);
  stage<DP>(vs, vh, t0 * BK, BK, s, d, vec);
  if (nt > 1) {
    stage<DP>(ks + TILE_K, kh, (t0 + 1) * BK, BK, s, d, vec);
    stage<DP>(vs + TILE_K, vh, (t0 + 1) * BK, BK, s, d, vec);
  }
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  tc::fence_proxy_async();
  __syncthreads();
  const unsigned char* qw = qs + warp / 4 * 8 * GSTR;   // this warpgroup's 64 rows

  float acc[DP / 2];                     // O: acc[4j + e], columns 8j..8j+7
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
  float sc[BK / 2];                      // S of this tile: sc[4n + e], keys 8n..8n+7
  tc::fence_regs(sc);
  tc::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    tc::wgmma_bf16_ss(sc, tc::desc(qw + kc * 256, 128, GSTR), tc::desc(ks + kc * 256, 128, GSTR),
                      kc);
  tc::wgmma_commit();
  tc::wgmma_wait<0>();
  tc::fence_regs(sc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int r0 = q0 + warp * 16 + g;     // this thread's rows: r0, r0 + 8

  // Tile it's softmax runs while P V of tile it - 1 is on the tensor cores;
  // O is rescaled, and P written into the registers that product reads,
  // only when no product is in flight (ptxas serializes the wgmmas if O is
  // touched earlier); then S of tile it + 1 and P V of tile it are issued
  // together, and tile it + 2 loads into the ring's third slot. The wgmma
  // schedule is the same in every iteration (the last one's S of a tile
  // past the end is computed and dropped).
  for (int it = 0; it < nt; ++it) {
    // Scale to log2 units; mask only a tile that crosses S, the diagonal or
    // the window's edge.
    const int k0 = (t0 + it) * BK;
    const bool edge = k0 + BK > s || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * n + e] * scale_log2;
        if (edge) {
          const int kj = k0 + 8 * n + 2 * t + (e & 1), qi = r0 + 8 * (e >> 1);
          const bool ok = kj < s && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
          if (!ok) x = -INFINITY;
        }
        sc[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      mu[r] = mn == -INFINITY ? 0.0f : mn;            // no key of this row yet
      alpha[r] = exp2f(m[r] - mu[r]);
      l[r] *= alpha[r];
      m[r] = mn;
    }

    // P in float32, in place of S.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = exp2f(sc[i] - mu[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }

    // P V of tile it - 1 is done: rescale O, and only now overwrite the
    // registers that product read P from: P = P_hi + P_lo in bf16, the
    // register A operand of P V.
    tc::wgmma_wait<0>();
    tc::fence_regs(acc);
    tc::fence_regs(sc);                  // P's packing stays after the wait
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p0 = sc[4 * (2 * kc + h) + 2 * r];
          const float p1 = sc[4 * (2 * kc + h) + 2 * r + 1];
          const __nv_bfloat162 hi2 = __floats2bfloat162_rn(p0, p1);
          ph[kc][2 * h + r] = bits(hi2);
          pl[kc][2 * h + r] = bits(__floats2bfloat162_rn(p0 - __low2float(hi2),
                                                         p1 - __high2float(hi2)));
        }
      }
    }
    tc::cp_async_wait<0>();              // tile it + 1 landed (loaded one iteration ago)
    tc::fence_proxy_async();
    __syncthreads();                     // ... for all; every warpgroup is done with it - 1
    if (it + 2 < nt) {
      stage<DP>(ks + (it + 2) % 3 * TILE_K, kh, (t0 + it + 2) * BK, BK, s, d, vec);
      stage<DP>(vs + (it + 2) % 3 * TILE_K, vh, (t0 + it + 2) * BK, BK, s, d, vec);
      tc::cp_async_commit();
    }

    // S of tile it + 1, then O += P V of tile it, 16 keys at a time (V read
    // transposed: dims contiguous).
    float sn[BK / 2];                    // the first product sets it
    const unsigned char* kn = ks + (it + 1) % 3 * TILE_K;
    const unsigned char* vt = vs + it % 3 * TILE_K;
    tc::fence_regs(sn);
    tc::fence_regs(acc);
    tc::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      tc::wgmma_bf16_ss(sn, tc::desc(qw + kc * 256, 128, GSTR),
                        tc::desc(kn + kc * 256, 128, GSTR), kc);
    tc::wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint64_t dv = tc::desc(vt + kc * 2 * GSTR, GSTR, 128);
      tc::wgmma_bf16_rs_tb(acc, ph[kc], dv);
      tc::wgmma_bf16_rs_tb(acc, pl[kc], dv);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();                 // S of tile it + 1 is done
    tc::fence_regs(sn);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = sn[i];
  }
  tc::wgmma_wait<0>();
  tc::fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = r0 + 8 * (e >> 1), dd = 8 * j + 2 * t + (e & 1);
      if (qi < s && dd < d)
        out[head + (size_t)qi * d + dd] = __float2bfloat16_rn(acc[4 * j + e] * inv[e >> 1]);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s, int d,
           float scale, int causal, int window, cudaStream_t stream) {
  using S = Shape<DP>;
  cudaError_t err = cudaFuncSetAttribute(tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + S::BQ - 1) / S::BQ, bh);
  tc_kernel<DP><<<grid, S::THREADS, S::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s, d,
      scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tca

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s,
           int d, float scale, int causal, int window, cudaStream_t stream) {
  const int smem = 2 * BK * DP * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      simt_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, bh);
  simt_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), s, d, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* out, int bh, int s,
                 int d, float scale, int causal, int window, cudaStream_t stream) {
  if (d <= 32) return launch<32>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  if (d <= 64) return launch<64>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  if (d <= 128) return launch<128>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  return launch<256>(q, k, v, out, bh, s, d, scale, causal, window, stream);
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* out, int bh, int s,
                  int d, float scale, int causal, int window, cudaStream_t stream) {
  if (d <= 32) return tca::launch<32>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  if (d <= 64) return tca::launch<64>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  if (d <= 128) return tca::launch<128>(q, k, v, out, bh, s, d, scale, causal, window, stream);
  return tca::launch<256>(q, k, v, out, bh, s, d, scale, causal, window, stream);
}

}  // namespace flash

// Launch on `stream`; returns cudaGetLastError() (0 = launched). q, k, v,
// out: contiguous [bh, s, d] of one dtype (bf16 = 1: __nv_bfloat16 on the
// tensor-core route, else float on the CUDA-core route), d <= 256,
// bh <= 65535; window <= 0 means none.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int bh, int s, int d, float scale,
                                      int causal, int window, int bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? flash::dispatch_bf16(q, k, v, out, bh, s, d, scale, causal, window, st)
              : flash::dispatch_f32(q, k, v, out, bh, s, d, scale, causal, window, st);
}
