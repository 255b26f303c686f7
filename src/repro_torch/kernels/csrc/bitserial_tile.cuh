// Tile machinery of the CUDA-core conv kernels (bitserial_conv.cu: K2,
// K5).
//
// A block owns one BM x BN output tile and walks the reduction in chunks
// of BK rows. Per chunk it holds, in shared memory,
//   a[BM][BK+4]  int8 activations (row-major; the +4 pad keeps the
//                 per-thread char4 reads aligned and the row writes
//                 conflict-free), and
//   w[BK][BN]    the chunk's weights folded from the packed planes into
//                 signed int32: w = sum_{p<P-1} b_p 2^p - b_{P-1} 2^{P-1}
//                 (the MSB plane negated: 2's complement, the paper's SIP
//                 negation block), P = Pw (K2); or K5's dense int8
//                 weights, sign-extended.
// Each of the 256 threads accumulates a TM x TN sub-tile in 32-bit
// registers with wrap-around arithmetic, which is the reference's int32
// accumulator.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bitserial {

constexpr int BM = 64;   // output rows (matmul) or output pixels (conv) per tile
constexpr int BN = 32;   // output columns per tile
constexpr int BK = 32;   // reduction rows per chunk: 4 packed bytes per column
constexpr int TM = 4;    // rows per thread
constexpr int TN = 2;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int A_LD = BK + 4;

struct __align__(16) Tile {
  int8_t a[BM][A_LD];
  int32_t w[BK][BN];
};

// Fold the packed bytes of the planes for reduction rows [k0, k0 + BK)
// and columns [n0, n0 + BN) into tile.w. wp is uint8 [pw, k8, n]; byte j of
// a plane holds rows 8j..8j+7, bit i = row 8j+i. Bytes past k8 or columns
// past n fold to zero, so ragged K and N need no other mask on this side.
__device__ __forceinline__ void fold_weights(Tile& t, const uint8_t* __restrict__ wp,
                                             int k8, int n, int pw, int k0, int n0) {
  const int kb0 = k0 / 8;
  for (int e = threadIdx.x; e < (BK / 8) * BN; e += THREADS) {
    const int kb = e / BN, j = e % BN;
    int32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (kb0 + kb < k8 && n0 + j < n) {
      const int32_t sign = 1 << (pw - 1);
      for (int p = 0; p < pw; ++p) {
        const uint32_t byte = wp[((size_t)p * k8 + kb0 + kb) * n + n0 + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] |= (int32_t)((byte >> i) & 1u) << p;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = (v[i] ^ sign) - sign;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) t.w[kb * 8 + i][j] = v[i];
  }
}

// Load rows [k0, k0 + BK) and columns [n0, n0 + BN) of dense int8 weights
// wq [krows, n] into tile.w (K5), zero past krows or n.
__device__ __forceinline__ void load_weights(Tile& t, const int8_t* __restrict__ wq,
                                             int krows, int n, int k0, int n0) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    const int kk = e / BN, j = e % BN;
    int32_t v = 0;
    if (k0 + kk < krows && n0 + j < n) v = wq[(size_t)(k0 + kk) * n + n0 + j];
    t.w[kk][j] = v;
  }
}

// acc[r][c] += sum_k a[ty*TM + r][k] * w[k][tx*TN + c] over one chunk.
__device__ __forceinline__ void accumulate(const Tile& t, uint32_t (&acc)[TM][TN],
                                           int ty, int tx) {
#pragma unroll
  for (int k = 0; k < BK; k += 4) {
    char4 a[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      a[r] = *reinterpret_cast<const char4*>(&t.a[ty * TM + r][k]);
    int2 w[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      w[kk] = *reinterpret_cast<const int2*>(&t.w[k + kk][tx * TN]);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int av[4] = {a[r].x, a[r].y, a[r].z, a[r].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[r][0] += (uint32_t)(av[kk] * w[kk].x);
        acc[r][1] += (uint32_t)(av[kk] * w[kk].y);
      }
    }
  }
}

// Write the first `rows` tile rows to out[(row0 + m) * n + col], masking
// columns past n.
__device__ __forceinline__ void store(int32_t* __restrict__ out,
                                      const uint32_t (&acc)[TM][TN], size_t row0,
                                      int rows, int n0, int n, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = ty * TM + r;
    if (m >= rows) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = n0 + tx * TN + c;
      if (col < n) out[(row0 + m) * n + col] = (int32_t)acc[r][c];
    }
  }
}

}  // namespace bitserial
