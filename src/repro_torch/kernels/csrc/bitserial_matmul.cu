// bitserial_matmul: x int8 [M, K] @ packed weights uint8 [Pw, K/8, N]
// -> exact int32 [M, N] (K1), and bitserial_matmul_dynamic, the same with
// column group j = [j*bn, (j+1)*bn) running only its first counts[j]
// planes (K3).
//
// Replaces the TPU kernels src/repro/kernels/bitserial_matmul.py
// `bitserial_matmul` (K1) and `bitserial_matmul_dynamic` (K3). There the
// serial plane loop was the innermost grid axis: one int8 MXU pass per
// plane, shifted by 2^p, the MSB plane negated; K3 skipped the grid steps
// of planes >= the N-tile's scalar-prefetched count, plane count-1
// negated.
//
// What bounds it on an H100: at the paper CNN's FC shapes (M = 256,
// K <= 2048, N <= 256) the function moves ~1.3 MB and does ~0.27 GOP, so
// its bound is the bytes (well under a microsecond). This first kernel
// does not reach that bound: it multiplies on the CUDA cores, not the
// tensor cores, and the small grid (ceil(M/64) x ceil(N/32) blocks)
// leaves most SMs idle.
//
// Design: instead of Pw passes, each block folds the packed planes of its
// chunk into signed weights in shared memory once (bitserial_tile.cuh),
// so the inner loop is one int8 x int32 multiply-add per term whatever Pw
// is, and the weights still cross device memory bit-packed (Pw/16 of the
// 16-bit baseline: the paper's bandwidth law). K3 is the same kernel with
// a per-column plane count: the fold reads counts[col / bn] and loads only
// the bytes of planes below it, so a trimmed group moves count/Pw of the
// bytes. The dynamic serving linear calls it transposed, the packed
// operand being the runtime-packed activations (bn = the row group); the
// static weight-group route calls it with the pack-time counts (bn = the
// filter group). M, N and K need not divide the tile: every edge is masked
// here, a ragged last column group included (K must be a multiple of 8,
// the pack layout's row quantum).
#include "bitserial_tile.cuh"

namespace bitserial {

template <bool kCounts>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
              const int32_t* __restrict__ counts, int32_t* __restrict__ out,
              int m, int k, int n, int pw, int bn) {
  __shared__ Tile tile;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  uint32_t acc[TM][TN] = {};
  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int r = e / BK, kk = e % BK;
      int8_t v = 0;
      if (m0 + r < m && k0 + kk < k) v = x[(size_t)(m0 + r) * k + k0 + kk];
      tile.a[r][kk] = v;
    }
    fold_weights(tile, wp, k / 8, n, pw, k0, n0, kCounts ? counts : nullptr, bn);
    __syncthreads();
    accumulate(tile, acc, ty, tx);
    __syncthreads();
  }
  store(out, acc, m0, min(BM, m - m0), n0, n, ty, tx);
}

template <bool kCounts>
int launch(const void* x, const void* wp, const void* counts, void* out, int m,
           int k, int n, int pw, int bn, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  matmul_kernel<kCounts><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(out), m, k, n,
      pw, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bitserial

// Launch on `stream`; each returns cudaGetLastError() (0 = launched).
extern "C" int bitserial_matmul_launch(const void* x, const void* wp, void* out,
                                       int m, int k, int n, int pw, void* stream) {
  return bitserial::launch<false>(x, wp, nullptr, out, m, k, n, pw, 1, stream);
}

// counts: int32 [ceil(n / bn)], each in [1, pw].
extern "C" int bitserial_matmul_dynamic_launch(const void* x, const void* wp,
                                               const void* counts, void* out,
                                               int m, int k, int n, int pw,
                                               int bn, void* stream) {
  return bitserial::launch<true>(x, wp, counts, out, m, k, n, pw, bn, stream);
}
