// bitserial_conv: fused "same"-padded convolution over packed weight planes.
// x int8 NHWC [B, H, W, C], weights uint8 [Pw, ceil(k*k*C/8), N] in the
// (di, dj, c) row order of pack_weights -> exact int32 [B, Ho, Wo, N],
// Ho = ceil(H/s), Wo = ceil(W/s); odd k, stride 1 or 2.
//
// Replaces the TPU kernel src/repro/kernels/bitserial_conv.py
// `bitserial_conv` (K2): an implicit im2col over output-row bands, the
// band staged in VMEM, all Pw planes handled per grid step.
//
// What bounds it on an H100: at the paper CNN's shapes the int32 output
// dominates the bytes (conv1 at B = 256 writes 33.5 MB), so the bound is
// the bytes; the k*k*C-deep products are small. This first kernel
// multiplies on the CUDA cores, not the tensor cores, so its arithmetic
// rather than the output bytes is what it waits on.
//
// Design: block (tile, band, image) stages its band of input rows -- the
// halo included, zero for the "same" padding -- from device memory into
// shared memory once, coalesced. Then, per BM-pixel tile of the band and
// per BK-row chunk of the reduction, it gathers the patch values straight
// from that band into the tile (the implicit im2col: no patch tensor is
// ever written to device memory, the paper's bandwidth law), with zero for
// the K8 pad rows >= k*k*C, and folds all Pw planes of the chunk into
// signed weights (bitserial_tile.cuh). rows_per_band only sets how the map
// is cut into blocks and how large the staged band is; every output is the
// same sum in any cut, so it never changes a bit of the result.
#include "bitserial_tile.cuh"

namespace bitserial {

__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
            int32_t* __restrict__ out, int h, int w, int c, int n, int kernel,
            int stride, int pw, int rpb, int ho, int wo) {
  extern __shared__ __align__(16) int8_t band[];   // [band_rows][wpad][c]
  __shared__ Tile tile;
  __shared__ int pix_off[BM];   // band offset of each tile pixel's window, -1 = none
  __shared__ int k_off[BK];     // band offset of each chunk row (di, dj, c), -1 = pad row

  const int pad = kernel / 2, wpad = w + 2 * pad;
  const int band_rows = (rpb - 1) * stride + kernel;
  const int b = blockIdx.z, bi = blockIdx.y, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);

  const int row_bytes = wpad * c;
  const int r_in0 = bi * rpb * stride - pad;
  for (int e = threadIdx.x; e < band_rows * row_bytes; e += THREADS) {
    const int r = e / row_bytes, rem = e % row_bytes;
    const int col = rem / c - pad, ch = rem % c;
    const int gr = r_in0 + r;
    int8_t v = 0;
    if (gr >= 0 && gr < h && col >= 0 && col < w)
      v = x[(((size_t)b * h + gr) * w + col) * c + ch];
    band[e] = v;
  }

  const int kkc = kernel * kernel * c, k8 = (kkc + 7) / 8;
  const int band_px = min(rpb, ho - bi * rpb) * wo;
  const size_t row0 = ((size_t)b * ho + (size_t)bi * rpb) * wo;
  for (int p0 = 0; p0 < band_px; p0 += BM) {
    uint32_t acc[TM][TN] = {};
    for (int k0 = 0; k0 < k8 * 8; k0 += BK) {
      if (threadIdx.x < BK) {
        const int kk = k0 + threadIdx.x;
        int off = -1;
        if (kk < kkc) {
          const int di = kk / (kernel * c), rem = kk % (kernel * c);
          off = (di * wpad + rem / c) * c + rem % c;
        }
        k_off[threadIdx.x] = off;
      } else if (threadIdx.x < BK + BM) {
        const int m = threadIdx.x - BK, p = p0 + m;
        int off = -1;
        if (p < band_px) off = ((p / wo) * stride * wpad + (p % wo) * stride) * c;
        pix_off[m] = off;
      }
      __syncthreads();   // offsets ready; on the first chunk also the band
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int po = pix_off[r], ko = k_off[kk];
        tile.a[r][kk] = (po >= 0 && ko >= 0) ? band[po + ko] : int8_t(0);
      }
      fold_weights(tile, wp, k8, n, pw, k0, n0);
      __syncthreads();
      accumulate(tile, acc, ty, tx);
      __syncthreads();
    }
    store(out, acc, row0 + p0, min(BM, band_px - p0), n0, n, ty, tx);
  }
}

}  // namespace bitserial

// Launch on `stream`; returns cudaGetLastError() (0 = launched). The
// dynamic shared memory is the staged band: ((rpb-1)*stride + k) rows of
// (W + 2*(k/2)) * C bytes (conv_smem_bytes in bitserial_conv.py adds the
// static tile to it).
extern "C" int bitserial_conv_launch(const void* x, const void* wp, void* out,
                                     int b, int h, int w, int c, int n,
                                     int kernel, int stride, int pw, int rpb,
                                     void* stream) {
  using namespace bitserial;
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  const int band_rows = (rpb - 1) * stride + kernel;
  const size_t smem = (size_t)band_rows * (w + 2 * (kernel / 2)) * c;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + BN - 1) / BN, (ho + rpb - 1) / rpb, b);
  conv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(wp),
      static_cast<int32_t*>(out), h, w, c, n, kernel, stride, pw, rpb, ho, wo);
  return static_cast<int>(cudaGetLastError());
}
