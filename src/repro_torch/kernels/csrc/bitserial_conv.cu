// bitserial_conv: fused "same"-padded convolution, x int8 NHWC
// [B, H, W, C] -> exact int32 [B, Ho, Wo, N], Ho = ceil(H/s),
// Wo = ceil(W/s); odd k, stride >= 1. Three entry points share one kernel:
//   K2 bitserial_conv         weights uint8 [Pw, ceil(k*k*C/8), N] packed
//                             in the (di, dj, c) row order of pack_weights;
//   K4 bitserial_conv_wgroup  the same, filter group g = channels
//                             [g*w_group, (g+1)*w_group) running only its
//                             first counts[g] weight planes;
//   K5 bitserial_conv_dynamic dense int8 weights [K8, N] (K8 = k*k*C
//                             rounded up to 8), window p of image b with
//                             its activations truncated at the plane count
//                             counts[b, p / group] of its window group.
//
// Replaces the TPU kernels src/repro/kernels/bitserial_conv.py
// `bitserial_conv` (K2: an implicit im2col over output-row bands, the band
// staged in VMEM, all Pw planes per grid step), `bitserial_conv_wgroup`
// (K4: a serial weight-plane grid axis gated per filter group by scalar-
// prefetched counts) and `bitserial_conv_dynamic` (K5: a serial
// activation-plane grid axis gated per window group, dense int8 weights,
// bands aligned to the window groups).
//
// What bounds them on an H100: at the paper CNN's shapes the int32 output
// dominates the bytes (conv1 at B = 256 writes 33.5 MB), so the bound is
// the bytes; the k*k*C-deep products are small. These first kernels
// multiply on the CUDA cores, not the tensor cores, so their arithmetic
// rather than the output bytes is what they wait on.
//
// Design: block (tile, band, image) stages its band of input rows -- the
// halo included, zero for the "same" padding -- from device memory into
// shared memory once, coalesced. Then, per BM-pixel tile of the band and
// per BK-row chunk of the reduction, it gathers the patch values straight
// from that band into the tile (the implicit im2col: no patch tensor is
// ever written to device memory, the paper's bandwidth law), with zero for
// the K8 pad rows >= k*k*C, and fills the weight tile (bitserial_tile.cuh):
// K2 folds all Pw planes of the chunk into signed weights; K4 folds each
// column's first count planes only, so a trimmed filter group never loads
// the bytes of its dead planes; K5 loads its dense int8 weights and
// truncates each gathered activation at its window's count, 2's complement
// at that width, which is what executing count activation planes with
// plane count-1 negated computes. Where the TPU ran one MXU pass per plane,
// a term here costs one multiply-add whatever the count. rows_per_band
// only sets how the map is cut into blocks and how large the staged band
// is; every output is the same sum in any cut, so it never changes a bit
// of the result (K5's window groups are looked up per pixel, so its bands
// need not align with them).
#include "bitserial_tile.cuh"

namespace bitserial {

enum Mode { kStatic, kWGroup, kDynamic };

// 2's-complement truncation of v at c in [1, 8] bits.
__device__ __forceinline__ int8_t truncate_signed(int8_t v, int c) {
  const int low = v & ((1 << c) - 1);
  return static_cast<int8_t>(low - (((low >> (c - 1)) & 1) << c));
}

template <int kMode>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const int8_t* __restrict__ x, const void* __restrict__ wts,
            const int32_t* __restrict__ counts, int32_t* __restrict__ out,
            int h, int w, int c, int n, int kernel, int stride, int pw, int rpb,
            int ho, int wo, int group, int ngroups) {
  extern __shared__ __align__(16) int8_t band[];   // [band_rows][wpad][c]
  __shared__ Tile tile;
  __shared__ int pix_off[BM];   // band offset of each tile pixel's window, -1 = none
  __shared__ int k_off[BK];     // band offset of each chunk row (di, dj, c), -1 = pad row
  __shared__ int pix_cnt[kMode == kDynamic ? BM : 1];   // K5: each pixel's plane count

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
        if (kMode == kDynamic && p < band_px)   // window (bi*rpb*wo + p) of image b
          pix_cnt[m] = max(1, min(counts[(size_t)b * ngroups + (bi * rpb * wo + p) / group], 8));
      }
      __syncthreads();   // offsets ready; on the first chunk also the band
      for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;
        const int po = pix_off[r], ko = k_off[kk];
        int8_t v = 0;
        if (po >= 0 && ko >= 0) {
          v = band[po + ko];
          if (kMode == kDynamic) v = truncate_signed(v, pix_cnt[r]);
        }
        tile.a[r][kk] = v;
      }
      if (kMode == kDynamic)
        load_weights(tile, static_cast<const int8_t*>(wts), k8 * 8, n, k0, n0);
      else
        fold_weights(tile, static_cast<const uint8_t*>(wts), k8, n, pw, k0, n0,
                     kMode == kWGroup ? counts : nullptr, group);
      __syncthreads();
      accumulate(tile, acc, ty, tx);
      __syncthreads();
    }
    store(out, acc, row0 + p0, min(BM, band_px - p0), n0, n, ty, tx);
  }
}

// The dynamic shared memory is the staged band: ((rpb-1)*stride + k) rows
// of (W + 2*(k/2)) * C bytes (conv_smem_bytes in bitserial_conv.py adds
// the static tiles to it).
template <int kMode>
int launch(const void* x, const void* wts, const void* counts, void* out, int b,
           int h, int w, int c, int n, int kernel, int stride, int pw, int rpb,
           int group, int ngroups, void* stream) {
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  const int band_rows = (rpb - 1) * stride + kernel;
  const size_t smem = (size_t)band_rows * (w + 2 * (kernel / 2)) * c;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + BN - 1) / BN, (ho + rpb - 1) / rpb, b);
  conv_kernel<kMode><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), wts, static_cast<const int32_t*>(counts),
      static_cast<int32_t*>(out), h, w, c, n, kernel, stride, pw, rpb, ho, wo,
      group, ngroups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bitserial

// Launch on `stream`; each returns cudaGetLastError() (0 = launched).
extern "C" int bitserial_conv_launch(const void* x, const void* wp, void* out,
                                     int b, int h, int w, int c, int n,
                                     int kernel, int stride, int pw, int rpb,
                                     void* stream) {
  return bitserial::launch<bitserial::kStatic>(x, wp, nullptr, out, b, h, w, c, n,
                                               kernel, stride, pw, rpb, 1, 1, stream);
}

// counts: int32 [ceil(n / w_group)], each in [1, pw].
extern "C" int bitserial_conv_wgroup_launch(const void* x, const void* wp,
                                            const void* counts, void* out, int b,
                                            int h, int w, int c, int n, int kernel,
                                            int stride, int pw, int rpb,
                                            int w_group, void* stream) {
  return bitserial::launch<bitserial::kWGroup>(x, wp, counts, out, b, h, w, c, n,
                                               kernel, stride, pw, rpb, w_group, 1,
                                               stream);
}

// wq: int8 [K8, n]; counts: int32 [b, ngroups], each in [1, 8], window
// (ho_i * Wo + wo_i) of image b in group (ho_i * Wo + wo_i) / group.
extern "C" int bitserial_conv_dynamic_launch(const void* x, const void* wq,
                                             const void* counts, void* out, int b,
                                             int h, int w, int c, int n, int kernel,
                                             int stride, int rpb, int group,
                                             int ngroups, void* stream) {
  return bitserial::launch<bitserial::kDynamic>(x, wq, counts, out, b, h, w, c, n,
                                                kernel, stride, 8, rpb, group,
                                                ngroups, stream);
}
