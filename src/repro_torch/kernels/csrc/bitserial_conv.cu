// bitserial_conv: fused "same"-padded convolution, x int8 NHWC
// [B, H, W, C] -> exact int32 [B, Ho, Wo, N], Ho = ceil(H/s),
// Wo = ceil(W/s); odd k, stride >= 1. One kernel,
// `tcconv::conv_tc_kernel`, with three entry points:
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
// the bytes; the k*k*C-deep products are small.
//
// Every block is (N tile, band of output rows, images). It stages its band
// of input rows -- the halo included, zero for the "same" padding -- from
// device memory into shared memory once per image, then gathers each
// pixel's patch straight from that band (the implicit im2col: no patch
// tensor is ever written to device memory, the paper's bandwidth law), with
// zero for the K8 pad rows >= k*k*C. rows_per_band only sets how the map is
// cut into blocks and how large the staged band is; every output is the
// same sum in any cut, so it never changes a bit of the result.
//
// The products run on the int8 tensor cores (mma.sync m16n8k32, K1's
// fragments, bitfold.cuh). The template parameter `Op` names the B operand:
// PackedPlanes (K2 and K4 at Pw <= 8), WidePlanes (Pw > 8: each weight split
// into lo and hi slices as in K1) or DenseInt8 (K5). Per block:
//   * the band, by cp.async 16 bytes at a time where a row's W*C bytes
//     allow it (each band row is laid out so that its interior starts on a
//     16-byte boundary: conv1's 3-channel rows too), else byte by byte;
//   * the B operand of its BN filters for the whole reduction, once, in
//     the mma's K-major layout, reused by every pixel tile of the band;
//     only where it does not fit (K beyond some thousands) the reduction
//     runs in chunks of kc rows, each made again per pixel tile:
//       - packed planes (K2, K4): the bit-transpose fold. K4 reads the
//         counts of its BN filters once; the fold loads only the planes
//         below their largest count, so a trimmed tile moves count/Pw of
//         the packed bytes, and masks each filter at its own count. K2
//         passes no counts: every filter runs all Pw planes;
//       - dense int8 (K5): 8 rows of 8 filters by 8-byte loads and a byte
//         transpose; no fold;
//   * per tile of BM pixels: the patches gathered into K1's A layout (K
//     contiguous per pixel, row stride kc + 0 or 32 bytes so the fragment
//     loads are free of bank conflicts) in runs: with the (di, dj, c)
//     feature order every window row di is k*C contiguous band bytes at any
//     stride, copied 16, 8, 4, 2 or 1 bytes at a time (the largest that
//     divides C). K5 truncates each run at its pixel's count, 8 bytes at a
//     time (bitfold::trim8: 2's complement at that width, which is what
//     executing count activation planes with plane count-1 negated
//     computes); the count comes from a per-pixel table of the window
//     groups, so its bands need not align with them. Then the products;
//     the accumulator staged through shared memory and stored as whole rows
//     of int32, 16 bytes a thread;
//   * where a band is a single pixel tile, two images one after the other
//     (the wrapper's ipb), so that one B operand serves two tiles; the
//     band and the pixel tables are made again per image.
// Trimming saves packed-weight bytes (K4) or nothing (K5) here, not
// products: a term costs the same on the tensor cores whatever its count.
#include "bitfold.cuh"
#include "tensor_core.cuh"

namespace tcconv {

constexpr int BM = 64, BN = 64;                 // output pixels x filters per tile
constexpr int WM = 2, WN = 4, THREADS = 32 * WM * WN;
constexpr int MT = BM / (16 * WM), NT = BN / (8 * WN);   // m16 and n8 tiles per warp
constexpr int OUT_LD = 4 * BN + 32;             // bytes per staged output row: the
                                                // fragments' 8-byte writes are free
                                                // of bank conflicts

// The B operand (the kernel's template parameter; each name shows in the
// kernel's symbol): packed weight planes folded at Pw <= 8 or as lo and hi
// slices at Pw > 8 (K2, K4), or dense int8 weights (K5).
struct PackedPlanes { static constexpr bool wide = false, dense = false; };
struct WidePlanes { static constexpr bool wide = true, dense = false; };
struct DenseInt8 { static constexpr bool wide = false, dense = true; };

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// The block's shared memory, all dynamic (bitserial_conv.py's
// `conv_tc_layout` is the same sum, held equal to conv_tc_layout_bytes):
//   band   [band_rows][row_ld]: row r holds input row (first + r) at byte
//          lpad + (col + pad) * C, col in [-pad, W + pad), so the W*C
//          interior bytes start 16-aligned;
//   b_s    [WIDE][BN][lds] the B operand, K-contiguous per filter;
//   a_s    [BM][lds] gathered patches, K-contiguous per pixel; after the
//          products the same bytes stage the [BM][OUT_LD] output tile;
//   k_off  [kc / vec] band offset of each vec-byte slot of a chunk's rows,
//          -1 past k*k*C;
//   cnt    [BN + 1] per-filter counts and their maximum (K2, K4);
//   pix    [BM] band offset of each tile pixel's window, -1 past the band;
//   pcnt   [BM] each tile pixel's activation-plane count (K5).
struct Layout {
  int pad, lpad, row_ld, band_rows, vec, lds;
  int b_off, a_off, koff_off, cnt_off, pix_off, pcnt_off, bytes;
  __host__ __device__ Layout(int w, int c, int kernel, int stride, int rpb, int kc, bool wide) {
    pad = kernel / 2;
    lpad = (16 - pad * c % 16) % 16;
    row_ld = round16(lpad + (w + 2 * pad) * c);
    band_rows = (rpb - 1) * stride + kernel;
    vec = c % 16 == 0 ? 16 : c % 8 == 0 ? 8 : c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1;
    lds = kc + (kc / 32 % 2 == 0 ? 32 : 0);   // = 32 or 96 mod 128
    b_off = round16(band_rows * row_ld);
    a_off = b_off + (wide ? 2 : 1) * BN * lds;
    koff_off = a_off + round16(BM * (lds > OUT_LD ? lds : OUT_LD));
    cnt_off = koff_off + round16(4 * (kc / vec));
    pix_off = cnt_off + round16(4 * (BN + 1));
    pcnt_off = pix_off + 4 * BM;
    bytes = pcnt_off + 4 * BM;
  }
};

template <int V> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<2> { using T = uint16_t; };
template <> struct Vec<1> { using T = uint8_t; };

// Each byte of a gathered run truncated at c in [1, 8] bits, 2's
// complement (K5), 8 bytes at a time.
__device__ __forceinline__ uint64_t trim_word(uint32_t lo, uint32_t hi, int c) {
  return bitfold::trim8(lo | static_cast<uint64_t>(hi) << 32, c);
}
__device__ __forceinline__ uint4 trim_run(uint4 v, int c) {
  const uint64_t a = trim_word(v.x, v.y, c), b = trim_word(v.z, v.w, c);
  return make_uint4(static_cast<uint32_t>(a), static_cast<uint32_t>(a >> 32),
                    static_cast<uint32_t>(b), static_cast<uint32_t>(b >> 32));
}
__device__ __forceinline__ uint2 trim_run(uint2 v, int c) {
  const uint64_t a = trim_word(v.x, v.y, c);
  return make_uint2(static_cast<uint32_t>(a), static_cast<uint32_t>(a >> 32));
}
template <class T>
__device__ __forceinline__ T trim_run(T v, int c) {   // 4, 2 or 1 bytes
  return static_cast<T>(bitfold::trim8(v, c));
}

// A[r][q*V .. q*V + V) = the band's V bytes at pix[r] + k_off[q] (zero
// where either is -1), truncated at pcnt[r] bits where kTrim (K5): the
// tile's patches, one run of a window row at a time.
template <int V, bool kTrim>
__device__ __forceinline__ void gather(uint8_t* a_s, const uint8_t* band, const int* pix,
                                       const int* pcnt, const int* k_off, int slots,
                                       int lds) {
  using T = typename Vec<V>::T;
  // Slot e = r * slots + q for e = threadIdx.x, + THREADS, ...: (r, q)
  // advanced without a division.
  const int dr = THREADS / slots, dq = THREADS % slots;
  int r = threadIdx.x / slots, q = threadIdx.x % slots;
  while (r < BM) {
    const int po = pix[r], ko = k_off[q];
    T v{};
    if (po >= 0 && ko >= 0) {
      v = *reinterpret_cast<const T*>(band + po + ko);
      if constexpr (kTrim) v = trim_run(v, pcnt[r]);
    }
    *reinterpret_cast<T*>(a_s + r * lds + q * V) = v;
    r += dr;
    q += dq;
    if (q >= slots) {
      q -= slots;
      ++r;
    }
  }
}

// wts: the packed planes (K2, K4) or the dense int8 weights (K5). counts:
// K4's per filter group of `group` filters (nullptr: all pw planes, K2),
// or K5's [batch][ngroups] per group of `group` windows.
template <class Op>
__global__ void __launch_bounds__(THREADS)
conv_tc_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wts,
               const int32_t* __restrict__ counts, int32_t* __restrict__ out,
               int batch, int h, int w, int c, int n, int kernel, int stride, int pw,
               int rpb, int ho, int wo, int group, int ngroups, int kc, int ipb) {
  constexpr int WIDE = Op::wide ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(w, c, kernel, stride, rpb, kc, Op::wide);
  uint8_t* band = smem_raw;
  uint8_t* b_s = smem_raw + L.b_off;
  uint8_t* a_s = smem_raw + L.a_off;
  int* k_off = reinterpret_cast<int*>(smem_raw + L.koff_off);
  int* cnt = reinterpret_cast<int*>(smem_raw + L.cnt_off);
  int* pix = reinterpret_cast<int*>(smem_raw + L.pix_off);
  int* pcnt = reinterpret_cast<int*>(smem_raw + L.pcnt_off);
  const int lds = L.lds, row_ld = L.row_ld, pad = L.pad;
  // Block (N tile, band bi, images [b0, b1)).
  const int n0 = blockIdx.x * BN, bi = blockIdx.y;
  const int band_px = min(rpb, ho - bi * rpb) * wo;
  const int b0 = blockIdx.z * ipb, b1 = min(batch, b0 + ipb);
  const int kkc = kernel * kernel * c, k8 = (kkc + 7) / 8, run = kernel * c;
  const int nchunks = ((k8 * 8 + 31) / 32 * 32 + kc - 1) / kc;
  const int slots = kc / L.vec, kb_chunk = kc / 8;

  // Packed planes: the filters' counts (all pw without counts) and the
  // planes to load.
  int np = 0;
  if constexpr (!Op::dense) {
    if (threadIdx.x == 0) cnt[BN] = 1;
    __syncthreads();
    for (int j = threadIdx.x; j < BN; j += THREADS) {
      int cj = pw;
      if (n0 + j < n) {
        if (counts) cj = max(1, min(counts[(n0 + j) / group], pw));
        atomicMax(cnt + BN, cj);
      }
      cnt[j] = cj;
    }
    __syncthreads();
    np = cnt[BN];
  }

  // Stage image b's band: input rows [r_in0, r_in0 + band_rows), zero
  // outside the map (cp.async: the caller waits).
  const int r_in0 = bi * rpb * stride - pad, in0 = L.lpad + pad * c, row_in = w * c;
  auto stage_band = [&](int b) {
    if (row_in % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      // 16-byte words: in0 and row_ld are multiples of 16 by the layout.
      const int q_row = row_ld / 16, q_in0 = in0 / 16, q_in = row_in / 16;
      for (int e = threadIdx.x; e < L.band_rows * q_row; e += THREADS) {
        const int r = e / q_row, q = e % q_row, gr = r_in0 + r;
        uint8_t* dst = band + r * row_ld + 16 * q;
        if (gr >= 0 && gr < h && q >= q_in0 && q < q_in0 + q_in)
          tc::cp_async16(dst, x + ((size_t)b * h + gr) * row_in + 16 * (q - q_in0), 16);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = threadIdx.x; e < L.band_rows * row_ld; e += THREADS) {
        const int r = e / row_ld, col = e % row_ld, gr = r_in0 + r;
        const bool inside = gr >= 0 && gr < h && col >= in0 && col < in0 + row_in;
        band[e] = inside ? x[((size_t)b * h + gr) * row_in + col - in0] : 0;
      }
    }
    tc::cp_async_commit();
  };
  const bool wvec = n % 8 == 0 && reinterpret_cast<uintptr_t>(wts) % 8 == 0;

  // Reduction rows [ch * kc, (ch + 1) * kc) of the BN filters into b_s
  // (zero past K8 and n), and the chunk's gather offsets into k_off.
  auto fill_chunk = [&](int ch) {
    for (int e = threadIdx.x; e < kb_chunk * (BN / 8); e += THREADS) {
      const int kb = e % kb_chunk, cg = e / kb_chunk;
      const int gkb = ch * kb_chunk + kb, col0 = n0 + 8 * cg;
      const bool ok = gkb < k8 && col0 < n;
      // load(i): the 8 bytes of columns col0.. at plane i's packed row gkb,
      // or at dense row 8 gkb + i.
      const size_t step = Op::dense ? (size_t)n : (size_t)k8 * n;
      const uint8_t* src = wts + (Op::dense ? 8 : 1) * (size_t)gkb * n + col0;
      auto load = [&](int i) {
        uint2 v = make_uint2(0u, 0u);
        if (!ok) return v;
        const uint8_t* s = src + i * step;
        if (wvec && col0 + 8 <= n) return *reinterpret_cast<const uint2*>(s);
        uint8_t bytes[8];
        for (int j = 0; j < 8; ++j) bytes[j] = col0 + j < n ? s[j] : 0;
        v.x = bytes[0] | bytes[1] << 8 | bytes[2] << 16 | (uint32_t)bytes[3] << 24;
        v.y = bytes[4] | bytes[5] << 8 | bytes[6] << 16 | (uint32_t)bytes[7] << 24;
        return v;
      };
      uint64_t lo[8];
      uint8_t* lo_s = b_s + 8 * cg * lds + 8 * kb;
      if constexpr (Op::dense) {
        bitfold::transpose_bytes8(load, 8, lo);
#pragma unroll
        for (int j = 0; j < 8; ++j) *reinterpret_cast<uint64_t*>(lo_s + j * lds) = lo[j];
      } else {
        bitfold::fold8(load, min(np, 8), lo);
        if constexpr (Op::wide) {
          uint64_t hi[8];
          bitfold::fold8([&](int i) { return load(8 + i); }, np - 8, hi);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bitfold::trim16(lo[j], hi[j], cnt[8 * cg + j]);
            *reinterpret_cast<uint64_t*>(lo_s + j * lds) = lo[j];
            *reinterpret_cast<uint64_t*>(lo_s + (BN + j) * lds) = hi[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint64_t*>(lo_s + j * lds) = bitfold::trim8(lo[j], cnt[8 * cg + j]);
        }
      }
    }
    for (int q = threadIdx.x; q < slots; q += THREADS) {
      const int kk = ch * kc + q * L.vec;           // (di, dj, c) = kk / run, ...
      k_off[q] = kk < kkc ? kk / run * row_ld + kk % run : -1;
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / WN, wn = warp % WN;
  const int ncols = min(BN, n - n0);
  // An image's band is restaged only after the last tile of the previous
  // one passed the barriers that follow its gather.
  for (int b = b0; b < b1; ++b) {
    stage_band(b);
    if (b == b0 && nchunks == 1) fill_chunk(0);       // beside the band's copies
    tc::cp_async_wait<0>();
    const size_t row0 = ((size_t)b * ho + (size_t)bi * rpb) * wo;
    for (int p0 = 0; p0 < band_px; p0 += BM) {
      if (threadIdx.x < BM) {
        const int p = p0 + threadIdx.x;
        pix[threadIdx.x] = p < band_px
            ? p / wo * stride * row_ld + L.lpad + p % wo * stride * c : -1;
        if (Op::dense && p < band_px)   // window (bi * rpb * wo + p) of image b
          pcnt[threadIdx.x] = max(1, min(counts[(size_t)b * ngroups +
                                                (bi * rpb * wo + p) / group], 8));
      }
      int32_t acc[WIDE][MT][NT][4] = {};
      for (int ch = 0; ch < nchunks; ++ch) {
        if (nchunks > 1) {
          __syncthreads();                            // the last chunk's products are done
          fill_chunk(ch);
        }
        __syncthreads();                              // band, b_s, k_off, pix, pcnt; a_s is free
        constexpr bool kTrim = Op::dense;
        switch (L.vec) {
          case 16: gather<16, kTrim>(a_s, band, pix, pcnt, k_off, slots, lds); break;
          case 8: gather<8, kTrim>(a_s, band, pix, pcnt, k_off, slots, lds); break;
          case 4: gather<4, kTrim>(a_s, band, pix, pcnt, k_off, slots, lds); break;
          case 2: gather<2, kTrim>(a_s, band, pix, pcnt, k_off, slots, lds); break;
          default: gather<1, kTrim>(a_s, band, pix, pcnt, k_off, slots, lds); break;
        }
        __syncthreads();                              // a_s gathered
        for (int kq = 0; kq < kc / 32; ++kq) {
          // The fragments of K1's tc_body: 8 consecutive bytes of a pixel's
          // patch and of a filter's weights per thread.
          uint32_t af[MT][4];
  #pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const uint8_t* row = a_s + (wm * MT * 16 + mt * 16 + g) * lds + 32 * kq + 8 * t;
            const uint2 r0 = *reinterpret_cast<const uint2*>(row);
            const uint2 r8 = *reinterpret_cast<const uint2*>(row + 8 * lds);
            af[mt][0] = r0.x;
            af[mt][1] = r8.x;
            af[mt][2] = r0.y;
            af[mt][3] = r8.y;
          }
  #pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint8_t* col = b_s + (wn * NT * 8 + nt * 8 + g) * lds + 32 * kq + 8 * t;
            const uint2 bl = *reinterpret_cast<const uint2*>(col);
  #pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              if constexpr (Op::wide) {
                const uint2 bh = *reinterpret_cast<const uint2*>(col + BN * lds);
                tc::mma_s8u8(acc[0][mt][nt], af[mt], bl.x, bl.y);
                tc::mma_s8s8(acc[1][mt][nt], af[mt], bh.x, bh.y);
              } else {
                tc::mma_s8s8(acc[0][mt][nt], af[mt], bl.x, bl.y);
              }
            }
          }
        }
      }
      __syncthreads();                                // every warp is done with a_s
  #pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
  #pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
  #pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = wm * MT * 16 + mt * 16 + g + 8 * half;
            const int col = wn * NT * 8 + nt * 8 + 2 * t;
            uint32_t v0 = static_cast<uint32_t>(acc[0][mt][nt][2 * half]);
            uint32_t v1 = static_cast<uint32_t>(acc[0][mt][nt][2 * half + 1]);
            if constexpr (Op::wide) {
              v0 += static_cast<uint32_t>(acc[1][mt][nt][2 * half]) << 8;
              v1 += static_cast<uint32_t>(acc[1][mt][nt][2 * half + 1]) << 8;
            }
            *reinterpret_cast<uint2*>(a_s + row * OUT_LD + 4 * col) = make_uint2(v0, v1);
          }
        }
      }
      __syncthreads();                                // the output tile is staged
      const int rows = min(BM, band_px - p0);
      int32_t* dst = out + (row0 + p0) * n + n0;
      if (n % 4 == 0) {                               // rows of 16-byte stores
        const int q4 = ncols / 4;
        for (int e = threadIdx.x; e < rows * q4; e += THREADS) {
          const int r = e / q4, q = e % q4;
          *reinterpret_cast<uint4*>(dst + (size_t)r * n + 4 * q) =
              *reinterpret_cast<const uint4*>(a_s + r * OUT_LD + 16 * q);
        }
      } else {
        for (int e = threadIdx.x; e < rows * ncols; e += THREADS) {
          const int r = e / ncols, q = e % ncols;
          dst[(size_t)r * n + q] = *reinterpret_cast<const int32_t*>(a_s + r * OUT_LD + 4 * q);
        }
      }
    }
  }
}

// kc: the reduction rows per chunk, a multiple of 32 (the wrapper's
// choice: the whole K rounded up to 32 where the block's shared memory
// allows it). A block runs ipb images, one after another, with one B
// operand.
template <class Op>
int launch(const void* x, const void* wts, const void* counts, void* out, int b, int h,
           int w, int c, int n, int kernel, int stride, int pw, int rpb, int group,
           int ngroups, int kc, int ipb, void* stream) {
  if (kc < 32 || kc % 32 != 0 || ipb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ho = (h + stride - 1) / stride, wo = (w + stride - 1) / stride;
  const Layout L(w, c, kernel, stride, rpb, kc, Op::wide);
  const cudaError_t err = cudaFuncSetAttribute(
      conv_tc_kernel<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BN - 1) / BN, (ho + rpb - 1) / rpb, (b + ipb - 1) / ipb);
  conv_tc_kernel<Op><<<grid, THREADS, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const uint8_t*>(wts),
      static_cast<const int32_t*>(counts), static_cast<int32_t*>(out), b, h, w, c, n,
      kernel, stride, pw, rpb, ho, wo, group, ngroups, kc, ipb);
  return static_cast<int>(cudaGetLastError());
}

// Packed planes (K2, K4): lo and hi slices at Pw > 8. counts == nullptr
// runs all pw planes of every filter.
int launch_planes(const void* x, const void* wp, const void* counts, void* out, int b,
                  int h, int w, int c, int n, int kernel, int stride, int pw, int rpb,
                  int w_group, int kc, int ipb, void* stream) {
  const auto fn = pw > 8 ? launch<WidePlanes> : launch<PackedPlanes>;
  return fn(x, wp, counts, out, b, h, w, c, n, kernel, stride, pw, rpb, w_group, 0, kc,
            ipb, stream);
}

}  // namespace tcconv

// Launch on `stream`; each returns cudaGetLastError() (0 = launched). kc
// and ipb as in tcconv::launch.
extern "C" int bitserial_conv_launch(const void* x, const void* wp, void* out, int b,
                                     int h, int w, int c, int n, int kernel, int stride,
                                     int pw, int rpb, int kc, int ipb, void* stream) {
  return tcconv::launch_planes(x, wp, nullptr, out, b, h, w, c, n, kernel, stride, pw,
                               rpb, 1, kc, ipb, stream);
}

// counts: int32 [ceil(n / w_group)], each clamped to [1, pw].
extern "C" int bitserial_conv_wgroup_launch(const void* x, const void* wp,
                                            const void* counts, void* out, int b,
                                            int h, int w, int c, int n, int kernel,
                                            int stride, int pw, int rpb,
                                            int w_group, int kc, int ipb, void* stream) {
  return tcconv::launch_planes(x, wp, counts, out, b, h, w, c, n, kernel, stride, pw,
                               rpb, w_group, kc, ipb, stream);
}

// wq: int8 [K8, n]; counts: int32 [b, ngroups], each clamped to [1, 8],
// window (ho_i * Wo + wo_i) of image b in group (ho_i * Wo + wo_i) / group.
extern "C" int bitserial_conv_dynamic_launch(const void* x, const void* wq,
                                             const void* counts, void* out, int b,
                                             int h, int w, int c, int n, int kernel,
                                             int stride, int rpb, int group,
                                             int ngroups, int kc, int ipb,
                                             void* stream) {
  return tcconv::launch<tcconv::DenseInt8>(x, wq, counts, out, b, h, w, c, n, kernel,
                                           stride, 8, rpb, group, ngroups, kc, ipb,
                                           stream);
}

// The block's dynamic shared memory (tcconv::Layout), so that its Python
// mirror, conv_tc_layout, can be held equal to it.
extern "C" int conv_tc_layout_bytes(int w, int c, int kernel, int stride, int rpb, int kc,
                                    int wide) {
  return tcconv::Layout(w, c, kernel, stride, rpb, kc, wide != 0).bytes;
}
