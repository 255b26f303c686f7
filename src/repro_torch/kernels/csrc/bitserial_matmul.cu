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
// Both run one kernel body, `tc_body`, on the int8 tensor cores
// (mma.sync.m16n8k32, s8 x s8 -> s32, wrapping: no .satfinite): K1 as
// `k1_kernel` (no counts), K3 as `k3_kernel`. What bounds them on an H100
// depends on M:
//   * prefill-shaped M (the LM's 1024 rows, the CNN's 256, and K3's
//     transposed calls, whose M is a layer's output width): 2 M N K
//     operations against 1979 TOP/s int8, e.g. 1.57 ms for the 197 linears
//     of a 2 x 512-token prefill;
//   * decode-shaped M (<= 16): the packed weight bytes, 1.72 GB a decode
//     step at Pw = 8, 0.52 ms at 3.35 TB/s.
// The fold is a bit transpose (bitfold.cuh): 8 int8 weights per column
// and packed row-byte, K-contiguous per column in shared memory, the mma's
// K-major B operand. At Pw = 8 a byte is the int8 two's-complement weight
// (plane 7 negated is the sign bit); below 8 it is sign-extended from Pw
// bits. A thread's fragment takes 8 consecutive bytes of A (an x row) and
// of B (a weight column) for its two K slices: the mma sums over K in
// another order, which exact integer sums do not see. Pw = 9..16 splits
// each weight into lo = w & 255 (planes 0-7, unsigned: mma s8 x u8) and
// hi = w >> 8 (sign-extended), two accumulators recombined as hi * 256 +
// lo in wrapping int32.
// K3's block reads the counts of its BN columns once. Its loads stage only
// the planes below the tile's largest count, so a trimmed tile moves
// count/Pw of the packed bytes (the paper's bandwidth law), and its fold
// masks each column at its own count and sign-extends from it (bn need not
// be a multiple of 8, and a column group may end inside a tile). The
// products are the same whatever the counts.
// Each stage stages BK rows of x and the stage's packed plane bytes
// (cp.async, 8 and 16 bytes at a time) in a ring, so the next stages load
// while one is folded and multiplied. Two shapes, chosen by the wrapper
// from M (`_route`), neither falling back to the other:
//   tile   -- 128 x 128 output tile, 8 warps of 64 x 32, BK = 128 in a
//             ring of 2 (at Pw > 8: 64 x 128, warps of 32 x 32, BK = 64
//             in a ring of 3); for M > 16. Larger tiles (256 x 128,
//             128 x 256) were slower on the card, and BK = 128 beat 64.
//   skinny -- 16 x 64 tile, 4 warps of 16 x 16, rows past M zero, BK = 64
//             in a ring of 4; for M <= 16.
// Either splits K over blockIdx.z when the output tiles alone would leave
// SMs idle (e.g. the decode step's 1024-column projections); the splits
// add their partial sums into a zeroed output with int32 atomicAdd, exact
// in any order. Ragged M, N and K (K a multiple of 8) are zero-filled.
// K3 has two callers: the dynamic serving linear calls it transposed, the
// packed operand being the runtime-packed activations (bn = the row
// group); the static weight-group route calls it with the pack-time counts
// (bn = the filter group).
#include "bitfold.cuh"
#include "tensor_core.cuh"

namespace mm {

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int BK_, bool kWide_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int BK = BK_;                       // reduction rows per stage
  static constexpr int KB = BK / 8;                    // packed bytes a column per stage
  static constexpr int LDS = BK + 32;                  // bytes per staged x row and folded
                                                       // weight column: 8-byte fragment
                                                       // loads free of bank conflicts
  static constexpr bool kWide = kWide_;                // Pw > 8: lo and hi slices
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MT = BM / (16 * WM);            // m16 tiles per warp
  static constexpr int NT = BN / (8 * WN);             // n8 tiles per warp
  static constexpr int RAW_LD = BN + 16;               // bytes per staged (plane, kb) row
  // Dynamic shared memory; K3 adds its BN column counts and their maximum.
  static constexpr int smem(int pw, bool counts) {
    return STAGES * (BM * LDS + pw * KB * RAW_LD) + (kWide ? 2 : 1) * BN * LDS +
           (counts ? 4 * (BN + 1) : 0);
  }
};
using Tile = Cfg<128, 128, 2, 4, 2, 128, false>;
using TileWide = Cfg<64, 128, 2, 4, 3, 64, true>;
using Skinny = Cfg<16, 64, 1, 4, 4, 64, false>;
using SkinnyWide = Cfg<16, 64, 1, 4, 4, 64, true>;

// One output tile of K1 (kCounts false: every column runs all pw planes)
// or K3 (column col runs counts[col / bn] planes, clamped to [1, pw]).
template <class C, bool kCounts>
__device__ __forceinline__ void tc_body(const int8_t* __restrict__ x,
                                        const uint8_t* __restrict__ wp,
                                        const int32_t* __restrict__ counts,
                                        int32_t* __restrict__ out, int m, int k, int n,
                                        int pw, int bn, int splits) {
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, RAW_LD = C::RAW_LD;
  constexpr int BK = C::BK, KB = C::KB, LDS = C::LDS;
  constexpr int MT = C::MT, NT = C::NT, WIDE = C::kWide ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int raw_stage = pw * KB * RAW_LD;
  uint8_t* a_s = smem_raw;                          // [ST][BM][LDS] x rows
  uint8_t* raw_s = a_s + ST * BM * LDS;             // [ST][pw][KB][RAW_LD] packed bytes
  uint8_t* b_s = raw_s + ST * raw_stage;            // [WIDE][BN][LDS] folded weights
  int* cnt = reinterpret_cast<int*>(b_s + WIDE * BN * LDS);   // K3: [BN] counts, their max

  const int k8 = k / 8, tiles = (k + BK - 1) / BK, per = (tiles + splits - 1) / splits;
  const int kt0 = blockIdx.z * per, nk = min(tiles, kt0 + per) - kt0;
  if (nk <= 0) return;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool xvec = reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const bool wvec = n % 16 == 0 && reinterpret_cast<uintptr_t>(wp) % 16 == 0;

  // The planes the tile loads: all pw (K1), or its columns' largest count.
  int np = pw;
  if constexpr (kCounts) {
    if (threadIdx.x == 0) cnt[BN] = 1;
    __syncthreads();
    for (int j = threadIdx.x; j < BN; j += C::THREADS) {
      int c = pw;
      if (n0 + j < n) {
        c = max(1, min(counts[(n0 + j) / bn], pw));
        atomicMax(cnt + BN, c);
      }
      cnt[j] = c;
    }
    __syncthreads();
    np = cnt[BN];
  }

  // Stage x rows [m0, m0 + BM) and the packed bytes of planes [0, np) of
  // columns [n0, n0 + BN) for reduction tile kt into ring slot `slot`;
  // zeros past M, K, N.
  auto load = [&](int kt, int slot) {
    uint8_t* a = a_s + slot * BM * LDS;
    for (int e = threadIdx.x; e < BM * KB; e += C::THREADS) {
      const int r = e / KB, c = 8 * (e % KB), gk = kt * BK + c;
      const bool ok = m0 + r < m && gk < k;
      const int8_t* src = x + (size_t)(m0 + r) * k + gk;
      if (xvec || !ok) {
        tc::cp_async8(a + r * LDS + c, ok ? src : x, ok ? 8 : 0);
      } else {
        for (int j = 0; j < 8; ++j) a[r * LDS + c + j] = static_cast<uint8_t>(src[j]);
      }
    }
    uint8_t* raw = raw_s + slot * raw_stage;
    constexpr int CH = BN / 16;                     // 16-byte chunks per packed row
    for (int e = threadIdx.x; e < np * KB * CH; e += C::THREADS) {
      const int row = e / CH, c = 16 * (e % CH);    // row = plane * KB + kb
      const int gkb = kt * KB + row % KB, gn = n0 + c;
      uint8_t* dst = raw + row * RAW_LD + c;
      const uint8_t* src = wp + ((size_t)(row / KB) * k8 + gkb) * n + gn;
      const bool ok = gkb < k8 && gn < n;
      if (wvec || !ok) {
        tc::cp_async16(dst, ok ? src : wp, ok ? 16 : 0);
      } else {
        for (int j = 0; j < 16; ++j) dst[j] = gn + j < n ? src[j] : 0;
      }
    }
  };

  // Fold ring slot `slot` into b_s: column-major int8 weights (lo and hi
  // slices at Pw > 8), each column truncated at its count (K3).
  auto fold = [&](int slot) {
    const uint8_t* raw = raw_s + slot * raw_stage;
    for (int e = threadIdx.x; e < KB * (BN / 8); e += C::THREADS) {
      const int kb = e % KB, cg = e / KB;
      const uint8_t* src = raw + kb * RAW_LD + 8 * cg;
      uint64_t w[8];
      bitfold::fold8([&](int i) { return *reinterpret_cast<const uint2*>(src + i * KB * RAW_LD); },
                     min(np, 8), w);
      if constexpr (!C::kWide) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint64_t*>(b_s + (8 * cg + j) * LDS + 8 * kb) =
              kCounts ? bitfold::trim8(w[j], cnt[8 * cg + j]) : bitfold::sign_extend8(w[j], pw);
      } else {
        const uint8_t* src_hi = src + 8 * KB * RAW_LD;
        auto load_hi = [&](int i) {
          return *reinterpret_cast<const uint2*>(src_hi + i * KB * RAW_LD);
        };
        uint8_t* lo_s = b_s + 8 * cg * LDS + 8 * kb;
        uint8_t* hi_s = lo_s + BN * LDS;
        if constexpr (kCounts) {
          uint64_t h[8];
          bitfold::fold8(load_hi, np - 8, h);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bitfold::trim16(w[j], h[j], cnt[8 * cg + j]);
            *reinterpret_cast<uint64_t*>(lo_s + j * LDS) = w[j];
            *reinterpret_cast<uint64_t*>(hi_s + j * LDS) = h[j];
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) *reinterpret_cast<uint64_t*>(lo_s + j * LDS) = w[j];
          bitfold::fold8(load_hi, pw - 8, w);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<uint64_t*>(hi_s + j * LDS) = bitfold::sign_extend8(w[j], pw - 8);
        }
      }
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wm = warp / C::WN, wn = warp % C::WN;
  int32_t acc[WIDE][MT][NT][4];
#pragma unroll
  for (int h = 0; h < WIDE; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[h][i][j][0] = acc[h][i][j][1] = acc[h][i][j][2] = acc[h][i][j][3] = 0;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(kt0 + s, s);
    tc::cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    tc::cp_async_wait<ST - 2>();
    __syncthreads();                     // slot i landed; slot i - 1 and b_s are free
    fold(i % ST);
    if (i + ST - 1 < nk) load(kt0 + i + ST - 1, (i + ST - 1) % ST);
    tc::cp_async_commit();
    __syncthreads();                     // b_s folded
    const uint8_t* a = a_s + (i % ST) * BM * LDS;
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc) {
      // A: rows g and g + 8, bytes 8t..8t+3 in a0/a1 and 8t+4..8t+7 in
      // a2/a3; B: the same bytes of column g. Both put byte 8t + j at the
      // mma's K slot 4t + j (j < 4) or 16 + 4t + j - 4.
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint8_t* row = a + (wm * MT * 16 + mt * 16 + g) * LDS + 32 * kc + 8 * t;
        const uint2 r0 = *reinterpret_cast<const uint2*>(row);
        const uint2 r8 = *reinterpret_cast<const uint2*>(row + 8 * LDS);
        af[mt][0] = r0.x;
        af[mt][1] = r8.x;
        af[mt][2] = r0.y;
        af[mt][3] = r8.y;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* col = b_s + (wn * NT * 8 + nt * 8 + g) * LDS + 32 * kc + 8 * t;
        const uint2 b = *reinterpret_cast<const uint2*>(col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (C::kWide) {
            const uint2 bh = *reinterpret_cast<const uint2*>(col + BN * LDS);
            tc::mma_s8u8(acc[0][mt][nt], af[mt], b.x, b.y);
            tc::mma_s8s8(acc[WIDE - 1][mt][nt], af[mt], bh.x, bh.y);
          } else {
            tc::mma_s8s8(acc[0][mt][nt], af[mt], b.x, b.y);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * MT * 16 + mt * 16 + g + 8 * (e >> 1);
        const int col = n0 + wn * NT * 8 + nt * 8 + 2 * t + (e & 1);
        if (row >= m || col >= n) continue;
        uint32_t v = static_cast<uint32_t>(acc[0][mt][nt][e]);
        if (C::kWide) v += static_cast<uint32_t>(acc[WIDE - 1][mt][nt][e]) << 8;
        int32_t* o = out + (size_t)row * n + col;
        if (splits > 1) atomicAdd(o, static_cast<int32_t>(v));
        else *o = static_cast<int32_t>(v);
      }
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
k1_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
          int32_t* __restrict__ out, int m, int k, int n, int pw, int splits) {
  tc_body<C, false>(x, wp, nullptr, out, m, k, n, pw, 1, splits);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
k3_kernel(const int8_t* __restrict__ x, const uint8_t* __restrict__ wp,
          const int32_t* __restrict__ counts, int32_t* __restrict__ out, int m, int k,
          int n, int pw, int bn, int splits) {
  tc_body<C, true>(x, wp, counts, out, m, k, n, pw, bn, splits);
}

// K1 (counts == nullptr) or K3 in configuration C.
template <class C>
int launch(const void* x, const void* wp, const void* counts, void* out, int m, int k,
           int n, int pw, int bn, int splits, cudaStream_t stream) {
  const int smem = C::smem(pw, counts != nullptr);
  const dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM, splits);
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const uint8_t*>(wp);
  auto* os = static_cast<int32_t*>(out);
  cudaError_t err;
  if (counts) {
    err = cudaFuncSetAttribute(k3_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k3_kernel<C><<<grid, C::THREADS, smem, stream>>>(
        xs, ws, static_cast<const int32_t*>(counts), os, m, k, n, pw, bn, splits);
  } else {
    err = cudaFuncSetAttribute(k1_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    k1_kernel<C><<<grid, C::THREADS, smem, stream>>>(xs, ws, os, m, k, n, pw, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* wp, const void* counts, void* out, int m, int k,
             int n, int pw, int bn, int skinny, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    const cudaError_t err = cudaMemsetAsync(out, 0, (size_t)m * n * sizeof(int32_t), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (skinny)
    return pw > 8 ? launch<SkinnyWide>(x, wp, counts, out, m, k, n, pw, bn, splits, st)
                  : launch<Skinny>(x, wp, counts, out, m, k, n, pw, bn, splits, st);
  return pw > 8 ? launch<TileWide>(x, wp, counts, out, m, k, n, pw, bn, splits, st)
                : launch<Tile>(x, wp, counts, out, m, k, n, pw, bn, splits, st);
}

}  // namespace mm

// Launch on `stream`; each returns cudaGetLastError() (0 = launched).
// skinny: the M <= 16 shape; splits > 1 zeroes `out` first (the splits add
// into it).
extern "C" int bitserial_matmul_launch(const void* x, const void* wp, void* out, int m,
                                       int k, int n, int pw, int skinny, int splits,
                                       void* stream) {
  return mm::dispatch(x, wp, nullptr, out, m, k, n, pw, 1, skinny, splits, stream);
}

// counts: int32 [ceil(n / bn)], each clamped to [1, pw].
extern "C" int bitserial_matmul_dynamic_launch(const void* x, const void* wp,
                                               const void* counts, void* out,
                                               int m, int k, int n, int pw,
                                               int bn, int skinny, int splits,
                                               void* stream) {
  return mm::dispatch(x, wp, counts, out, m, k, n, pw, bn, skinny, splits, stream);
}
