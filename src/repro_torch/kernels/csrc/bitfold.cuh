// The bit-transpose fold shared by the int8 tensor-core kernels
// (bitserial_matmul.cu: K1, K3; bitserial_conv.cu: K2, K4): packed weight
// planes -> the int8 weights an mma.sync B operand takes. K5 (dense int8
// weights) takes its byte transpose alone, and trim8 for its activations.
//
// For one column and packed row-byte kb, the plane bytes form a planes x 8
// bit matrix; its 8x8 transpose (a byte transpose of 8 columns by prmt,
// then three masked shift-xor rounds on 64 bits) gives the 8 weights of
// rows 8kb..8kb+7, one byte each, plane i at bit i.
//
// Plane counts (K3, K4): a column with count c runs only planes 0..c-1,
// plane c-1 negated, i.e. its weight is the Pw-bit weight truncated to c
// bits in 2's complement (K5 truncates each activation byte at its
// pixel's count the same way). `trim8` and `trim16` mask the planes >= c off a
// folded word and sign-extend it from c bits, per column. At Pw > 8 the
// weight is split into lo = v & 255 (unsigned) and hi = v >> 8
// (arithmetic): for c <= 8 the truncated value is a c-bit number whose hi
// slice is its sign (0 or -1), not planes 8..Pw-1.
#pragma once

#include <cstdint>

namespace bitfold {

constexpr uint64_t kOnes = 0x0101010101010101ull;   // one bit in each byte

// Bit (r, c) of x at 8r + c moves to 8c + r.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// Words a, b, c, d (rows 0-3, byte j = column j) -> o[j] (column j, byte
// i = row i): a 4x4 byte transpose.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(c, d, 0x5140);
  const uint32_t t2 = __byte_perm(a, b, 0x7362), t3 = __byte_perm(c, d, 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// Sign-extend each byte of x from `bits` (1..8) bits.
__device__ __forceinline__ uint64_t sign_extend8(uint64_t x, int bits) {
  if (bits >= 8) return x;
  const uint64_t sign = (x >> (bits - 1)) & kOnes;
  return x | sign * static_cast<uint64_t>((0xFFu << bits) & 0xFFu);
}

// An 8 x 8 byte block, row i's 8 bytes from load(i) (a uint2: columns
// 0-3, 4-7) -> w[j]: column j's 8 bytes, row i at byte i. Rows >= nr read
// as zero. K5 moves dense int8 weights into the mma's K-major B layout
// with it; fold8 starts with it.
template <class Load>
__device__ __forceinline__ void transpose_bytes8(Load load, int nr, uint64_t (&w)[8]) {
  uint32_t lo[8], hi[8];                 // row i, columns 0-3 and 4-7
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint2 v = make_uint2(0u, 0u);
    if (i < nr) v = load(i);
    lo[i] = v.x;
    hi[i] = v.y;
  }
  uint32_t c[4][4];   // c[0], c[1]: columns 0-3, rows 0-3 and 4-7; c[2], c[3]: columns 4-7
  transpose4(lo[0], lo[1], lo[2], lo[3], c[0]);
  transpose4(lo[4], lo[5], lo[6], lo[7], c[1]);
  transpose4(hi[0], hi[1], hi[2], hi[3], c[2]);
  transpose4(hi[4], hi[5], hi[6], hi[7], c[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = c[0][j] | static_cast<uint64_t>(c[1][j]) << 32;
    w[4 + j] = c[2][j] | static_cast<uint64_t>(c[3][j]) << 32;
  }
}

// The np (<= 8) plane bytes of 8 neighbouring columns at one packed row,
// plane i's 8 bytes from load(i) (a uint2: columns 0-3, 4-7) -> w[j]:
// column j's 8 rows, byte r = bit r of each plane, plane i at bit i
// (unsigned: the caller sign-extends). Planes >= np read as zero.
template <class Load>
__device__ __forceinline__ void fold8(Load load, int np, uint64_t (&w)[8]) {
  transpose_bytes8(load, np, w);         // column j: byte i = plane i
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = transpose8(w[j]);
}

// A folded word of planes 0-7 (Pw <= 8) truncated at c in [1, 8] planes:
// planes >= c masked off, each byte sign-extended from c bits.
__device__ __forceinline__ uint64_t trim8(uint64_t w, int c) {
  return sign_extend8(w & kOnes * ((1u << c) - 1u), c);
}

// The lo (planes 0-7) and hi (planes 8..) words of a Pw > 8 column
// truncated at c in [1, Pw] planes, as the mma's s8 x u8 (lo) and s8 x s8
// (hi) operands of hi * 256 + lo.
__device__ __forceinline__ void trim16(uint64_t& lo, uint64_t& hi, int c) {
  if (c <= 8) {
    lo = trim8(lo, c);
    hi = ((lo >> 7) & kOnes) * 0xFFu;   // each byte 0 or -1: the sign of lo's byte
  } else {
    hi = trim8(hi, c - 8);
  }
}

}  // namespace bitfold
