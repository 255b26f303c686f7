"""PyTorch port: the arithmetic of the tensor-core kernels K1 and K7, on the
CPU.

CUDA kernels cannot run here, so plain-torch mirrors of what they compute
are held against the port's and the JAX package's oracles on the same
numpy inputs:

(a) K1's fold as a bit transpose: the Pw plane bytes of one column and
    packed row-byte form a Pw x 8 bit matrix whose 8x8 transpose (three
    masked shift-xor rounds on 64 bits) gives the 8 weights of its rows,
    sign-extended from Pw bits;
(b) K1 at Pw 9-16: each weight split into lo = w & 255 (unsigned) and
    hi = w >> 8, two int32 accumulators recombined as hi * 256 + lo with
    int32 wrap-around;
(c) K7's bf16 route: S = Q K^T in float32, online softmax over 64-key
    tiles with exp2 of log2(e)-scaled scores, and P fed to P V as two bf16
    parts, P_hi + P_lo. One bf16 rounding of P would not hold K7's
    tolerance (1e-4 + 2^-7 |want| against the float32 plain version);
    the split does;
(d) K1's route function: skinny at M <= SKINNY_MAX_M, tile above, and a
    K split that never leaves a split without a tile.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitpack as jbitpack, quantize as jq
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro_torch.core import bitpack
from repro_torch.kernels import ref
from repro_torch.kernels.bitserial_matmul import SKINNY_MAX_M, _route

K7_BF16_TOL = (1e-4, 2 ** -7)      # chip_smoke.K7_TOL for bf16 inputs
JAX_BF16_TOL = 0.05                # tests/test_kernels.py, bf16


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _packed(rng, k, n, bits):
    wq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(k, n)).astype(np.int32)
    return wq, np.asarray(jbitpack.pack_weights(jnp.asarray(wq), bits))


# -- (a) the fold as a bit transpose -----------------------------------------

def _transpose8(x: torch.Tensor) -> torch.Tensor:
    """bit (r, c) at 8r + c -> 8c + r of int64 words (k1::transpose8)."""
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AA
    x = x ^ t ^ (t << 7)
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCC
    x = x ^ t ^ (t << 14)
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0
    return x ^ t ^ (t << 28)


def _sign_extend8(y: torch.Tensor, bits: int) -> torch.Tensor:
    """Each byte of the int64 words y sign-extended from ``bits`` bits
    (k1::sign_extend8)."""
    if bits >= 8:
        return y
    sign = (y >> (bits - 1)) & 0x0101010101010101
    return y | sign * ((0xFF << bits) & 0xFF)


def _fold(planes: torch.Tensor, sign_bits: int | None) -> torch.Tensor:
    """uint8 [np <= 8, K8, N] plane bytes -> int32 [8 K8, N]: byte r of
    column n's transposed word is row 8 kb + r, plane p at bit p; signed
    from ``sign_bits`` bits, or unsigned when None."""
    x = torch.zeros(planes.shape[1:], dtype=torch.int64)
    for p in range(planes.shape[0]):
        x |= planes[p].to(torch.int64) << (8 * p)
    y = _transpose8(x)
    if sign_bits is not None:
        y = _sign_extend8(y, sign_bits)
    rows = torch.stack([(y >> (8 * r)) & 0xFF for r in range(8)], dim=1)
    rows = rows.reshape(-1, planes.shape[2]).to(torch.int32)
    if sign_bits is not None:
        rows = rows.to(torch.uint8).view(torch.int8).to(torch.int32)
    return rows


def test_transpose8_is_the_bit_transpose():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -2 ** 63, 2 ** 63 - 1, size=64, dtype=np.int64))
    y = _transpose8(x)
    for r in range(8):
        for c in range(8):
            assert torch.equal((x >> (8 * r + c)) & 1, (y >> (8 * c + r)) & 1)


@pytest.mark.parametrize("w_bits", range(1, 9))
@pytest.mark.parametrize("k,n", [(40, 10), (64, 37), (256, 16)])
def test_bit_transpose_fold_equals_unpack(w_bits, k, n):
    rng = np.random.default_rng(100 * w_bits + k + n)
    wq, packed = _packed(rng, k, n, w_bits)
    got = _fold(_t(packed), w_bits)
    assert torch.equal(got[:k], torch.from_numpy(wq))
    assert torch.equal(got, bitpack.unpack_weights(_t(packed), w_bits))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbitpack.unpack_weights(jnp.asarray(packed),
                                                        w_bits)))


# -- (b) the Pw 9-16 slice split ---------------------------------------------

def _narrow(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.int64).to(torch.int32)


def _split_matmul(x: torch.Tensor, packed: torch.Tensor, w_bits: int):
    """K1 at Pw > 8: x @ lo (s8 x u8) and x @ hi (s8 x s8) in wrapping
    int32, then hi * 256 + lo in wrapping int32."""
    lo = _fold(packed[:8], None)                    # planes 0-7, unsigned
    hi = _fold(packed[8:], w_bits - 8)              # planes 8.., signed
    x64 = x.to(torch.int64)
    acc_lo = _narrow(x64 @ lo.to(torch.int64))
    acc_hi = _narrow(x64 @ hi.to(torch.int64))
    return _narrow(acc_hi.to(torch.int64) * 256 + acc_lo.to(torch.int64))


@pytest.mark.parametrize("w_bits", [9, 11, 16])
@pytest.mark.parametrize("m,k,n", [(2, 2048, 24), (17, 40, 10)])
def test_slice_split_equals_reference(w_bits, m, k, n):
    rng = np.random.default_rng(w_bits + m + k)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    _, packed = _packed(rng, k, n, w_bits)
    want = np.asarray(jref.bitserial_matmul_ref(jnp.asarray(x),
                                                jnp.asarray(packed), w_bits))
    got = _split_matmul(_t(x), _t(packed), w_bits)
    np.testing.assert_array_equal(got.numpy(), want)


def test_slice_split_wraps_like_int32():
    """x = -128 (127 in every third column of row 0) against -2^15
    (2^15 - 1 in column 1) over K = 6144: the int32 sum wraps."""
    x = np.full((2, 6144), -128, dtype=np.int8)
    x[0, ::3] = 127
    wq = np.full((6144, 16), -2 ** 15, dtype=np.int32)
    wq[:, 1] = 2 ** 15 - 1
    packed = np.asarray(jbitpack.pack_weights(jnp.asarray(wq), 16))
    exact = x.astype(np.int64) @ wq.astype(np.int64)
    want = np.asarray(jref.bitserial_matmul_ref(jnp.asarray(x),
                                                jnp.asarray(packed), 16))
    assert (exact != want).any()
    got = _split_matmul(_t(x), _t(packed), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ref.bitserial_matmul_ref(_t(x), _t(packed), 16))


# -- (c) the bf16 tensor-core attention numerics -----------------------------

def _tensor_core_attention(q, k, v, *, causal, window, split_p=True,
                           bk=64):
    """K7's bf16 route in plain torch: q, k, v bf16 [B, H, S, D] -> bf16."""
    s, d = q.shape[2], q.shape[3]
    scale_log2 = d ** -0.5 * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    qi = torch.arange(s)[:, None]
    m = torch.full(q.shape[:3], float("-inf"))
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for k0 in range(0, s, bk):
        kj = torch.arange(k0, min(s, k0 + bk))[None, :]
        sc = (qf @ kf[..., k0:k0 + bk, :].transpose(-1, -2)) * scale_log2
        ok = torch.ones_like(kj <= qi)
        if causal:
            ok &= kj <= qi
        if window is not None:
            ok &= kj > qi - window
        sc = sc.masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new),
                         m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc - mu[..., None])
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        pv = p_hi + ((p - p_hi).bfloat16().float() if split_p else 0.0)
        acc = acc * alpha[..., None] + pv @ vf[..., k0:k0 + bk, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


def _qkv(s, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 2, s, 128)).astype(np.float32)
            for _ in range(3)]


def _within(got, want, atol, rtol):
    return (got.float() - want).abs() <= atol + rtol * want.abs()


@pytest.mark.parametrize("s", [512, 4096])
@pytest.mark.parametrize("window", [None, 1024])
def test_tensor_core_attention_within_k7_tolerance(s, window):
    arrays = _qkv(s, s + (window or 0))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = _tensor_core_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True, window=window)
    assert bool(_within(got, want, *K7_BF16_TOL).all())
    jq_, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays)
    jout = np.asarray(jflash_attention(jq_, jk, jv, causal=True,
                                       window=window), dtype=np.float32)
    np.testing.assert_allclose(got.float().numpy(), jout, rtol=JAX_BF16_TOL,
                               atol=JAX_BF16_TOL)


def test_one_bf16_rounding_of_p_breaks_k7_tolerance():
    """Why the kernel splits P: rounded once to bf16, P moves outputs near
    zero by more than 1e-4 + 2^-7 |want| in many elements, though the max
    abs err barely changes."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(512, 512))
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=True)
    once = _tensor_core_attention(q, k, v, causal=True, window=None,
                                  split_p=False)
    split = _tensor_core_attention(q, k, v, causal=True, window=None)
    assert int((~_within(once, want, *K7_BF16_TOL)).sum()) > 100
    assert bool(_within(split, want, *K7_BF16_TOL).all())


# -- (d) K1's route ----------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 15, 16, 17, 64, 256, 1024])
@pytest.mark.parametrize("k,n,pw", [(2048, 1024, 8), (6144, 2048, 8),
                                    (2048, 151936, 8), (2048, 256, 8),
                                    (40, 10, 11), (256, 10, 16)])
def test_k1_route(m, k, n, pw):
    route, splits = _route(m, k, n, pw)
    assert route == ("skinny" if m <= SKINNY_MAX_M else "tile")
    bm, bn, bk = ((16, 64, 64) if route == "skinny" else
                  (64, 128, 64) if pw > 8 else (128, 128, 128))
    blocks = -(-m // bm) * -(-n // bn)
    tiles = -(-k // bk)
    per = -(-tiles // splits)
    assert 1 <= splits <= tiles
    assert (splits - 1) * per < tiles            # no split without a tile
    assert blocks * splits >= min(2 * 132, blocks * tiles)


def test_k1_route_boundary():
    assert _route(SKINNY_MAX_M, 2048, 1024, 8)[0] == "skinny"
    assert _route(SKINNY_MAX_M + 1, 2048, 1024, 8)[0] == "tile"
    # the decode step's projections fill the card; the head needs no split
    assert _route(2, 2048, 1024, 8) == ("skinny", 32)
    assert _route(2, 2048, 151936, 8) == ("skinny", 1)
