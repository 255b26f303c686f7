"""PyTorch port, kernels K1/K2 and the serving ops on the CPU.

The port's plain versions (the oracles its CUDA kernels are held against
on the card) must equal the JAX package's Pallas kernels, run in
interpret mode as tests/test_kernels.py and tests/test_conv.py run them,
and its ref.py oracles, bit for bit. On CPU tensors the kernel wrappers
take the plain versions and count no launch.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import backend as jbackend
from repro.core import bitpack as jbitpack, quantize as jq
from repro.kernels import ops as jops, ref as jref
from repro.kernels.bitserial_conv import band_geometry as jband_geometry
from repro.kernels.bitserial_conv import bitserial_conv as jbitserial_conv
from repro.kernels.bitserial_matmul import bitserial_matmul as jbitserial_matmul
from repro_torch.api import backend
from repro_torch.api.plan import conv_rows_per_band
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitserial_conv import (SMEM_BUDGET, band_geometry,
                                                bitserial_conv,
                                                conv_smem_bytes)
from repro_torch.kernels.bitserial_matmul import bitserial_matmul


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _packed(rng, k, n, bits):
    wq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(k, n)).astype(np.int32)
    return np.asarray(jbitpack.pack_weights(jnp.asarray(wq), bits))


@pytest.mark.parametrize("m,k,n", [(8, 32, 16), (16, 64, 32), (32, 128, 8),
                                   (128, 256, 128), (7, 40, 10)])
@pytest.mark.parametrize("w_bits", [1, 8, 11, 16])
def test_matmul_plain_equals_pallas_and_ref(m, k, n, w_bits):
    rng = np.random.default_rng(m * 1000 + k + w_bits)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    wp = _packed(rng, k, n, w_bits)
    bm, bn, bk = jbackend._pallas_blocks(m, n, k)
    want = np.asarray(jbitserial_matmul(jnp.asarray(x), jnp.asarray(wp),
                                        w_bits=w_bits, bm=bm, bn=bn, bk=bk))
    np.testing.assert_array_equal(
        want, np.asarray(jref.bitserial_matmul_ref(jnp.asarray(x),
                                                   jnp.asarray(wp), w_bits)))
    before = bitserial_matmul.launches
    got = bitserial_matmul(_t(x), _t(wp), w_bits=w_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.bitserial_matmul_ref(_t(x), _t(wp), w_bits).numpy(), want)
    assert bitserial_matmul.launches == before   # CPU: plain, no launch


def _conv_case(kernel, stride, pa, pw, b=2, h=9, c=5, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(jq.qmin(pa), jq.qmax(pa) + 1,
                     size=(b, h, h, c)).astype(np.int8)
    return x, _packed(rng, kernel * kernel * c, n, pw)


# The grid of tests/test_conv.py: kernels {1,3,5} x strides {1,2} x
# (Pa, Pw) in {(8,8), (4,4), (8,11)}.
@pytest.mark.parametrize("kernel", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pa,pw", [(8, 8), (4, 4), (8, 11)])
def test_conv_plain_equals_pallas_and_ref(kernel, stride, pa, pw):
    x, wp = _conv_case(kernel, stride, pa, pw,
                       seed=kernel * 100 + stride * 10 + pw)
    want = np.asarray(jbitserial_conv(jnp.asarray(x), jnp.asarray(wp),
                                      kernel=kernel, stride=stride,
                                      w_bits=pw, bn=8))
    np.testing.assert_array_equal(
        want, np.asarray(jref.bitserial_conv_ref(
            jnp.asarray(x), jnp.asarray(wp), kernel=kernel, stride=stride,
            w_bits=pw)))
    before = bitserial_conv.launches
    for rows in (None, 1, 2):   # banding never changes a bit
        got = bitserial_conv(_t(x), _t(wp), kernel=kernel, stride=stride,
                             w_bits=pw, rows_per_band=rows)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bitserial_conv.launches == before


def test_conv_k_padding_rows():
    """C = 3 at k = 3: K = 27 packs to 32 rows; the pad rows add nothing."""
    x, wp = _conv_case(3, 1, 8, 8, b=1, h=8, c=3, n=32, seed=3)
    assert wp.shape == (8, 4, 32)
    want = np.asarray(jref.bitserial_conv_ref(jnp.asarray(x), jnp.asarray(wp),
                                              kernel=3, stride=1, w_bits=8))
    np.testing.assert_array_equal(
        ref.bitserial_conv_ref(_t(x), _t(wp), kernel=3, stride=1,
                               w_bits=8).numpy(), want)


# K2's banded oracle against JAX's: ragged N (13), k*k*C % 8 != 0 (C = 5),
# stride 2, (Pa, Pw) in {(8,8), (4,4), (8,11)}, bands of 1, 2 and 4 rows
# and one band larger than the map.
@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (5, 2)])
@pytest.mark.parametrize("pa,pw", [(8, 8), (4, 4), (8, 11)])
@pytest.mark.parametrize("rows", [1, 2, 4, 99])
def test_conv_banded_ref_equals_jax(kernel, stride, pa, pw, rows):
    x, wp = _conv_case(kernel, stride, pa, pw, n=13,
                       seed=kernel * 1000 + stride * 100 + pw * 10 + rows)
    args = dict(kernel=kernel, stride=stride, w_bits=pw)
    want = np.asarray(jref.bitserial_conv_banded_ref(
        jnp.asarray(x), jnp.asarray(wp), rows_per_band=rows, **args))
    got = ref.bitserial_conv_banded_ref(_t(x), _t(wp), rows_per_band=rows,
                                        **args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(   # banding never changes a bit
        ref.bitserial_conv_ref(_t(x), _t(wp), **args).numpy(), want)


@pytest.mark.parametrize("ho,wo,rows,kernel,stride",
                         [(32, 32, None, 3, 1), (9, 9, 4, 5, 2),
                          (5, 5, 99, 1, 1), (8, 8, 0, 3, 2)])
def test_band_geometry_matches_jax(ho, wo, rows, kernel, stride):
    assert band_geometry(ho, wo, rows, kernel, stride) == \
        jband_geometry(ho, wo, rows, kernel, stride)


def test_conv_rows_per_band_fits_shared_memory():
    # The paper CNN's maps fit one band per image.
    for h, c in [(32, 3), (16, 32), (8, 64)]:
        assert conv_rows_per_band(h, h, c, kernel=3, stride=1) == h
    # A 224x224x64 map does not: bands shrink until a block fits.
    rpb = conv_rows_per_band(224, 224, 64, kernel=3, stride=1)
    assert rpb < 224
    assert conv_smem_bytes(224, 224, 64, kernel=3, rows_per_band=rpb) \
        <= SMEM_BUDGET
    assert conv_smem_bytes(224, 224, 64, kernel=3, rows_per_band=2 * rpb) \
        > SMEM_BUDGET


@pytest.mark.parametrize("a_bits,w_bits,k", [(8, 8, 40), (6, 11, 27),
                                             (16, 16, 64)])
def test_linear_serve_matches_jax(a_bits, w_bits, k):
    rng = np.random.default_rng(k + w_bits)
    x = rng.normal(size=(5, k)).astype(np.float32)
    w = rng.normal(size=(k, 12)).astype(np.float32)
    wq, w_scale = jq.quantize(jnp.asarray(w), w_bits)
    wp = jbitpack.pack_weights(wq, w_bits)
    for axis in (-1, None):
        want = np.asarray(jops.loom_linear_serve(
            jnp.asarray(x), wp, w_scale, a_bits=a_bits, w_bits=w_bits,
            a_axis=axis))
        for be in ("torch_ref", "cuda"):
            got = ops.loom_linear_serve(_t(x), _t(wp), _t(w_scale),
                                        a_bits=a_bits, w_bits=w_bits,
                                        backend=be, a_axis=axis)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel,stride,a_bits,w_bits",
                         [(3, 1, 8, 8), (5, 2, 4, 11), (1, 1, 16, 16)])
def test_conv_serve_matches_jax(kernel, stride, a_bits, w_bits):
    rng = np.random.default_rng(kernel * 10 + w_bits)
    x = rng.normal(size=(2, 9, 9, 4)).astype(np.float32)
    w = rng.normal(size=(kernel * kernel * 4, 16)).astype(np.float32)
    wq, w_scale = jq.quantize(jnp.asarray(w), w_bits)
    wp = jbitpack.pack_weights(wq, w_bits)
    want = np.asarray(jops.loom_conv_serve(
        jnp.asarray(x), wp, w_scale, kernel=kernel, stride=stride,
        a_bits=a_bits))
    for be in ("torch_ref", "cuda"):
        got = ops.loom_conv_serve(_t(x), _t(wp), _t(w_scale), kernel=kernel,
                                  stride=stride, a_bits=a_bits, backend=be,
                                  conv_tile=2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_conv_accum_fits_f32_matches_jax():
    for args in [(27, 8, 8), (576, 8, 8), (1024, 8, 8), (1025, 8, 8),
                 (288, 8, 16)]:
        assert ops.conv_accum_fits_f32(*args) == jops.conv_accum_fits_f32(*args)


def test_backend_surface():
    assert backend.resolve_backend(None).name == "cuda"
    cuda = backend.resolve_backend("cuda")
    assert backend.resolve_backend(cuda) is cuda
    with pytest.raises(KeyError):
        backend.resolve_backend("pallas_tpu")
    x = torch.zeros((2, 8), dtype=torch.int8)
    wp = torch.zeros((8, 1, 4), dtype=torch.uint8)
    xc = x.reshape(1, 1, 2, 8)
    wc = _t(np.zeros((8, 9, 4), np.uint8))
    for be in ("torch_ref", "cuda"):
        b = backend.resolve_backend(be)
        # All-full counts keep the static path; a trimmed count takes K3/K4.
        for counts in ((8,), (7,)):
            assert b.matmul_planes(x, wp, w_bits=8,
                                   w_counts=counts).shape == (2, 4)
            assert b.conv_planes(xc, wc, kernel=3, stride=1, w_bits=8,
                                 w_counts=counts).shape == (1, 1, 2, 4)
        assert b.matmul_planes_dynamic(
            x, wp, torch.tensor([3, 8], dtype=torch.int32), w_bits=8,
            bn=2).shape == (2, 4)
        assert b.conv_planes_dynamic(
            xc, wc, torch.ones((1, 1), dtype=torch.int32), kernel=3, stride=1,
            w_bits=8, group_size=8).shape == (1, 1, 2, 4)
        # K6 and K7 (their plain versions on CPU tensors).
        xq, scale, eff = b.dynamic_quant(
            torch.linspace(-4, 4, 2 * 512).reshape(2, 512), group_size=256,
            bits=8)
        assert (xq.dtype, scale.dtype, eff.dtype) == (
            torch.int8, torch.float32, torch.int32)
        assert tuple(scale.shape) == tuple(eff.shape) == (2, 2)
        assert int(xq.abs().max()) == 127 and bool((eff == 8).all())
        qkv = torch.randn((1, 2, 8, 16), generator=torch.Generator().manual_seed(0))
        out = b.attention(qkv, qkv, qkv, causal=True, window=4)
        assert out.shape == qkv.shape and bool(torch.isfinite(out).all())
        assert torch.equal(out[:, :, 0], qkv[:, :, 0])   # row 0 sees key 0


def test_wrappers_reject_bad_operands():
    x = torch.zeros((2, 16), dtype=torch.int8)
    wp = torch.zeros((8, 2, 4), dtype=torch.uint8)
    with pytest.raises(TypeError):
        bitserial_matmul(x.to(torch.int32), wp, w_bits=8)
    with pytest.raises(ValueError):
        bitserial_matmul(x, wp, w_bits=7)
    with pytest.raises(ValueError):
        bitserial_matmul(x[:, :8], wp, w_bits=8)
    xc = torch.zeros((1, 4, 4, 2), dtype=torch.int8)
    with pytest.raises(ValueError):
        bitserial_conv(xc, torch.zeros((8, 3, 4), dtype=torch.uint8),
                       kernel=2, w_bits=8)
    with pytest.raises(ValueError):
        bitserial_conv(xc, torch.zeros((8, 2, 4), dtype=torch.uint8),
                       kernel=3, w_bits=8)
