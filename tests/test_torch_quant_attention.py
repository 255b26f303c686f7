"""PyTorch port, K6 ``dynamic_quant`` and K7 ``flash_attention`` on the CPU.

The port's plain versions (``kernels.ref``), its kernel wrappers (which take
the plain versions on CPU tensors) and both backends' ops are held against
the JAX package's oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode, on the same numpy inputs.

K6 is exact: ``xq``, the scale's bits and ``eff`` equal the oracle's,
including the groups where XLA:CPU's subnormal flushing decides the result
(an all-zero group, a group of absmax 2e-38, a subnormal element). Against
the jitted Pallas kernel the scale is held to rtol 1e-6, as the JAX tests
hold it: under jit XLA divides by qmax as a multiply by its reciprocal,
one ulp off the true division at some inputs.

K7 is a float op: f32 within rtol = atol = 2e-5 and bf16 within 0.05, the
JAX tests' own tolerances (``tests/test_kernels.py``).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dynamic_quant import dynamic_quant as jdynamic_quant
from repro.kernels.flash_attention import flash_attention as jflash_attention
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.flash_attention import flash_attention

BACKENDS = ("torch_ref", "cuda")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _assert_k6_equal(got, want, exact_scale=True):
    xq, scale, eff = (_np(t) for t in got)
    wq, ws, we = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(xq, wq)
    np.testing.assert_array_equal(eff, we)
    if exact_scale:
        np.testing.assert_array_equal(scale.view(np.int32),
                                      ws.astype(np.float32).view(np.int32))
    else:
        np.testing.assert_allclose(scale, ws, rtol=1e-6)


def _edge_groups() -> np.ndarray:
    """[4, 1024] f32: normal values, and in group 0 of each row one of the
    groups that subnormal flushing decides."""
    x = np.random.default_rng(7).normal(size=(4, 1024)).astype(np.float32)
    x[:, :256] = 0.0                                # row 0: an all-zero group
    x[1, :256] = 2e-38 * np.where(np.arange(256) % 2, 1, -1)  # absmax 2e-38
    x[2, 3] = 1e-39                                 # a subnormal in zeros
    x[3, 3], x[3, 4], x[3, 9] = 1e-36, 1e-38, -3e-39  # scale flushes at 8 bits
    return x


# ---------------------------------------------------------------------------
# K6 dynamic_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,g", [(4, 512, 256), (8, 256, 128),
                                   (16, 1024, 256)])
@pytest.mark.parametrize("bits", [4, 8])
def test_dynamic_quant_equals_jax(m, k, g, bits):
    x = np.random.default_rng(m * k).normal(size=(m, k)).astype(np.float32)
    want = jref.dynamic_quant_ref(jnp.asarray(x), g, bits)
    pallas = jdynamic_quant(jnp.asarray(x), group_size=g, bits=bits,
                            bm=min(4, m))
    got = dynamic_quant(torch.from_numpy(x), group_size=g, bits=bits)
    _assert_k6_equal(got, want)
    _assert_k6_equal(got, pallas, exact_scale=False)
    _assert_k6_equal(ref.dynamic_quant_ref(torch.from_numpy(x), g, bits), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_dynamic_quant_flushes_like_xla(bits):
    x = _edge_groups()
    want = jref.dynamic_quant_ref(jnp.asarray(x), 256, bits)
    got = dynamic_quant(torch.from_numpy(x), group_size=256, bits=bits)
    _assert_k6_equal(got, want)
    # Row 3's group mixes zeros into a flushed scale at 8 bits, where the
    # Pallas kernel departs from the oracle (the test below); rows 0-2 not.
    pallas = jdynamic_quant(jnp.asarray(x[:3]), group_size=256, bits=bits,
                            bm=3)
    _assert_k6_equal([t[:3] for t in got], pallas, exact_scale=False)
    xq, scale, eff = got
    tiny = np.finfo(np.float32).tiny
    flushed = 0.0 if tiny / ((1 << (bits - 1)) - 1) < tiny else tiny
    assert scale[0, 0] == flushed and eff[0, 0] == 1  # zero group
    assert abs(int(xq[1, 0])) >= (1 << (bits - 1)) - 1
    assert int(xq[2, 3]) == 0 and eff[2, 0] == 1      # the subnormal reads 0


def test_dynamic_quant_mixed_zero_scale_group_follows_the_oracle():
    """A group whose scale flushes to 0 and that holds zeros: 0/0 is NaN in
    the float path. The oracle takes max|xq| after the int8 cast (NaN ->
    0) and reports 8 bits; the Pallas kernel takes it on the floats, where
    the NaN wins, and reports 1. The port follows the oracle (ROADMAP
    queue C)."""
    x = np.zeros((1, 256), np.float32)
    x[0, 5] = 2e-38
    xq, scale, eff = dynamic_quant(torch.from_numpy(x), group_size=256)
    want = jref.dynamic_quant_ref(jnp.asarray(x), 256, 8)
    _assert_k6_equal((xq, scale, eff), want)
    assert int(xq[0, 5]) == 127 and int(eff[0, 0]) == 8
    pallas_eff = jdynamic_quant(jnp.asarray(x), group_size=256, bm=1)[2]
    assert int(pallas_eff[0, 0]) == 1


@pytest.mark.parametrize("m", [1, 13, 1000])
def test_dynamic_quant_ragged_rows(m):
    x = np.random.default_rng(m).normal(size=(m, 512)).astype(np.float32) * 3
    want = jref.dynamic_quant_ref(jnp.asarray(x), 256, 8)
    _assert_k6_equal(dynamic_quant(torch.from_numpy(x), group_size=256), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_quantize_activations_equals_jax(backend):
    x = np.random.default_rng(3).normal(size=(2, 5, 512))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    want = jops.quantize_activations(xj, group_size=128, bits=6,
                                     backend="xla")
    got = ops.quantize_activations(xt, group_size=128, bits=6,
                                   backend=backend)
    assert [tuple(t.shape) for t in got] == [(2, 5, 512), (2, 5, 4), (2, 5, 4)]
    _assert_k6_equal(got, want)


def test_dynamic_quant_rejects_bad_operands():
    x = torch.zeros((4, 512))
    with pytest.raises(ValueError, match="multiple"):
        dynamic_quant(x, group_size=200)
    with pytest.raises(ValueError, match="bits"):
        dynamic_quant(x, bits=9)
    with pytest.raises(TypeError):
        dynamic_quant(x.to(torch.bfloat16))
    with pytest.raises(TypeError):
        dynamic_quant(x[None])


# ---------------------------------------------------------------------------
# K7 flash_attention
# ---------------------------------------------------------------------------

def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    if dtype == "bf16":
        js = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
        ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16) for j in js]
        return js, ts
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("s,d,bq,bk", [(64, 16, 16, 16), (128, 32, 32, 64),
                                       (256, 64, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_sweep(s, d, bq, bk, causal):
    js, ts = _qkv((2, 2, s, d), s + d)
    want = np.asarray(jref.flash_attention_ref(*js, causal=causal))
    pallas = np.asarray(jflash_attention(*js, causal=causal, bq=bq, bk=bk))
    got = flash_attention(*ts, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_sliding_window(window):
    js, ts = _qkv((1, 2, 128, 16), window)
    want = np.asarray(jref.flash_attention_ref(*js, causal=True,
                                               window=window))
    pallas = np.asarray(jflash_attention(*js, causal=True, window=window,
                                         bq=32, bk=32))
    got = flash_attention(*ts, causal=True, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


def test_flash_attention_bf16():
    js, ts = _qkv((1, 1, 64, 32), 1, "bf16")
    want = np.asarray(jref.flash_attention_ref(*js), np.float32)
    pallas = np.asarray(jflash_attention(*js, bq=32, bk=32), np.float32)
    got = flash_attention(*ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 40),
                                           (True, 17)])
def test_flash_attention_ragged_sequence(causal, window):
    # S = 100 is no multiple of any block; the oracle needs none.
    js, ts = _qkv((1, 3, 100, 24), 5)
    want = np.asarray(jref.flash_attention_ref(*js, causal=causal,
                                               window=window))
    got = flash_attention(*ts, causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_attention_op_equals_jax(backend):
    js, ts = _qkv((2, 4, 64, 32), 9)
    want = np.asarray(jops.attention(*js, causal=True, window=24,
                                     backend="xla"))
    got = ops.attention(*ts, causal=True, window=24, backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_rejects_bad_operands():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q[:, :1], q)
    with pytest.raises(TypeError):
        flash_attention(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=0)
    big = torch.zeros((1, 1, 4, 264))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(big, big, big)
