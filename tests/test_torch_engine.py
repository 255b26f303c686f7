"""PyTorch port: the plane-width engine (``repro_torch/core/engine.py``)
against the JAX package's ``repro/core/engine.py``.

Same numpy operands through both. ``plane_matmul`` must be
``torch.equal`` (tolerance 0) to JAX's and to the port's oracle
``reference_int_matmul`` on the reference tests' cases
(``tests/test_core.py``: (8, 8), (7, 11), (5, 12), (16, 16), plane widths
1, 2, 4 and 8, both modes, the property grid), including int32 sums that
wrap. The exact product's two routes (int8 ``_int_mm``, float64) are
each driven on the CPU; ``loom_matmul`` equals the un-jitted JAX forward
bit for bit. JAX's ``plane_matmul`` is integer arithmetic alone, so it
runs jitted here (one compile per case instead of one per primitive);
the operands come from the port's ``quantize``, equal to JAX's eager one.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as je, quantize as jq
from repro_torch.core import engine, quantize as q


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


_jplane = jax.jit(je.plane_matmul, static_argnums=2)


def _quantized(shape, seed, bits):
    return q.quantize(torch.from_numpy(rand(shape, seed)), bits)[0].numpy()


def _both(xq, wq, **kw):
    """plane_matmul in both packages on the same int32 numpy operands."""
    got = engine.plane_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                              engine.LoomConfig(**kw))
    want = np.asarray(_jplane(jnp.asarray(xq), jnp.asarray(wq),
                              je.LoomConfig(**kw)))
    oracle = engine.reference_int_matmul(torch.from_numpy(xq),
                                         torch.from_numpy(wq))
    return got, want, oracle


_GRID = [(mode, pb, a, w)
         for mode, pb, (a, w) in itertools.product(
             ["serial_both", "serial_weights"], [1, 2, 4, 8],
             [(8, 8), (7, 11), (5, 12), (16, 16)])
         if not (a == w == 16 and pb == 1)]


@pytest.mark.parametrize("mode,pb,a_bits,w_bits", _GRID)
def test_plane_matmul_equals_jax_and_the_oracle(mode, pb, a_bits, w_bits):
    xq, wq = _quantized((6, 32), 1, a_bits), _quantized((32, 10), 2, w_bits)
    got, want, oracle = _both(xq, wq, a_bits=a_bits, w_bits=w_bits,
                              a_plane_bits=pb, w_plane_bits=pb, mode=mode)
    assert got.dtype == torch.int32 and got.shape == (6, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("pb", [2, 4, 8])
@pytest.mark.parametrize("mode", ["serial_both", "serial_weights"])
def test_plane_matmul_wraps_like_int32_at_16_bits(mode, pb):
    """(16, 16) operands near full scale over K = 16: the exact sum
    passes 2^31, and every result wraps as JAX's int32 sums do."""
    rng = np.random.default_rng(pb)
    xq = rng.integers(-32768, 32768, size=(5, 16)).astype(np.int32)
    wq = rng.integers(-32768, 32768, size=(16, 7)).astype(np.int32)
    xq[0], wq[:, 0] = -32768, -32768                  # 2^34: wraps to 0
    xq[1], wq[:, 1] = 32767, -32768
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert np.abs(exact).max() >= 1 << 31
    got, want, oracle = _both(xq, wq, a_bits=16, w_bits=16, a_plane_bits=pb,
                              w_plane_bits=pb, mode=mode)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.int32))
    assert torch.equal(got, oracle)


@pytest.mark.parametrize("seed", range(6))
def test_plane_matmul_property_grid(seed):
    """The reference's property test: random precisions and plane widths."""
    rng = np.random.default_rng(1000 + seed)
    for _ in range(3):
        a_bits, w_bits = int(rng.integers(2, 9)), int(rng.integers(2, 13))
        pb = int(rng.choice([1, 2, 4]))
        xq = rng.integers(q.qmin(a_bits), q.qmax(a_bits) + 1,
                          size=(3, 16)).astype(np.int32)
        wq = rng.integers(q.qmin(w_bits), q.qmax(w_bits) + 1,
                          size=(16, 5)).astype(np.int32)
        got, want, oracle = _both(xq, wq, a_bits=a_bits, w_bits=w_bits,
                                  a_plane_bits=pb, w_plane_bits=pb)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, oracle)


def test_product_route_choice():
    # Planes of width <= 7, and one signed plane of <= 8 bits, fit int8.
    assert engine.plane_range(8, 1) == (-1, 1)     # signed top plane
    assert engine.plane_range(8, 7) == (-64, 127)
    assert engine.plane_range(8, 8) == (-128, 127)
    assert engine.plane_range(5, 8) == (-16, 15)
    assert engine.plane_range(16, 8) == (-128, 255)     # unsigned low plane
    assert engine.product_route(2048, (-128, 127), (-128, 127)) == "int8"
    assert engine.product_route(2048, (-128, 255), (-128, 127)) == "float64"
    assert engine.product_route(2048, (-32768, 32767), (-128, 127)) == "float64"
    # An int8 product whose int32 sum could wrap takes float64 instead.
    assert engine.product_route(1 << 17, (-128, 127), (-128, 127)) == "float64"
    with pytest.raises(ValueError, match="2\\^53"):
        engine.product_route(1 << 24, (-32768, 32767), (-32768, 32767))


@pytest.mark.parametrize("route", ["int8", "float64"])
def test_both_product_routes_are_exact(route):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-128, 128, size=(40, 72)))
    w = torch.from_numpy(rng.integers(-128, 128, size=(72, 24)))
    got = engine.exact_product(a, w, route)
    assert got.dtype == torch.int64
    assert torch.equal(got, a @ w)
    with pytest.raises(ValueError):
        engine.exact_product(a, w, "float32")


@pytest.mark.parametrize("a_bits,w_bits,pb,mode,route", [
    (8, 8, 8, "serial_both", "int8"), (8, 8, 1, "serial_both", "int8"),
    (16, 8, 8, "serial_both", "float64"),
    (16, 8, 8, "serial_weights", "float64")])
def test_plane_matmul_takes_the_expected_route(monkeypatch, a_bits, w_bits,
                                               pb, mode, route):
    """The card's cases: LM_8b and LM_1b at (8, 8) on int8; LM_8b at
    (16, 8) (an unsigned low activation plane) and ``serial_weights`` at
    (16, 8) (whole 16-bit activations) on float64."""
    taken = []
    exact = engine.exact_product
    monkeypatch.setattr(engine, "exact_product",
                        lambda a, w, r: taken.append(r) or exact(a, w, r))
    xq = np.random.default_rng(4).integers(
        q.qmin(a_bits), q.qmax(a_bits) + 1, size=(9, 64)).astype(np.int32)
    wq = np.random.default_rng(5).integers(
        q.qmin(w_bits), q.qmax(w_bits) + 1, size=(64, 12)).astype(np.int32)
    got, want, oracle = _both(xq, wq, a_bits=a_bits, w_bits=w_bits,
                              a_plane_bits=pb, w_plane_bits=pb, mode=mode)
    assert taken == [route]
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, oracle)


def test_reference_int_matmul_over_row_blocks():
    """The oracle's row blocks (about 2^25 products at a time) and leading
    dims give the one product."""
    rng = np.random.default_rng(6)
    xq = torch.from_numpy(rng.integers(-99, 99, size=(2, 3, 300)))
    wq = torch.from_numpy(rng.integers(-99, 99, size=(300, 25000)))
    got = engine.reference_int_matmul(xq, wq)          # blocks of 4 rows
    assert got.shape == (2, 3, 25000) and got.dtype == torch.int32
    assert torch.equal(got, (xq @ wq).to(torch.int32))


def test_loom_matmul_equals_unjitted_jax():
    x, w = rand((8, 64), 3), rand((64, 16), 4, scale=0.1)
    kw = dict(a_bits=8, w_bits=8, a_plane_bits=4, w_plane_bits=4)
    want = np.asarray(je.loom_matmul(jnp.asarray(x), jnp.asarray(w),
                                     je.LoomConfig(**kw)))
    got = engine.loom_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             engine.LoomConfig(**kw))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # 8-bit quantization error bound (the reference test's).
    np.testing.assert_allclose(got.numpy(), x @ w, atol=0.15, rtol=0.1)
    # Pre-quantized serving weights.
    wq, ws = q.quantize(torch.from_numpy(w), 6)
    cfg = engine.LoomConfig(a_bits=8, w_bits=6, a_plane_bits=2,
                            w_plane_bits=2)
    jwq, jws = jq.quantize(jnp.asarray(w), 6)
    want = np.asarray(je.loom_matmul(jnp.asarray(x), None,
                                     je.LoomConfig(**vars(cfg)),
                                     w_scale=jws, wq=jwq))
    got = engine.loom_matmul(torch.from_numpy(x), None, cfg, w_scale=ws,
                             wq=wq)
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_k_matmul_and_the_speedup_laws():
    xq, wq = _quantized((4, 64), 5, 7), _quantized((64, 6), 6, 9)
    kw = dict(a_bits=7, w_bits=9, a_plane_bits=4, w_plane_bits=4)
    jsplit = jax.jit(je.split_k_matmul, static_argnums=(2, 3))
    for n in (2, 4, 8):
        got = engine.split_k_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                                    engine.LoomConfig(**kw), n)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsplit(jnp.asarray(xq), jnp.asarray(wq),
                                           je.LoomConfig(**kw), n)))
    with pytest.raises(ValueError):
        engine.split_k_matmul(torch.from_numpy(xq), torch.from_numpy(wq),
                              engine.LoomConfig(**kw), 5)
    for a, w, ba, bw, mode in itertools.product(
            (5, 8, 16), (3, 8, 11), (1, 2, 4, 8), (1, 2, 4, 8),
            ("serial_both", "serial_weights")):
        kw = dict(a_bits=a, w_bits=w, a_plane_bits=ba, w_plane_bits=bw,
                  mode=mode)
        t, j = engine.LoomConfig(**kw), je.LoomConfig(**kw)
        assert (t.n_a_planes, t.n_w_planes) == (j.n_a_planes, j.n_w_planes)
        for base in (8, 16):
            assert t.speedup_vs_base(base) == j.speedup_vs_base(base)
    c = engine.LoomConfig(a_bits=8, w_bits=8, a_plane_bits=1, w_plane_bits=1)
    assert c.speedup_vs_base() == 256 / 64
    f = engine.LoomConfig(a_bits=16, w_bits=8, w_plane_bits=1,
                          mode="serial_weights")
    assert f.speedup_vs_base() == 2.0
