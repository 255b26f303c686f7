"""PyTorch port, static per-filter-group weight trimming (paper Sec 4.6)
on the CPU.

Pack-time OR-tree counts per group of 16 output filters that fall below
Pw route the linear to K3 (``bitserial_matmul_dynamic`` with bn = the
filter group) and the conv to K4 (``bitserial_conv_wgroup``). Their plain
versions must equal the JAX package's Pallas kernels in interpret mode (as
tests/test_wgroup.py runs them) and its truncating oracles for forced low
counts, ragged last groups included. Trimming with the OR-tree's own
counts is value-preserving: path W (skewed weights, ``uniform_policy(8,
8)``), and path W composed with ``dynamic_a``, give the logits of JAX's
un-jitted ``cnn.forward`` and of the untrimmed static path.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.api.backend import get_backend
from repro.configs import paper_cnn as jpaper_cnn
from repro.core import bitpack as jbitpack, quantize as jq
from repro.core import weightgroups as jwg
from repro.core.policy import uniform_policy as juniform_policy
from repro.kernels import ops as jops, ref as jref
from repro.kernels.bitserial_conv import (
    bitserial_conv_wgroup as jbitserial_conv_wgroup)
from repro.models import cnn as jcnn
import repro_torch
from repro_torch import configs
from repro_torch.api import backend
from repro_torch.core.policy import uniform_policy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitserial_conv import bitserial_conv_wgroup
from repro_torch.kernels.bitserial_matmul import bitserial_matmul_dynamic

PRECISIONS = [(8, 8), (4, 4), (8, 11)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _skewed(rng, k, n, quiet):
    """f32 weights whose ``quiet`` columns are scaled far below the
    per-tensor absmax, so their filter groups pack to fewer planes."""
    wf = rng.normal(size=(k, n)).astype(np.float32)
    wf[:, quiet] *= 0.04
    return wf


def _pack(wf, pw):
    wq, ws = jq.quantize(jnp.asarray(wf), pw)
    counts = tuple(int(c) for c in
                   np.asarray(jwg.weight_group_counts(wq, pw, 16)))
    return np.asarray(jbitpack.pack_weights(wq, pw)), np.asarray(ws), counts


def _random_packed(rng, k, n, pw):
    wq = rng.integers(jq.qmin(pw), jq.qmax(pw) + 1, size=(k, n))
    return np.asarray(jbitpack.pack_weights(jnp.asarray(wq, jnp.int32), pw))


# ---------------------------------------------------------------------------
# K3 as the weight-group linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [32, 40])          # whole and ragged groups
@pytest.mark.parametrize("pw", [8, 11])
def test_linear_forced_counts_match_pallas_and_oracle(n, pw):
    rng = np.random.default_rng(n + pw)
    m, k = 8, 24
    wp = _random_packed(rng, k, n, pw)
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    forced = (3, pw - 1, 1)[:-(-n // 16)]
    want = np.asarray(jref.bitserial_matmul_wgroup_ref(
        jnp.asarray(xq), jnp.asarray(wp), jnp.asarray(forced), pw, 16))
    np.testing.assert_array_equal(want, np.asarray(
        get_backend("pallas_interpret").matmul_planes(
            jnp.asarray(xq), jnp.asarray(wp), w_bits=pw, a_bits=8,
            w_counts=forced, w_group=16)))
    before = bitserial_matmul_dynamic.launches
    got = bitserial_matmul_dynamic(_t(xq), _t(wp),
                                   torch.tensor(forced, dtype=torch.int32),
                                   w_bits=pw, bn=16)
    np.testing.assert_array_equal(got.numpy(), want)
    for be in ("torch_ref", "cuda"):
        got = backend.resolve_backend(be).matmul_planes(
            _t(xq), _t(wp), w_bits=pw, w_counts=forced, w_group=16)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bitserial_matmul_dynamic.launches == before       # CPU: plain


@pytest.mark.parametrize("pa,pw", PRECISIONS)
def test_linear_trimmed_equals_untrimmed(pa, pw):
    rng = np.random.default_rng(1)
    m, k, n = 12, 40, 48
    wp, ws, counts = _pack(_skewed(rng, k, n, slice(n // 2, None)), pw)
    assert min(counts) < pw                  # the trim is real
    x = rng.normal(size=(m, k)).astype(np.float32)
    kw = dict(a_bits=pa, w_bits=pw)
    want = np.asarray(jops.loom_linear_serve(jnp.asarray(x), wp, ws,
                                             backend="xla", **kw))
    for be in ("torch_ref", "cuda"):
        got = ops.loom_linear_serve(_t(x), _t(wp), _t(ws), backend=be,
                                    w_counts=counts, w_group=16, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# K4: bitserial_conv_wgroup
# ---------------------------------------------------------------------------

CONV_GRID = ([(k, s, 8, 8) for k in (1, 3, 5) for s in (1, 2)]
             + [(k, s, pa, pw) for k, s in ((3, 1), (5, 2))
                for pa, pw in PRECISIONS[1:]])


@pytest.mark.parametrize("kernel,stride,pa,pw", CONV_GRID)
def test_conv_forced_counts_match_pallas_and_oracle(kernel, stride, pa, pw):
    rng = np.random.default_rng(kernel * 10 + stride + pw)
    b, h, c, n = 2, 6, 2, 32
    wp = _random_packed(rng, kernel * kernel * c, n, pw)
    xq = rng.integers(jq.qmin(pa), jq.qmax(pa) + 1,
                      size=(b, h, h, c)).astype(np.int8)
    forced = np.array([4, pw - 2], np.int32)
    args = dict(kernel=kernel, stride=stride, w_bits=pw)
    want = np.asarray(jref.bitserial_conv_wgroup_ref(
        jnp.asarray(xq), jnp.asarray(wp), jnp.asarray(forced), w_group=16,
        **args))
    np.testing.assert_array_equal(want, np.asarray(jbitserial_conv_wgroup(
        jnp.asarray(xq), jnp.asarray(wp), jnp.asarray(forced), bn=16,
        rows_per_band=2, **args)))
    before = bitserial_conv_wgroup.launches
    for rows in (None, 1, 2):               # banding never changes a bit
        got = bitserial_conv_wgroup(_t(xq), _t(wp), _t(forced),
                                    rows_per_band=rows, **args)
        np.testing.assert_array_equal(got.numpy(), want)
    for be in ("torch_ref", "cuda"):
        got = backend.resolve_backend(be).conv_planes(
            _t(xq), _t(wp), conv_tile=2, w_counts=tuple(forced.tolist()),
            w_group=16, **args)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bitserial_conv_wgroup.launches == before
    static = ref.bitserial_conv_ref(_t(xq), _t(wp), **args).numpy()
    assert not np.array_equal(want, static)  # the counts truncate


def test_conv_ragged_and_all_zero_group():
    """N = 40: groups 16/16/8, the quiet middle one trimmed and the ragged
    all-zero tail at the 1-plane floor; equal to JAX and to untrimmed."""
    rng = np.random.default_rng(6)
    b, h, c, n, pa, pw = 2, 8, 3, 40, 8, 8
    wf = _skewed(rng, 9 * c, n, slice(16, 32))
    wf[:, 32:] = 0.0
    wp, ws, counts = _pack(wf, pw)
    assert len(counts) == 3 and counts[2] == 1 and counts[1] < pw
    x = rng.normal(size=(b, h, h, c)).astype(np.float32)
    kw = dict(kernel=3, stride=1, a_bits=pa)
    want = np.asarray(jops.loom_conv_serve(jnp.asarray(x), wp, ws,
                                           backend="pallas_interpret",
                                           w_counts=counts, w_group=16, **kw))
    np.testing.assert_array_equal(
        want, np.asarray(jops.loom_conv_serve(jnp.asarray(x), wp, ws,
                                              backend="xla", **kw)))
    for be in ("torch_ref", "cuda"):
        got = ops.loom_conv_serve(_t(x), _t(wp), _t(ws), backend=be,
                                  conv_tile=3, w_counts=counts, w_group=16,
                                  **kw)
        np.testing.assert_array_equal(got.numpy(), want)
    assert not want[..., 32:].any()          # zero filters stay zero


@pytest.mark.parametrize("kernel,stride,pa,pw",
                         [(1, 1, 8, 8), (3, 2, 4, 4), (5, 1, 8, 11)])
def test_conv_trimmed_equals_untrimmed(kernel, stride, pa, pw):
    rng = np.random.default_rng(4)
    b, h, c, n = 2, 6, 3, 24
    wp, ws, counts = _pack(_skewed(rng, kernel * kernel * c, n,
                                   slice(n // 2, None)), pw)
    assert min(counts) < pw
    x = rng.normal(size=(b, h, h, c)).astype(np.float32)
    kw = dict(kernel=kernel, stride=stride, a_bits=pa)
    want = np.asarray(jops.loom_conv_serve(jnp.asarray(x), wp, ws,
                                           backend="xla", **kw))
    for be in ("torch_ref", "cuda"):
        got = ops.loom_conv_serve(_t(x), _t(wp), _t(ws), backend=be,
                                  w_counts=counts, w_group=16, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Composition with dynamic_a
# ---------------------------------------------------------------------------

def test_linear_compose_dynamic_a():
    rng = np.random.default_rng(3)
    m, k, n, pa, pw = 24, 40, 48, 8, 11
    wp, ws, counts = _pack(_skewed(rng, k, n, slice(0, 16)), pw)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[m // 2:] *= 0.02
    kw = dict(a_bits=pa, w_bits=pw, group_size=8, w_counts=counts,
              w_group=16)
    want = np.asarray(jops.loom_linear_serve_dynamic(
        jnp.asarray(x), wp, ws, backend="xla", **kw))
    static = ops.loom_linear_serve(_t(x), _t(wp), _t(ws), a_bits=pa,
                                   w_bits=pw)
    np.testing.assert_array_equal(static.numpy(), want)
    for be in ("torch_ref", "cuda"):
        got = ops.loom_linear_serve_dynamic(_t(x), _t(wp), _t(ws),
                                            backend=be, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_conv_compose_dynamic_a():
    rng = np.random.default_rng(8)
    b, h, c, n, pa, pw = 2, 8, 3, 32, 8, 8
    wp, ws, counts = _pack(_skewed(rng, 9 * c, n, slice(16, None)), pw)
    x = rng.normal(size=(b, h, h, c)).astype(np.float32)
    x[:, h // 2:] *= 0.02
    kw = dict(kernel=3, stride=1, a_bits=pa)
    want = np.asarray(jops.loom_conv_serve_dynamic(
        jnp.asarray(x), wp, ws, group_size=16, backend="xla",
        w_counts=counts, w_group=16, **kw))
    np.testing.assert_array_equal(
        ops.loom_conv_serve(_t(x), _t(wp), _t(ws), **kw).numpy(), want)
    for be in ("torch_ref", "cuda"):
        got = ops.loom_conv_serve_dynamic(_t(x), _t(wp), _t(ws),
                                          group_size=16, backend=be,
                                          w_counts=counts, w_group=16, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Plan and the path as a whole
# ---------------------------------------------------------------------------

def test_plan_resolves_w_group_and_setter():
    plan = repro_torch.build_plan(None, uniform_policy(8, 8, w_group=32),
                                  mode="serve_packed")
    lp = plan.layer("fc0")
    assert lp.w_group == 32 and lp.w_group_counts is None
    plan.set_weight_counts("fc0", "linear", (np.int32(8), np.int32(4)))
    lp = plan.layer("fc0")
    assert lp.w_group_counts == (8, 4)
    assert all(isinstance(c, int) for c in lp.w_group_counts)
    assert plan.set_weight_counts("fc0", "linear", (8,), w_group=64).w_group \
        == 64


def _skewed_params(jcfg):
    """JAX init, then every other group of 16 output filters of every
    layer scaled by 1/32: those groups pack to fewer weight planes."""
    params, specs = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.array, params)
    for p in params.values():
        for g in range(1, -(-p["w"].shape[1] // 16), 2):
            p["w"][:, g * 16:(g + 1) * 16] /= 32
    return params, specs


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_path_w_and_composition_match_jax_and_static(size):
    """Path W (skewed weights, w_group 16) and path W under dynamic_a, at
    batch 2: the plan records JAX's counts, every trimmable layer has a
    count below Pw, and the logits equal JAX's un-jitted forward and the
    untrimmed (w_group=0) static path."""
    smoke = size == "smoke"
    jcfg = jpaper_cnn.smoke_config() if smoke else jpaper_cnn.config()
    params, specs = _skewed_params(jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, jcfg.img, jcfg.img, 3)).astype(np.float32)
    x[:, jcfg.img // 2:] *= 0.02
    cfg = configs.get("paper_cnn", smoke=smoke)
    static = repro_torch.compile(cfg, uniform_policy(8, 8, w_group=0),
                                 mode="serve_packed", params=params,
                                 device="cpu").classify(x).numpy()
    for dyn in (False, True):
        sess = loom.compile(jcfg, juniform_policy(8, 8, dynamic_a=dyn),
                            mode="serve_packed", backend="xla",
                            params=jax.tree.map(jnp.asarray, params),
                            specs=specs)
        want = np.asarray(jcnn.forward(sess.params, jcfg, jnp.asarray(x),
                                       sess.plan))
        np.testing.assert_array_equal(static, want)
        for be in ("cuda", "torch_ref"):
            tsess = repro_torch.compile(
                cfg, uniform_policy(8, 8, dynamic_a=dyn), mode="serve_packed",
                backend=be, params=params, device="cpu")
            np.testing.assert_array_equal(tsess.classify(x).numpy(), want)
        for key, lp in tsess.plan.layers.items():
            assert lp.w_group_counts == sess.plan.layer(*key).w_group_counts
            # Only a layer of one group (fc1: 10 columns) stays full.
            assert (min(lp.w_group_counts) < 8) == (len(lp.w_group_counts) > 1)
