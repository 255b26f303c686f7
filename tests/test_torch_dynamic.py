"""PyTorch port, runtime activation trimming (``dynamic_a``) on the CPU.

The port's OR-tree counts, its plain K3 (``bitserial_matmul_dynamic``)
and K5 (``bitserial_conv_dynamic``) and its dynamic serving ops must equal
the JAX package's bit for bit: its Pallas kernels run in interpret mode,
as tests/test_conv_dynamic.py runs them, its ref.py oracles, and its
``xla`` backend. Counts below the OR-tree's (forced low) really truncate,
so the plane-skip semantics are checked, not only the identity case. The
path as a whole (``uniform_policy(8, 8, dynamic_a=True)``) must give the
logits of JAX's un-jitted ``cnn.forward`` and of the port's static path.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.api.backend import get_backend
from repro.configs import paper_cnn as jpaper_cnn
from repro.core import bitpack as jbitpack, dynamic as jdynamic
from repro.core import quantize as jq
from repro.core.policy import uniform_policy as juniform_policy
from repro.kernels import ops as jops, ref as jref
from repro.kernels.bitserial_conv import (
    bitserial_conv_dynamic as jbitserial_conv_dynamic)
from repro.kernels.bitserial_matmul import (
    bitserial_matmul_dynamic as jbitserial_matmul_dynamic)
from repro.models import cnn as jcnn
import repro_torch
from repro_torch import configs
from repro_torch.api import backend
from repro_torch.core import dynamic, quantize as q
from repro_torch.core.policy import uniform_policy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bitserial_conv import bitserial_conv_dynamic
from repro_torch.kernels.bitserial_matmul import bitserial_matmul_dynamic

PRECISIONS = [(8, 8), (4, 4), (8, 11)]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _skewed_map(rng, b, h, c):
    """Maps whose regions differ in magnitude, so window groups trim: the
    bottom half scaled by 0.02, a corner by 0.001."""
    x = rng.normal(size=(b, h, h, c)).astype(np.float32)
    x[:, h // 2:] *= 0.02
    x[:, :2, :2] *= 0.001
    return x


def _packed(rng, k, n, bits):
    wq = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                      size=(k, n)).astype(np.int32)
    return np.asarray(jbitpack.pack_weights(jnp.asarray(wq), bits))


# ---------------------------------------------------------------------------
# core: OR-tree counts and subplanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 1), (3, 2), (5, 2)])
@pytest.mark.parametrize("group", [8, 16, 64])
def test_conv_window_group_counts_match_jax(kernel, stride, group):
    rng = np.random.default_rng(kernel * 10 + stride + group)
    x = _skewed_map(rng, 2, 9, 3)
    x[1] = 0.0                                   # an all-zero image: floor
    xq, _ = jq.quantize(jnp.asarray(x), 8)
    want = np.asarray(jdynamic.conv_window_group_counts(xq, kernel, stride,
                                                        group, 8))
    got = dynamic.conv_window_group_counts(_t(xq), kernel, stride, group, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.min() >= 1 and want.max() <= 8


def test_group_counts_match_jax():
    rng = np.random.default_rng(0)
    xq = rng.integers(-128, 128, size=(24, 40)).astype(np.int32)
    xq[8:16] //= 64                              # a quiet row group
    xq[16:, :] = 0                               # an all-zero row group
    xq[0, 0] = -128                              # qmin: detector says 9
    for group in (7, 16, 40):                    # ragged and exact
        np.testing.assert_array_equal(
            dynamic.group_effective_bits(_t(xq), group).numpy(),
            np.asarray(jdynamic.group_effective_bits(jnp.asarray(xq), group)))
    want = np.asarray(jdynamic.serve_group_counts(jnp.asarray(xq), 8, 8))
    got = dynamic.serve_group_counts(_t(xq), 8, 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.tolist() == [8, 3, 1]
    with pytest.raises(ValueError):
        dynamic.serve_group_counts(_t(xq), 7, 8)


@pytest.mark.parametrize("bits,width", [(8, 7), (11, 7), (16, 7), (8, 4)])
def test_group_planes_matches_jax(bits, width):
    rng = np.random.default_rng(bits + width)
    v = rng.integers(jq.qmin(bits), jq.qmax(bits) + 1,
                     size=(6, 5)).astype(np.int32)
    v[0, :2] = [jq.qmin(bits), jq.qmax(bits)]
    planes, shifts = jq.group_planes(jnp.asarray(v), bits, width)
    got_planes, got_shifts = q.group_planes(_t(v), bits, width)
    np.testing.assert_array_equal(got_planes.numpy(), np.asarray(planes))
    np.testing.assert_array_equal(got_shifts.numpy(), np.asarray(shifts))
    assert torch.equal((got_planes * got_shifts[:, None, None]).sum(0),
                       _t(v).to(torch.int64))
    if width == 7:                               # the int8 kernel operand
        assert got_planes.min() >= -128 and got_planes.max() <= 127


# ---------------------------------------------------------------------------
# K3: bitserial_matmul_dynamic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bn", [(8, 64, 32, 16), (16, 40, 24, 8),
                                      (10, 256, 256, 256)])
@pytest.mark.parametrize("w_bits", [4, 8])
@pytest.mark.parametrize("forced", [True, False])
def test_matmul_dynamic_plain_equals_pallas_and_ref(m, k, n, bn, w_bits,
                                                    forced):
    rng = np.random.default_rng(m + k + n + w_bits)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    wp = _packed(rng, k, n, w_bits)
    counts = (rng.integers(1, w_bits + 1, size=n // bn) if forced
              else np.full(n // bn, w_bits)).astype(np.int32)
    want = np.asarray(jbitserial_matmul_dynamic(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(counts), w_bits=w_bits,
        bm=m, bn=bn, bk=k))
    np.testing.assert_array_equal(want, np.asarray(
        jref.bitserial_matmul_dynamic_ref(jnp.asarray(x), jnp.asarray(wp),
                                          jnp.asarray(counts), w_bits, bn)))
    before = bitserial_matmul_dynamic.launches
    got = bitserial_matmul_dynamic(_t(x), _t(wp), _t(counts), w_bits=w_bits,
                                   bn=bn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert bitserial_matmul_dynamic.launches == before   # CPU: plain
    static = np.asarray(jref.bitserial_matmul_ref(jnp.asarray(x),
                                                  jnp.asarray(wp), w_bits))
    assert np.array_equal(want, static) != forced        # forced truncates


# ---------------------------------------------------------------------------
# K5: bitserial_conv_dynamic
# ---------------------------------------------------------------------------

# Kernels {1, 3, 5} x strides {1, 2} at (Pa, Pw) = (8, 8), and the other
# two precisions at two of those geometries.
CONV_GRID = ([(k, s, 8, 8) for k in (1, 3, 5) for s in (1, 2)]
             + [(k, s, pa, pw) for k, s in ((3, 1), (5, 2))
                for pa, pw in PRECISIONS[1:]])


@pytest.mark.parametrize("kernel,stride,pa,pw", CONV_GRID)
def test_conv_dynamic_plain_equals_pallas_and_ref(kernel, stride, pa, pw):
    """Forced low counts in [1, Pa], groups of 8 windows (ragged: 49 or 16
    windows): the port's backends equal JAX's Pallas route and oracle, and
    K5's band-local oracle equals them at every band size."""
    rng = np.random.default_rng(kernel * 100 + stride * 10 + pw)
    b, h, c, n, gsz = 2, 7, 3, 16, 8
    xq = rng.integers(jq.qmin(pa), jq.qmax(pa) + 1,
                      size=(b, h, h, c)).astype(np.int8)
    wp = _packed(rng, kernel * kernel * c, n, pw)
    nwin = (-(-h // stride)) ** 2
    counts = rng.integers(1, pa + 1, size=(b, -(-nwin // gsz))).astype(np.int32)
    args = dict(kernel=kernel, stride=stride, w_bits=pw, group_size=gsz)
    want = np.asarray(jref.bitserial_conv_dynamic_ref(
        jnp.asarray(xq), jnp.asarray(wp), jnp.asarray(counts), **args))
    np.testing.assert_array_equal(want, np.asarray(
        get_backend("pallas_interpret").conv_planes_dynamic(
            jnp.asarray(xq), jnp.asarray(wp), jnp.asarray(counts), a_bits=pa,
            **args)))
    np.testing.assert_array_equal(
        ref.bitserial_conv_dynamic_ref(_t(xq), _t(wp), _t(counts),
                                       **args).numpy(), want)
    for rows in (None, 1, 2):
        np.testing.assert_array_equal(ref.bitserial_conv_dynamic_banded_ref(
            _t(xq), _t(wp), _t(counts), rows_per_band=rows, **args).numpy(),
            want)
    before = bitserial_conv_dynamic.launches
    for be in ("torch_ref", "cuda"):
        got = backend.resolve_backend(be).conv_planes_dynamic(
            _t(xq), _t(wp), _t(counts), conv_tile=2, **args)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bitserial_conv_dynamic.launches == before
    static = np.asarray(jref.bitserial_conv_ref(
        jnp.asarray(xq), jnp.asarray(wp), kernel=kernel, stride=stride,
        w_bits=pw))
    assert not np.array_equal(want, static)       # the counts truncate


@pytest.mark.parametrize("kernel,stride", [(3, 1), (5, 2)])
def test_conv_dynamic_wrapper_equals_pallas_kernel(kernel, stride):
    """The wrapper on int8 [K8, N] weights (C = 3: K8 pads k*k*C) against
    the Pallas kernel on the same operands."""
    rng = np.random.default_rng(kernel + stride)
    b, h, c, n, gsz = 2, 8, 3, 24, 16
    x = rng.integers(-128, 128, size=(b, h, h, c)).astype(np.int8)
    k8 = -(-kernel * kernel * c // 8) * 8
    wq = rng.integers(-128, 128, size=(k8, n)).astype(np.int8)
    nwin = (-(-h // stride)) ** 2
    counts = rng.integers(1, 9, size=(b, -(-nwin // gsz))).astype(np.int32)
    want = np.asarray(jbitserial_conv_dynamic(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(counts), kernel=kernel,
        stride=stride, a_bits=8, group_size=gsz))
    got = bitserial_conv_dynamic(_t(x), _t(wq), _t(counts), kernel=kernel,
                                 stride=stride, group_size=gsz,
                                 rows_per_band=3)
    np.testing.assert_array_equal(got.numpy(), want)
    # The reference's group-aligned band oracle agrees with K5's row bands.
    wp = jbitpack.pack_weights(jnp.asarray(wq, jnp.int32), 8)
    args = dict(kernel=kernel, stride=stride, w_bits=8, group_size=gsz)
    np.testing.assert_array_equal(want, np.asarray(
        jref.bitserial_conv_dynamic_banded_ref(
            jnp.asarray(x), wp, jnp.asarray(counts), **args)))
    np.testing.assert_array_equal(ref.bitserial_conv_dynamic_banded_ref(
        _t(x), _t(wp), _t(counts), rows_per_band=3, **args).numpy(), want)


def test_conv_dynamic_wrapper_rejects_bad_operands():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.int8)
    wq = torch.zeros((32, 8), dtype=torch.int8)
    ok = torch.ones((1, 2), dtype=torch.int32)
    assert bitserial_conv_dynamic(x, wq, ok, kernel=3,
                                  group_size=8).shape == (1, 4, 4, 8)
    with pytest.raises(TypeError):              # K8 = 32, not 27
        bitserial_conv_dynamic(x, wq[:27], ok, kernel=3, group_size=8)
    with pytest.raises(ValueError):             # 16 windows / 8 = 2 groups
        bitserial_conv_dynamic(x, wq, ok[:, :1], kernel=3, group_size=8)
    with pytest.raises(ValueError):
        bitserial_conv_dynamic(x, wq, ok.to(torch.int64), kernel=3,
                               group_size=8)
    with pytest.raises(ValueError):
        bitserial_matmul_dynamic(torch.zeros((2, 16), dtype=torch.int8),
                                 torch.zeros((8, 2, 40), dtype=torch.uint8),
                                 torch.ones(2, dtype=torch.int32), w_bits=8,
                                 bn=16)          # 40 columns: 3 groups


# ---------------------------------------------------------------------------
# Serving ops and the path as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_bits,w_bits,k", [(8, 8, 40), (4, 4, 27),
                                             (8, 11, 64)])
def test_linear_serve_dynamic_matches_jax(a_bits, w_bits, k):
    rng = np.random.default_rng(k + w_bits)
    x = rng.normal(size=(20, k)).astype(np.float32)
    x[8:16] *= 0.02                  # a quiet row group trims
    wq, w_scale = jq.quantize(jnp.asarray(rng.normal(size=(k, 12)),
                                          jnp.float32), w_bits)
    wp = jbitpack.pack_weights(wq, w_bits)
    for axis in (-1, None):
        kw = dict(a_bits=a_bits, w_bits=w_bits, a_axis=axis)
        want = np.asarray(jops.loom_linear_serve_dynamic(
            jnp.asarray(x), wp, w_scale, group_size=8, backend="xla", **kw))
        static = ops.loom_linear_serve(_t(x), _t(wp), _t(w_scale), **kw)
        np.testing.assert_array_equal(static.numpy(), want)
        for be in ("torch_ref", "cuda"):
            got = ops.loom_linear_serve_dynamic(_t(x), _t(wp), _t(w_scale),
                                                group_size=8, backend=be, **kw)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel,stride,a_bits,w_bits",
                         [(1, 1, 8, 8), (3, 1, 4, 4), (5, 2, 8, 11)])
def test_conv_serve_dynamic_matches_jax(kernel, stride, a_bits, w_bits):
    rng = np.random.default_rng(kernel * 10 + w_bits)
    x = _skewed_map(rng, 2, 9, 4)
    wq, w_scale = jq.quantize(jnp.asarray(
        rng.normal(size=(kernel * kernel * 4, 16)), jnp.float32), w_bits)
    wp = jbitpack.pack_weights(wq, w_bits)
    kw = dict(kernel=kernel, stride=stride, a_bits=a_bits)
    want = np.asarray(jops.loom_conv_serve_dynamic(
        jnp.asarray(x), wp, w_scale, group_size=16, backend="xla", **kw))
    np.testing.assert_array_equal(
        ops.loom_conv_serve(_t(x), _t(wp), _t(w_scale), **kw).numpy(), want)
    for be in ("torch_ref", "cuda"):
        got = ops.loom_conv_serve_dynamic(_t(x), _t(wp), _t(w_scale),
                                          group_size=16, backend=be,
                                          conv_tile=2, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_plan_resolves_dynamic_a_and_group_size():
    plan = repro_torch.build_plan(None, uniform_policy(8, 8, dynamic_a=True),
                                  mode="serve_packed")
    lp = plan.layer("fc0")
    assert lp.dynamic_a and lp.group_size == 256
    assert plan.backend.name == "cuda"


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_path_d_logits_match_jax_and_static(size):
    """Path D at batch 2, letterboxed images (the bottom half scaled by
    0.02, so conv window groups trim): bit-identical to JAX's un-jitted
    forward with the same plan and to the port's static path."""
    smoke = size == "smoke"
    jcfg = jpaper_cnn.smoke_config() if smoke else jpaper_cnn.config()
    # The smoke map (16 x 16) is one group of 256 windows: groups of 64
    # let its letterbox trim.
    group = 64 if smoke else 256
    params, specs = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, jcfg.img, jcfg.img, 3)).astype(np.float32)
    x[:, jcfg.img // 2:] *= 0.02
    sess = loom.compile(jcfg, dataclasses.replace(
        juniform_policy(8, 8, dynamic_a=True), group_size=group),
        mode="serve_packed", backend="xla", params=params, specs=specs)
    want = np.asarray(jcnn.forward(sess.params, jcfg, jnp.asarray(x),
                                   sess.plan))
    cfg = configs.get("paper_cnn", smoke=smoke)
    numpy_params = jax.tree.map(np.asarray, params)
    out = {}
    for dyn, be in ((True, "cuda"), (True, "torch_ref"), (False, "cuda")):
        out[dyn, be] = repro_torch.compile(
            cfg, dataclasses.replace(uniform_policy(8, 8, dynamic_a=dyn),
                                     group_size=group), mode="serve_packed",
            backend=be, params=numpy_params, device="cpu").classify(x).numpy()
    for got in out.values():
        np.testing.assert_array_equal(got, want)
    counts = dynamic.conv_window_group_counts(
        q.quantize(_t(x), 8)[0], 3, 1, group, 8)
    assert counts.min() < 8                      # the letterbox trims
