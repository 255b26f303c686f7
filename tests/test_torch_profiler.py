"""PyTorch port: the precision profiler, the A.2 leftovers, the CNN's
``collect_activations`` and ``ServingSession.dynamic_stats`` against the
JAX package, on the same numpy inputs.

Tolerances: the search's result dicts, integer counts, byte counts and
plane tables are equal; the A.2 leftovers (``dynamic_stats``,
``expected_speedup``, ``pack_weights_grouped``, ...) and the session's
``dynamic_stats`` are bit for bit (float32 means included: the port takes
the mean as the exact sum times the float32 reciprocal, as ``jnp.mean``
does); the ``measure_*`` means within 1e-6 relative; the smoke CNN's
``fake_quant`` metric within 1e-5 of JAX's un-jitted forward (float32
conv sums taken in another order move an activation across a 16-bit grid
step now and then: measured up to 1.9e-6 over 18 one-layer policies);
``serve_packed`` activations bit for bit, ``dense`` ones within 1e-5.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.configs import paper_cnn as jpaper_cnn
from repro.core import (bitpack as jbitpack, dynamic as jdynamic,
                        policy as jpolicy, profiler as jprofiler,
                        quantize as jq, weightgroups as jwg)
from repro.models import cnn as jcnn
import repro_torch
from repro_torch import configs
from repro_torch.api.plan import build_plan
from repro_torch.core import (bitpack, dynamic, policy, profiler,
                              quantize as q, weightgroups as wg)
from repro_torch.models import cnn


def _metric(pol) -> float:
    """A deterministic metric of a policy of either package: falls with
    each layer's precision below 16 bits, faster for some layers."""
    cost = 0.0
    for i, name in enumerate(("conv1", "conv2", "fc0", "fc1")):
        lp = pol.lookup(name)
        cost += (2.0 ** -lp.a_bits) * (1 + i) + (2.0 ** -lp.w_bits) * (4 - i)
    return -cost


@pytest.mark.parametrize("what", ["a_bits", "w_bits"])
@pytest.mark.parametrize("tolerance,min_bits", [(0.0, 2), (0.5, 2), (3.0, 4)])
def test_profile_layer_precisions_equals_jax(what, tolerance, min_bits):
    names = ("conv1", "conv2", "fc0", "fc1", "missing")
    kw = dict(tolerance=tolerance, min_bits=min_bits, what=what)
    got = profiler.profile_layer_precisions(_metric, names, **kw)
    assert got == jprofiler.profile_layer_precisions(_metric, names, **kw)
    assert set(got) == set(names)


def _jcase(seed=0, batch=2):
    jcfg = jpaper_cnn.smoke_config()
    params, specs = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).normal(
        size=(batch, jcfg.img, jcfg.img, 3)).astype(np.float32)
    return jcfg, params, specs, x


def test_fake_quant_metric_matches_jax_at_a_few_policies():
    """quickstart's / table1's metric, one policy at a time (the JAX
    search itself is eager and slow, so it does not run)."""
    jcfg, params, _, x = _jcase()
    cfg = configs.get("paper_cnn", smoke=True)
    tparams = {k: {n: torch.from_numpy(np.asarray(v)) for n, v in p.items()}
               for k, p in params.items()}
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref_j = jcnn.forward(params, jcfg, xj, loom.build_plan(jcfg, mode="dense"))
    ref_t = cnn.forward(tparams, cfg, xt, build_plan(cfg, mode="dense"))
    pols = [(jpolicy.uniform_policy(16, 16), policy.uniform_policy(16, 16))]
    for name, a, w in (("conv1", 5, 16), (cfg.layer_names[-1], 16, 4)):
        pols.append(tuple(
            P.PrecisionPolicy(default=P.LayerPrecision(16, 16),
                              per_layer={name: P.LayerPrecision(a, w)})
            for P in (jpolicy, policy)))
    for jpol, tpol in pols:
        lg = jcnn.forward(params, jcfg, xj,
                          loom.build_plan(jcfg, jpol, mode="fake_quant"))
        want = float(-jnp.linalg.norm(lg - ref_j) / jnp.linalg.norm(ref_j))
        lt = cnn.forward(tparams, cfg, xt,
                         build_plan(cfg, tpol, mode="fake_quant"))
        got = float(-torch.linalg.norm(lt - ref_t) / torch.linalg.norm(ref_t))
        assert abs(got - want) <= 1e-5, (tpol, got, want)


@pytest.mark.parametrize("bits,group", [(8, 16), (11, 16), (6, 12)])
def test_measure_weight_group_precision_matches_jax(bits, group):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(72, 40)).astype(np.float32)
    w[:, :group] *= 1 / 64         # one group of small filters
    got = profiler.measure_weight_group_precision(torch.from_numpy(w), bits,
                                                  group)
    want = jprofiler.measure_weight_group_precision(jnp.asarray(w), bits,
                                                    group)
    assert set(got) == set(want)
    for key in ("static_bits", "group_size", "n_groups", "per_group_bits"):
        assert got[key] == want[key]
        assert type(got[key]) is type(want[key])
    assert min(got["per_group_bits"]) < bits
    for key in ("mean_effective_bits", "plane_fraction_executed"):
        assert isinstance(got[key], float)
        assert got[key] == pytest.approx(want[key], rel=1e-6)


@pytest.mark.parametrize("bits,group,n", [(8, 256, 4096), (6, 64, 1000),
                                          (8, 256, 300)])
def test_measure_dynamic_precision_matches_jax(bits, group, n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    x[: max(n // 2, 256)] *= 0.01  # quiet groups trim planes
    got = profiler.measure_dynamic_precision(torch.from_numpy(x), bits, group)
    want = jprofiler.measure_dynamic_precision(jnp.asarray(x), bits, group)
    assert set(got) == set(want)
    assert all(isinstance(v, float) for v in got.values())
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6)
    assert got["mean_effective_bits"] < bits


@pytest.mark.parametrize("kind", ["list", "numpy", "tensor"])
def test_weight_group_leftovers_bit_for_bit(kind):
    counts = np.array([1, 5, 8, 3, 11], np.int32)
    arg = {"list": counts.tolist(), "numpy": counts,
           "tensor": torch.from_numpy(counts)}[kind]
    pw = wg.group_plane_weights(arg, 11)
    assert pw.dtype == torch.int32 and pw.shape == (5, 11)
    np.testing.assert_array_equal(pw.numpy(),
                                  np.asarray(jwg.group_plane_weights(counts, 11)))
    for shape in ((27, 70), (64, 80)):
        assert wg.grouped_packed_nbytes(shape, arg, 16) == \
            jwg.grouped_packed_nbytes(shape, counts, 16)
    assert wg.mean_group_bits(arg) == jwg.mean_group_bits(counts)
    assert isinstance(wg.mean_group_bits(arg), float)


@pytest.mark.parametrize("k,n,bits,group", [(27, 50, 8, 16), (64, 40, 11, 12)])
def test_pack_weights_grouped_and_baseline_bit_for_bit(k, n, bits, group):
    rng = np.random.default_rng(k)
    wq = rng.integers(q.qmin(bits), q.qmax(bits) + 1, size=(k, n)).astype(np.int32)
    wq[:, :group] //= 16           # a group that needs fewer planes
    got = bitpack.pack_weights_grouped(torch.from_numpy(wq), bits, group)
    want = jbitpack.pack_weights_grouped(jnp.asarray(wq), bits, group)
    for field in ("planes", "counts", "plane_weights"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    assert (got.group_size, got.bits) == (want.group_size, want.bits)
    assert torch.equal(got.planes, bitpack.pack_weights(torch.from_numpy(wq),
                                                        bits))
    assert torch.equal(got.counts, wg.weight_group_counts(
        torch.from_numpy(wq), bits, group))
    assert int(got.counts[0]) < bits
    assert bitpack.baseline_nbytes((k, n)) == jbitpack.baseline_nbytes((k, n))
    assert bitpack.baseline_nbytes((k, n), 8) == \
        jbitpack.baseline_nbytes((k, n), 8)


@pytest.mark.parametrize("static_bits,group", [(8, 256), (7, 64), (6, 100)])
def test_dynamic_leftovers_bit_for_bit(static_bits, group):
    rng = np.random.default_rng(static_bits)
    xq = rng.integers(-128, 128, size=(6, 700)).astype(np.int32)
    xq[:3] //= 40
    t, j = torch.from_numpy(xq), jnp.asarray(xq)
    got = dynamic.dynamic_stats(t, static_bits, group)
    want = jdynamic.dynamic_stats(j, static_bits, group)
    assert set(got) == set(want) and got["static_bits"] == static_bits
    for key in ("mean_effective_bits", "plane_fraction_executed"):
        assert got[key].dtype == torch.float32 and got[key].ndim == 0
        assert got[key].item() == float(want[key])
    tx, teff = dynamic.trim_to_group_bits(t, group, static_bits)
    jx, jeff = jdynamic.trim_to_group_bits(j, group, static_bits)
    assert torch.equal(tx, t)
    np.testing.assert_array_equal(teff.numpy(), np.asarray(jeff))
    sp = dynamic.expected_speedup(teff, static_bits)
    assert sp.dtype == torch.float32
    assert sp.item() == float(jdynamic.expected_speedup(jeff, static_bits))


@pytest.mark.parametrize("mode", ["serve_packed", "dense"])
def test_collect_activations_match_unjitted_jax(mode):
    jcfg, params, specs, x = _jcase(seed=2)
    jpol = jpolicy.uniform_policy(8, 8)
    sess = loom.compile(jcfg, jpol, mode=mode, backend="xla", params=params,
                        specs=specs)
    want_lg, want = jcnn.forward(sess.params, jcfg, jnp.asarray(x), sess.plan,
                                 collect_activations=True)
    cfg = configs.get("paper_cnn", smoke=True)
    tsess = repro_torch.compile(cfg, policy.uniform_policy(8, 8), mode=mode,
                                backend="torch_ref",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu")
    with torch.inference_mode():
        got_lg, got = cnn.forward(tsess.params, cfg, torch.from_numpy(x),
                                  tsess.plan, collect_activations=True)
        plain = cnn.forward(tsess.params, cfg, torch.from_numpy(x),
                            tsess.plan)
    assert list(got) == list(want) == list(cfg.layer_names)
    assert torch.equal(got_lg, plain)
    tol = 0 if mode == "serve_packed" else 1e-5
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("layer,a_bits,group", [("", 8, 256), ("fc0", 6, 64),
                                                ("conv1", 12, 100)])
def test_session_dynamic_stats_equals_jax(layer, a_bits, group):
    jcfg, params, specs, _ = _jcase()
    per = {"fc0": (6, 8), "conv1": (12, 8)}
    jpol = jpolicy.PrecisionPolicy(
        default=jpolicy.LayerPrecision(8, 8), group_size=group,
        per_layer={k: jpolicy.LayerPrecision(*v) for k, v in per.items()})
    tpol = policy.PrecisionPolicy(
        default=policy.LayerPrecision(8, 8), group_size=group,
        per_layer={k: policy.LayerPrecision(*v) for k, v in per.items()})
    assert dataclasses.astuple(tpol) == dataclasses.astuple(jpol)
    sess = loom.compile(jcfg, jpol, mode="serve_packed", backend="xla",
                        params=params, specs=specs)
    cfg = configs.get("paper_cnn", smoke=True)
    tsess = repro_torch.compile(cfg, tpol, mode="serve_packed",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu")
    x = np.random.default_rng(5).normal(size=(4, 9, 300)).astype(np.float32)
    x[:2] *= 0.02
    want = sess.dynamic_stats(jnp.asarray(x), layer)
    got = tsess.dynamic_stats(x, layer)
    assert set(got) == set(want)
    assert got["static_bits"] == want["static_bits"] == min(a_bits, 8)
    for key in ("mean_effective_bits", "plane_fraction_executed"):
        assert got[key].dtype == torch.float32
        assert got[key].item() == float(want[key]), key
