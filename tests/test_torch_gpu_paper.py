"""PyTorch port on the card: the paper's evaluation. The plane-width
engine's exact product on both of its routes (int8 ``_int_mm`` and
float64) against the oracle on the card and the CPU's result, int32
wrap-around included; the paper CNN under a per-layer mixed (Pa, Pw)
policy (Pw 5-16) served ``serve_packed`` with ``cuda`` == ``torch_ref``
== a CPU session bit for bit, static and ``dynamic_a``, with the launches
the plan implies; ``session.dynamic_stats`` on the card equal to the
CPU's; the quickstart example on the card (K1 launched).

Marked ``gpu``; each test skips without a CUDA device. Run on the card with
``python -m pytest -m gpu tests/test_torch_gpu_paper.py``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.api.plan import build_plan, counted_weights
from repro_torch.api.session import entry_points
from repro_torch.core import engine
from repro_torch.core.policy import LayerPrecision, PrecisionPolicy
from repro_torch.kernels.bitserial_conv import (
    bitserial_conv, bitserial_conv_dynamic, bitserial_conv_wgroup)
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                  bitserial_matmul_dynamic)
from repro_torch.models import cnn

pytestmark = pytest.mark.gpu

_KERNELS = {"K1": bitserial_matmul, "K2": bitserial_conv,
            "K3": bitserial_matmul_dynamic, "K4": bitserial_conv_wgroup,
            "K5": bitserial_conv_dynamic}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("a_bits,w_bits,pb,mode,route", [
    (8, 8, 1, "serial_both", "int8"), (8, 8, 8, "serial_both", "int8"),
    (7, 11, 4, "serial_both", "int8"), (16, 16, 2, "serial_both", "int8"),
    (16, 8, 8, "serial_both", "float64"),
    (16, 8, 8, "serial_weights", "float64"),
    (16, 16, 8, "serial_both", "float64")])
def test_engine_is_exact_on_the_card(cuda, a_bits, w_bits, pb, mode, route):
    rng = np.random.default_rng(a_bits * 100 + w_bits + pb)
    xq = rng.integers(-(1 << (a_bits - 1)), 1 << (a_bits - 1),
                      size=(300, 512)).astype(np.int32)
    wq = rng.integers(-(1 << (w_bits - 1)), 1 << (w_bits - 1),
                      size=(512, 136)).astype(np.int32)
    if a_bits == w_bits == 16:            # sums past 2^31: int32 wraps
        xq[0], wq[:, 0] = -32768, -32768
    cfg = engine.LoomConfig(a_bits=a_bits, w_bits=w_bits, a_plane_bits=pb,
                            w_plane_bits=pb, mode=mode)
    a_range = (engine.plane_range(a_bits, pb) if mode == "serial_both"
               else (-(1 << (a_bits - 1)), (1 << (a_bits - 1)) - 1))
    assert engine.product_route(512, a_range,
                                engine.plane_range(w_bits, pb)) == route
    x_t, w_t = torch.from_numpy(xq), torch.from_numpy(wq)
    got = engine.plane_matmul(x_t.to(cuda), w_t.to(cuda), cfg)
    want = engine.reference_int_matmul(x_t.to(cuda), w_t.to(cuda))
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), engine.plane_matmul(x_t, w_t, cfg))
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    assert torch.equal(got.cpu(), torch.from_numpy(exact.astype(np.int32)))


@pytest.mark.parametrize("route", ["int8", "float64"])
def test_exact_product_routes_on_the_card(cuda, route):
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(-128, 128, size=(3000, 2048)))
    w = torch.from_numpy(rng.integers(-128, 128, size=(2048, 520)))
    got = engine.exact_product(a.to(cuda), w.to(cuda), route)
    assert got.dtype == torch.int64
    assert torch.equal(got.cpu(), a @ w)


# Pw 5-16 across the layers: K2's packed and wide planes, K1's lo/hi split.
_MIXED = PrecisionPolicy(default=LayerPrecision(8, 8), per_layer={
    "conv1": LayerPrecision(8, 13), "conv2": LayerPrecision(6, 11),
    "conv3": LayerPrecision(8, 5), "fc0": LayerPrecision(7, 16),
    "fc1": LayerPrecision(8, 9)})


def _twin(sess, backend):
    plan = build_plan(sess.cfg, sess.plan.policy, sess.plan.mode, backend)
    plan.record_weight_groups(counted_weights(sess.cfg, sess.params))
    return dataclasses.replace(sess, plan=plan,
                               **entry_points(sess.cfg, plan))


@pytest.mark.parametrize("dynamic_a", [False, True])
def test_mixed_precision_cnn_cuda_equals_torch_ref(cuda, dynamic_a):
    cfg = configs.get("paper_cnn")
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    pol = dataclasses.replace(_MIXED, dynamic_a=dynamic_a)
    sess = repro_torch.compile(cfg, pol, mode="serve_packed", backend="cuda",
                               params=params, device=cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 32, 32, 3)).astype(np.float32)).to(cuda)
    before = {k: fn.launches for k, fn in _KERNELS.items()}
    y = sess.classify(x)
    torch.cuda.synchronize()
    launched = {k: fn.launches - before[k] for k, fn in _KERNELS.items()}
    if dynamic_a:      # one launch per 7-bit subplane above Pw 8
        assert launched == {"K1": 0, "K2": 0, "K3": 3 + 2, "K4": 0,
                            "K5": 2 + 2 + 1}
    else:
        trimmed = {n for (n, kind), lp in sess.plan.layers.items()
                   if lp.w_group_counts and min(lp.w_group_counts) < lp.w_bits}
        convs = {c.name for c in cfg.convs}
        assert launched["K2"] + launched["K4"] == 3
        assert launched["K4"] == len(trimmed & convs)
        assert launched["K1"] + launched["K3"] == 2
        assert launched["K3"] == len(trimmed - convs)
        assert launched["K5"] == 0
    assert torch.equal(y, _twin(sess, "torch_ref").classify(x))
    cpu = repro_torch.compile(cfg, pol, mode="serve_packed",
                              backend="torch_ref", params=params,
                              device="cpu")
    assert torch.equal(y.cpu(), cpu.classify(x.cpu()))
    static = repro_torch.compile(cfg, _MIXED, mode="serve_packed",
                                 backend="cuda", params=params, device=cuda)
    assert torch.equal(y, static.classify(x))
    # The card's dynamic statistics equal the CPU session's.
    _, acts = cnn.forward(sess.params, cfg, x, sess.plan,
                          collect_activations=True)
    for layer in ("conv2", "fc0"):
        got = sess.dynamic_stats(acts[layer], layer)
        want = cpu.dynamic_stats(acts[layer].cpu(), layer)
        for key in ("mean_effective_bits", "plane_fraction_executed"):
            assert torch.equal(got[key].cpu(), want[key]), (layer, key)


def test_quickstart_on_the_card_launches_k1(cuda):
    from repro_torch.examples import quickstart
    before = bitserial_matmul.launches
    out = quickstart.main(device="cuda")
    assert bitserial_matmul.launches > before
    assert out["rel_err"] < 0.05 and out["corr"] > 0.99
