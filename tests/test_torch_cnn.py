"""PyTorch port, the whole slice: paper-CNN ``serve_packed`` classify.

Same params (JAX init -> numpy -> both packages), same numpy images. The
port's logits must be bit-identical to JAX's UN-jitted
``cnn.forward(params, cfg, x, plan)``: the integer cores are exact and
every float step is the same IEEE float32 op in the same order.

Against the JITTED ``loom.compile(...).classify`` they are held to
rtol = atol = 1e-6 instead: under ``jax.jit``, XLA:CPU rewrites the
quantization scale ``absmax / qmax`` (repro/core/quantize.py) into
``absmax * (1 / qmax)``, which can differ from the true division in the
last bit, so the jitted logits sit one or two float32 ulps away. That
holds while no activation lies on a rounding boundary of the grid; where
one does, the one-ulp scale moves it by a whole quantization step, as
:func:`test_jit_scale_can_flip_a_quantization_step` pins down.
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
from repro.core import quantize as jq
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import cnn as jcnn
import repro_torch
from repro_torch import configs, interop
from repro_torch.core import quantize as q
from repro_torch.core.policy import uniform_policy
from repro_torch.models import cnn

_SIZES = {"smoke": (jpaper_cnn.smoke_config, True),
          "full": (jpaper_cnn.config, False)}


def _case(size, seed=0):
    jcfg = _SIZES[size][0]()
    params, specs = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).normal(
        size=(2, jcfg.img, jcfg.img, 3)).astype(np.float32)
    return jcfg, params, specs, x


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("w_bits", [8, 11, 16])
def test_serve_packed_logits_match_jax(size, w_bits):
    jcfg, params, specs, x = _case(size)
    sess = loom.compile(jcfg, juniform_policy(8, w_bits), mode="serve_packed",
                        backend="xla", params=params, specs=specs)
    eager = np.asarray(jcnn.forward(sess.params, jcfg, jnp.asarray(x),
                                    sess.plan))
    jitted = np.asarray(sess.classify(jnp.asarray(x)))

    cfg = configs.get("paper_cnn", smoke=_SIZES[size][1])
    tsess = repro_torch.compile(cfg, uniform_policy(8, w_bits),
                                mode="serve_packed", backend="torch_ref",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu")
    got = tsess.classify(x)
    assert got.shape == (2, 10) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), jitted.argmax(-1))

    # The packed layout carries across unchanged, and the cuda backend on
    # CPU tensors takes the kernels' plain versions: same logits again.
    packed = repro_torch.compile(cfg, uniform_policy(8, w_bits),
                                 mode="serve_packed", backend="cuda",
                                 params=jax.tree.map(np.asarray, sess.params),
                                 device="cpu")
    np.testing.assert_array_equal(packed.classify(x).numpy(), eager)
    for name, p in tsess.params.items():
        np.testing.assert_array_equal(p["w_packed"].numpy(),
                                      np.asarray(sess.params[name]["w_packed"]))
    # Pack-time weight-group counts equal the reference plan's (all full
    # at random init, so the path stays on the static kernels).
    for key, lp in tsess.plan.layers.items():
        assert lp.w_group_counts == sess.plan.layer(*key).w_group_counts
        assert set(lp.w_group_counts) == {w_bits}


def test_scale_is_a_true_division():
    """The port's scale equals eager JAX's ``absmax / qmax`` exactly; the
    jitted reference's is one float32 ulp away from it on some rows."""
    x = np.random.default_rng(0).normal(size=(64, 2048)).astype(np.float32)
    for bits in (8, 16):
        eager = np.asarray(jq.compute_scale(jnp.asarray(x), bits, axis=-1))
        jitted = np.asarray(jax.jit(lambda v, b=bits: jq.compute_scale(
            v, b, axis=-1))(jnp.asarray(x)))
        port = q.compute_scale(torch.from_numpy(x), bits, axis=-1).numpy()
        np.testing.assert_array_equal(port, eager)
        ulps = np.abs(port.view(np.int32).astype(np.int64)
                      - jitted.view(np.int32).astype(np.int64))
        assert ulps.max() == 1


def test_jit_scale_can_flip_a_quantization_step():
    """A case where the jitted reference is NOT within 1e-6: full width,
    Pw = 16, seed 16. The jitted scale of conv2's input is one ulp off the
    true division, one int8 activation there lands on the other side of a
    rounding boundary, and the logits move by ~7e-3. The port still equals
    the eager reference bit for bit."""
    jcfg, params, specs, x = _case("full", seed=16)
    sess = loom.compile(jcfg, juniform_policy(8, 16), mode="serve_packed",
                        backend="xla", params=params, specs=specs)
    eager, acts = jcnn.forward(sess.params, jcfg, jnp.asarray(x), sess.plan,
                               collect_activations=True)
    jitted = np.asarray(sess.classify(jnp.asarray(x)))
    got = repro_torch.compile(
        configs.get("paper_cnn"), uniform_policy(8, 16), mode="serve_packed",
        params=jax.tree.map(np.asarray, params), device="cpu").classify(x)
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    assert np.abs(got.numpy() - jitted).max() > 1e-3
    a = acts["conv2"]
    eager_q, _ = jq.quantize(a, 8)
    jit_q, jit_scale = jax.jit(lambda v: jq.quantize(v, 8))(a)
    port_q, port_scale = q.quantize(torch.from_numpy(np.array(a)), 8)
    np.testing.assert_array_equal(port_q.numpy(), np.asarray(eager_q))
    ulps = abs(int(port_scale.numpy().view(np.int32).item())
               - int(np.asarray(jit_scale).view(np.int32).item()))
    assert ulps == 1
    assert int((np.asarray(jit_q) != np.asarray(eager_q)).sum()) == 1


def test_dense_mode_matches_jax():
    jcfg, params, specs, x = _case("smoke", seed=4)
    want = np.asarray(jcnn.forward(params, jcfg, jnp.asarray(x),
                                   loom.build_plan(jcfg, mode="dense")))
    sess = repro_torch.compile(configs.get("paper_cnn", smoke=True),
                               mode="dense",
                               params=jax.tree.map(np.asarray, params),
                               device="cpu")
    # Float convs and matmuls sum in another order: float32 tolerance.
    np.testing.assert_allclose(sess.classify(x).numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_configs_and_init_match_jax():
    for smoke in (True, False):
        cfg = configs.get("paper-cnn", smoke=smoke)
        jcfg = jpaper_cnn.smoke_config() if smoke else jpaper_cnn.config()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        jp, _ = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
        tp = cnn.init_params(cfg, torch.Generator().manual_seed(0))
        assert {k: tuple(v["w"].shape) for k, v in tp.items()} == \
            {k: tuple(v["w"].shape) for k, v in jp.items()}
    again = cnn.init_params(cfg, torch.Generator().manual_seed(0))
    for k in tp:
        assert torch.equal(tp[k]["w"], again[k]["w"])
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


def test_interop_keeps_layouts_and_dtypes():
    tree = {"fc0": {"w_packed": np.zeros((8, 2, 3), np.uint8),
                    "w_scale": np.ones((1, 1), np.float32)},
            "fc1": {"w": np.zeros((16, 4), np.float32)}}
    out = interop.params_from_numpy(tree, "cpu")
    assert out["fc0"]["w_packed"].dtype == torch.uint8
    assert tuple(out["fc0"]["w_packed"].shape) == (8, 2, 3)
    assert out["fc1"]["w"].dtype == torch.float32


def test_compile_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.compile(configs.get("paper_cnn", smoke=True),
                            mode="serve_packed", backend="cuda")


def test_unported_modes_and_options_raise():
    cfg = configs.get("paper_cnn", smoke=True)
    x = np.random.default_rng(0).normal(size=(1, 16, 16, 3)).astype(np.float32)
    # Every mode is ported now: fake_quant (training's QAT forward)
    # classifies, and an unknown mode still raises.
    got = repro_torch.compile(cfg, mode="fake_quant", device="cpu").classify(x)
    assert got.shape == (1, 10) and bool(torch.isfinite(got).all())
    with pytest.raises(ValueError, match="unknown execution mode"):
        repro_torch.compile(cfg, mode="serve_int4", device="cpu")
    # dynamic_a is ported: it serves, and equals the static path.
    out = {dyn: repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=dyn),
                                    mode="serve_packed",
                                    device="cpu").classify(x)
           for dyn in (False, True)}
    assert out[True].shape == (1, 10)
    assert torch.equal(out[True], out[False])
