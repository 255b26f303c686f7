"""Shared by the ``test_torch_train*.py`` files: one smoke architecture's
JAX params carried into the port, one batch from a numpy seed, and the
loss and every leaf's gradient of the port's ``model.loss_fn`` held
against the JAX package's.

The JAX side runs un-jitted (``jax.disable_jit()``: its ``lax.scan`` over
the layer groups executes op by op), as the serving parity tests hold the
port against the un-jitted JAX model. Compiled as one program, XLA fuses
the scan body and rounds some bf16 values otherwise: at seed 0 that
flipped one top-k routing choice of deepseek-moe-16b's smoke MoE layer
inside the jitted ``value_and_grad`` (expert 1's gradients 15% off its
own eager chain rule), while the port, bit for bit equal to the eager
JAX forward up to that layer, agreed with the eager gradients within
1.2%.

Tolerances: the loss within LOSS_RTOL relative; each leaf's gradient
within ``max|port - jax| <= GRAD_FRAC * max|jax|``, the bound the
reference's own gradient test uses (``tests/test_perf_opts.py:157``).
bf16 products and sums taken in another order than XLA's account for
the difference (measured: at most 1.44% of a leaf's max, on jamba).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import plan as jplan
from repro.configs import get as jget
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import model as JM
from repro_torch import configs, interop
from repro_torch.api import plan as planlib
from repro_torch.core.policy import uniform_policy
from repro_torch.launch.train import batch_on, value_and_grad

LOSS_RTOL = 1e-2
GRAD_FRAC = 0.05
B, S = 2, 32


def lm_batch(cfg, seed: int = 0, b: int = B, s: int = S) -> dict:
    """Token ids and labels [b, s] (and a VLM's image embeddings, float32)
    from numpy ``seed``: the reference's ``tests/test_archs_smoke.py``
    batch."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab, size=(b, s)).astype(
                 np.int32)}
    if cfg.n_img_tokens:
        batch["img_embeds"] = rng.normal(
            size=(b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


def lm_case(name: str) -> dict:
    """JAX seed-0 params of ``name``'s smoke config, the same params in
    the port, and one batch."""
    jcfg = jget(name, smoke=True)
    params, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(name=name, jcfg=jcfg, cfg=configs.get(name, smoke=True),
                params=params, batch=lm_batch(jcfg),
                tparams=interop.params_from_numpy(
                    jax.tree.map(np.asarray, params)))


def f32(tree) -> dict:
    """{path: float32 numpy} of a JAX or port tree."""
    flat = interop.flatten_with_paths(tree)
    return {k: v.detach().float().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(jnp.asarray(v).astype(jnp.float32))
            for k, v in flat.items()}


def jax_value_and_grad(case: dict, mode: str, bits=(8, 8)) -> tuple:
    """(loss, {"nll", "aux"}, grads) of the un-jitted JAX ``loss_fn``."""
    jcfg = case["jcfg"]
    plan = jplan.build_plan(jcfg, juniform_policy(*bits), mode)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    with jax.disable_jit():
        (loss, parts), grads = jax.value_and_grad(
            lambda p: JM.loss_fn(p, jcfg, batch, plan), has_aux=True)(
                case["params"])
    return loss, parts, grads


def port_value_and_grad(case: dict, mode: str, bits=(8, 8),
                        cfg=None) -> tuple:
    """(loss, {"nll", "aux"}, grads) of the port's ``loss_fn`` on the CPU
    (``cfg``: the case's config unless given)."""
    cfg = cfg or case["cfg"]
    plan = planlib.build_plan(cfg, uniform_policy(*bits), mode)
    return value_and_grad(case["tparams"], cfg,
                          batch_on(case["batch"], "cpu"), plan)


def grad_gaps(want: dict, got: dict) -> dict:
    """{path: max|got - want| / max|want|} over the leaves of two
    gradient trees (the same paths and shapes)."""
    w, g = f32(want), f32(got)
    assert sorted(w) == sorted(g)
    out = {}
    for k in w:
        assert g[k].shape == w[k].shape, k
        out[k] = float(np.abs(g[k] - w[k]).max()) / max(
            float(np.abs(w[k]).max()), 1e-30)
    return out


def check_loss_and_grads(case: dict, mode: str) -> None:
    """The port's loss, nll, aux and every leaf's gradient against JAX's,
    in ``mode`` at (8, 8)."""
    jl, jparts, jg = jax_value_and_grad(case, mode)
    tl, tparts, tg = port_value_and_grad(case, mode)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tparts["nll"]), float(jparts["nll"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tparts["aux"]), float(jparts["aux"]),
                               rtol=LOSS_RTOL, atol=1e-6)
    gaps = grad_gaps(jg, tg)
    bad = {k: v for k, v in gaps.items() if not v <= GRAD_FRAC}
    assert not bad, f"{case['name']} {mode}: gradients off {bad}"
