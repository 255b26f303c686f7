"""PyTorch port, the MoE block (``models/moe.py``) against the JAX
package's ``repro.models.moe`` on the CPU, at the smoke configs of
deepseek-moe-16b (8 experts, top 3, one shared block) and mixtral-8x7b (4
experts, top 2, none shared).

Same params (JAX ``moe.init`` -> numpy -> ``interop.params_from_numpy``)
and the same bf16 input.

What is exact: the routing (the top-k ids, the kept set and the slots of
the per-row capacity dispatch, drops included) and the expert packing
(``_convert_expert_int8`` / ``_packed``: bytes and scales). The router's
logits are a float32 product summed in another order than XLA's, so they
are held within 1e-5; the ids agree wherever no two gates tie within
that, which random float32 gates never do here.

What is held by tolerance: the block's output, ``MOE_ATOL`` = 0.03 on
values of magnitude about 1. The experts' bf16 products sum in another
order than XLA's (one bf16 ulp, 2^-8 of a value, here and there), and on
the serving routes the shared experts requantize their input, so a
rounding moved by an ulp moves a product by a quantization step. (On
this container's CPU the two packages gave equal bits for every input
tried; the tolerance does not rest on that.)
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as jplan
from repro.configs import get as jget
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import model as JM, moe as jmoe
from repro_torch import configs, interop
from repro_torch.api import plan as tplan
from repro_torch.core.policy import uniform_policy
from repro_torch.models import model as M, moe

MOE_ATOL = 0.03
ARCHS = ("deepseek-moe-16b", "mixtral-8x7b")
MODES = ("dense", "serve_int8", "serve_packed")


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module", params=ARCHS)
def block(request):
    """(arch, JAX MoE config, port MoE config, JAX params, port params,
    a bf16 input [2, 16, d] from numpy seed 2)."""
    jcfg = jget(request.param, smoke=True).moe
    tcfg = configs.get(request.param, smoke=True).moe
    jp, _ = jmoe.init(jax.random.PRNGKey(1), jcfg)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp))
    x = jnp.asarray(np.random.default_rng(2).normal(
        size=(2, 16, jcfg.d_model)), jnp.bfloat16)
    return request.param, jcfg, tcfg, jp, tp, x


def _jax_dispatch(ids, e: int, cap: int):
    """The reference's per-row dispatch, as ``moe.apply`` computes it."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(onehot, axis=1) - 1
    pos = jnp.take_along_axis(pos_in_e, flat[..., None], axis=2)[..., 0]
    keep = pos < cap
    return jnp.where(keep, flat * cap + pos, e * cap), keep


def test_configs_match_jax():
    for arch in ARCHS:
        for smoke in (True, False):
            t, j = configs.get(arch, smoke).moe, jget(arch, smoke).moe
            for f in dataclasses.fields(t):
                assert getattr(t, f.name) == getattr(j, f.name), (arch, f)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_routing_matches_jax_exactly(block, capacity_factor):
    """Router logits within 1e-5; the top-k ids, the kept set and the
    slots equal JAX's, with a capacity factor that drops tokens too."""
    arch, jcfg, tcfg, jp, tp, x = block
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    jlogits = x.astype(jnp.float32) @ jp["router"]["w"]
    tlogits = moe.router_logits(interop.params_from_numpy(np.asarray(x)),
                                tp["router"]["w"])
    np.testing.assert_allclose(_f32(tlogits), _f32(jlogits), atol=1e-5,
                               rtol=0)
    jprobs, jids, jaux = jmoe._route(jlogits, jcfg)
    tprobs, tids, taux = moe._route(tlogits, tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(_f32(tprobs), _f32(jprobs), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    s, k, e = x.shape[1], jcfg.top_k, jcfg.n_experts
    cap = max(1, int(s * k / e * capacity_factor))
    jslot, jkeep = _jax_dispatch(jids, e, cap)
    tslot, tkeep = moe.dispatch(tids, tcfg, cap)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    if capacity_factor < 1:
        assert not tkeep.all()        # some tokens dropped to the sink
        assert (tslot[~tkeep] == e * cap).all()


@pytest.mark.parametrize("mode", ["serve_int8", "serve_packed"])
@pytest.mark.parametrize("w_bits", [8, 5])
def test_expert_conversion_matches_jax_byte_for_byte(block, mode, w_bits):
    arch, jcfg, tcfg, jp, tp, x = block
    prec = juniform_policy(8, w_bits).default
    tprec = uniform_policy(8, w_bits).default
    for key in ("w_gate", "w_up", "w_down"):
        want, _ = JM._convert_expert(jp[key], (None, None, None), prec, mode)
        got = M._EXPERT_CONVERTERS[mode](tp[key], tprec)
        assert sorted(got) == sorted(want)
        for leaf in got:
            np.testing.assert_array_equal(got[leaf].numpy(),
                                          np.asarray(want[leaf]),
                                          err_msg=f"{key}/{leaf}")
            assert str(got[leaf].dtype) == f"torch.{want[leaf].dtype}"


@pytest.mark.parametrize("mode", MODES)
def test_moe_apply_matches_jax(block, mode):
    """The block's output in each mode within MOE_ATOL of JAX's (the
    shared experts through the plan's routes; the routed experts on each
    stored layout)."""
    arch, jcfg, tcfg, jp, tp, x = block
    jpol, tpol = juniform_policy(8, 8), uniform_policy(8, 8)
    jpm, tpm = jp, tp
    if mode != "dense":
        specs = jax.tree.map(lambda a: (None,) * a.ndim, jp)
        jpm, _ = JM._convert_tree(jp, specs, jpol, mode, root=("ffn",))
        tpm = M.convert_tree(tp, tpol, mode, root=("ffn",))
    want, _ = jmoe.apply(jpm, jcfg, x, jplan.build_plan(None, jpol, mode))
    got = moe.apply(tpm, tcfg, interop.params_from_numpy(np.asarray(x)),
                    tplan.build_plan(None, tpol, mode, "torch_ref"))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=MOE_ATOL, rtol=0)


def test_moe_rows_do_not_depend_on_the_batch(block):
    """A decode row's block output equals the row run alone (the engine's
    batched == solo bar; the card's counterpart is in
    ``tests/test_torch_gpu.py``)."""
    arch, jcfg, tcfg, jp, tp, x = block
    tpm = M.convert_tree(tp, uniform_policy(8, 8), "serve_packed",
                         root=("ffn",))
    plan = tplan.build_plan(None, uniform_policy(8, 8), "serve_packed",
                            "torch_ref")
    xt = interop.params_from_numpy(np.asarray(x))[:, :1]      # [2, 1, d]
    xt = torch.cat([xt, xt.flip(0), xt * 0.5])                # [6, 1, d]
    out = moe.apply(tpm, tcfg, xt, plan)
    for b in range(xt.shape[0]):
        assert torch.equal(out[b:b + 1], moe.apply(tpm, tcfg, xt[b:b + 1],
                                                   plan))
