"""PyTorch port, the Mamba2 block (``models/ssm.py``) against the JAX
package's ``repro.models.ssm`` on the CPU, at mamba2-370m's smoke config
(d 64, 8 heads of 16, d_state 16, chunk 16).

Same params (JAX ``ssm.init`` -> numpy -> ``interop.params_from_numpy``)
and the same inputs, made from numpy seeds.

What is exact: the depthwise causal conv (each tap's product and add in
bf16, in the reference's order), and the segment sums' mask. Their
values are differences of a float32 cumsum, which XLA on the CPU takes
as a parallel prefix scan and PyTorch sequentially: held within 1e-5 of
their magnitude.

What is held by tolerance: the SSD scan in float32 (``SSD_RTOL`` = 1e-4
of the output's magnitude: its einsums contract in another order than
XLA's, and ``exp`` of the segment sums rounds differently), and the
block's output and cache through the Loom linears (``BLOCK_ATOL`` = 0.02
on values of magnitude about 1: a float32 difference that moves a bf16
rounding moves a requantized product by a step).
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
from repro.models import model as JM, ssm as jssm
import repro_torch
from repro_torch import configs, interop
from repro_torch.api import plan as tplan
from repro_torch.core.policy import uniform_policy
from repro_torch.models import model as M, ssm

SSD_RTOL = 1e-4
BLOCK_ATOL = 0.02
ARCH = "mamba2-370m"


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    return interop.params_from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def block():
    jcfg = jget(ARCH, smoke=True).ssm
    tcfg = configs.get(ARCH, smoke=True).ssm
    jp, _ = jssm.init(jax.random.PRNGKey(3), jcfg)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_config_and_params_match_jax(block):
    jcfg, tcfg, jp, tp = block
    for smoke in (True, False):
        t, j = configs.get(ARCH, smoke).ssm, jget(ARCH, smoke).ssm
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.d_inner, t.n_heads) == (j.d_inner, j.n_heads)
    drawn = ssm.init(tcfg, torch.Generator().manual_seed(0))
    want = interop.flatten_with_paths(jax.tree.map(np.asarray, jp))
    got = interop.flatten_with_paths(drawn)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    for key in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(drawn[key].numpy(), want[key], rtol=1e-6)


def test_causal_conv_and_segsum_equal_jax():
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(2, 24, 32)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(4, 32)) * 0.2, jnp.bfloat16)
    got = ssm._causal_conv(_t(x), _t(w))
    np.testing.assert_array_equal(_f32(got), _f32(jssm._causal_conv(x, w)))
    a = jnp.asarray(-np.abs(rng.normal(size=(2, 3, 16))), jnp.float32)
    want = np.asarray(jssm._segsum(a))
    got = ssm._segsum(_t(a)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    live = ~np.isneginf(want)
    np.testing.assert_allclose(got[live], want[live],
                               atol=1e-5 * np.abs(want[live]).max(), rtol=0)


def test_ssd_chunked_matches_jax_in_float32():
    """Outputs and the final state within SSD_RTOL of their magnitude."""
    rng = np.random.default_rng(5)
    b, s, h, p, n, chunk = 2, 48, 4, 8, 16, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    B_ = rng.normal(size=(b, s, n)).astype(np.float32)
    C_ = rng.normal(size=(b, s, n)).astype(np.float32)
    jy, jstate = jssm.ssd_chunked(*(jnp.asarray(a) for a in
                                    (x, dt, A, B_, C_)), chunk)
    ty, tstate = ssm.ssd_chunked(*(torch.from_numpy(a) for a in
                                   (x, dt, A, B_, C_)), chunk)
    for got, want in ((ty, jy), (tstate, jstate)):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=SSD_RTOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("mode", ["dense", "serve_packed"])
def test_prefill_cache_and_decode_step_match_jax(block, mode):
    """The block's prefill output and its {conv, state}, then one decode
    step's output and updated cache, against JAX's; the port writes the
    cache in place."""
    jcfg, tcfg, jp, tp = block
    jpol, tpol = juniform_policy(8, 8), uniform_policy(8, 8)
    jpm, tpm = jp, tp
    if mode != "dense":
        specs = jax.tree.map(lambda a: (None,) * a.ndim, jp)
        jpm, _ = JM._convert_tree(jp, specs, jpol, mode)
        tpm = M.convert_tree(tp, tpol, mode)
    jplan_, tplan_ = (jplan.build_plan(None, jpol, mode),
                      tplan.build_plan(None, tpol, mode, "torch_ref"))
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(2, 32, 64)), jnp.bfloat16)
    x1 = jnp.asarray(rng.normal(size=(2, 1, 64)), jnp.bfloat16)
    jc = jssm.init_cache(jcfg, 2)
    tc = ssm.init_cache(tcfg, 2)
    jout, jc = jssm.apply_prefill(jpm, jcfg, x, jplan_, jc)
    tout = ssm.apply_prefill(tpm, tcfg, _t(x), tplan_, tc)
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=BLOCK_ATOL)
    for key in ("conv", "state"):
        assert tc[key].dtype == {"conv": torch.bfloat16,
                                 "state": torch.float32}[key]
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                   atol=BLOCK_ATOL)
    jout, jc = jssm.apply_decode(jpm, jcfg, x1, jplan_, jc)
    tout = ssm.apply_decode(tpm, tcfg, _t(x1), tplan_, tc)
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=BLOCK_ATOL)
    for key in ("conv", "state"):
        np.testing.assert_allclose(_f32(tc[key]), _f32(jc[key]),
                                   atol=BLOCK_ATOL)


def test_prefill_then_decode_equals_the_longer_prefill():
    """Prefill of S tokens, then a chunk's worth of decode steps fed the
    next tokens, gives the last logits of a prefill of S + chunk within
    ``test_torch_lm.py``'s LOGIT_ATOL = 0.2 (the recurrence and the
    chunked scan sum in other orders, and a moved bf16 rounding is
    requantized by the next linear)."""
    cfg = configs.get(ARCH, smoke=True)
    sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                               mode="serve_packed", device="cpu")
    chunk = cfg.ssm.chunk
    tokens = np.random.default_rng(7).integers(0, cfg.vocab,
                                               size=(2, 3 * chunk))
    logits, cache = sess.prefill(tokens[:, :2 * chunk])
    for i in range(2 * chunk, 3 * chunk):
        logits, cache = sess.decode(torch.from_numpy(tokens[:, i]), i, cache)
    want, _ = sess.prefill(tokens)
    np.testing.assert_allclose(_f32(logits), _f32(want[:, 0]), atol=0.2)


def test_ragged_prompt_raises_naming_the_chunk():
    cfg = configs.get(ARCH, smoke=True)
    sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                               mode="serve_packed", device="cpu")
    with pytest.raises(ValueError, match="SSM chunk 16"):
        sess.prefill(np.zeros((1, 15), np.int64))


def test_decode_rows_do_not_depend_on_the_batch(block):
    """A decode row's output and cache equal the row decoded alone (the
    [B, heads] exp and softplus padded to whole CPU vector blocks; the
    card's counterpart is in ``tests/test_torch_gpu.py``)."""
    jcfg, tcfg, jp, tp = block
    tpm = M.convert_tree(tp, uniform_policy(8, 8), "serve_packed")
    plan = tplan.build_plan(None, uniform_policy(8, 8), "serve_packed",
                            "torch_ref")
    g = torch.Generator().manual_seed(8)
    cache = ssm.init_cache(tcfg, 5)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=g))
    cache["state"].copy_(torch.randn(cache["state"].shape, generator=g))
    x = torch.randn((5, 1, 64), generator=g).to(torch.bfloat16)
    rows = [{k: v[b:b + 1].clone() for k, v in cache.items()}
            for b in range(5)]
    out = ssm.apply_decode(tpm, tcfg, x, plan, cache)
    for b in range(5):
        assert torch.equal(out[b:b + 1], ssm.apply_decode(
            tpm, tcfg, x[b:b + 1], plan, rows[b]))
        for key in cache:
            assert torch.equal(cache[key][b:b + 1], rows[b][key])
