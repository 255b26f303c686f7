"""Rank-side checks of the port's training on a mesh, run on the CPU over
gloo through ``_dist_ranks.start(..., module="_dist_train_ranks")``.

Each check draws the seed-0 train state twice on every rank: whole (the
unsharded port) and as this rank's shards (``make_train_state(...,
mesh=)``), and feeds both the same global batches from a numpy seed (the
meshed step this rank's rows of them, ``launch.train.batch_rows``). It
returns its readings, the largest difference of each quantity from the
unsharded port's (the parent holds them to the tolerances of
``tests/test_torch_dist_train.py``):

* ``loss`` and ``aux``: the first batch's loss (``mesh_value_and_grad``)
  and its MoE auxiliary part, absolute;
* ``grad``: the largest over the gradient leaves, gathered whole, of
  ``max|mesh - unsharded| / max|unsharded|``;
* ``step_loss`` and ``grad_norm``: the two steps' metrics, absolute and
  relative;
* ``params``: the params after two steps (``jit_train_step`` against
  ``make_train_step``), gathered whole, absolute.

The qwen3 and mixtral models run in bf16, where the mesh's partial sums
round otherwise than the unsharded products. deepseek and mamba2 run in
float32 (``f32``: params, moments and ``model.TRAIN_DTYPE``): in bf16 a
near tie of deepseek's router may send a token to another expert, and
the smoke mamba2's gradients amplify the rounding, past what a limit
could tell from a lost collective. ``check_layers`` also holds each
sharded layer kind alone in float32 (attention with qwen3's ``qk_norm``,
the SSM, the MoE expert-parallel and d_ff-split, ``dense`` and
``fake_quant``): its output, the gradient of its input and of every
parameter (gathered whole, the "data" reduction applied), each as
``max|mesh - unsharded| / max|unsharded|``.

``equal_*`` checks hold a (1, 1) mesh to no mesh with ``torch.equal``.
Imports no JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

B, S = 4, 32


def _batches(cfg, n: int = 2) -> list:
    rng = np.random.default_rng(24)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
             "labels": rng.integers(0, cfg.vocab, (B, S))}
        if cfg.n_img_tokens:
            b["img_embeds"] = rng.normal(
                size=(B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _rank_batch(batch: dict, tc, step) -> dict:
    """This rank's rows of a global numpy ``batch`` for the meshed
    ``step``."""
    from repro_torch.launch.train import batch_rows
    rows = batch_rows(len(batch["tokens"]), tc, step.shard)
    return {k: v[rows] for k, v in batch.items()}


def _setup(name: str, mode: str, mesh, accum: int = 1,
           compress: bool = False, f32: bool = False):
    from repro_torch import configs, interop
    from repro_torch.api.plan import build_plan
    from repro_torch.core.policy import uniform_policy
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import CompressionConfig, Schedule, adamw_init
    cfg = configs.get(name, smoke=True)
    tc = T.TrainConfig(accum=accum,
                       sched=Schedule(warmup_steps=1, total_steps=10),
                       compression=CompressionConfig(enabled=compress))
    plan = build_plan(cfg, uniform_policy(8, 8), mode)
    whole, specs = T.make_train_state(cfg, tc, device="cpu")
    local, _ = T.make_train_state(cfg, tc, device="cpu", mesh=mesh)
    if f32:      # a float32 model: params, moments and activations
        M.TRAIN_DTYPE = torch.float32
        for state in (whole, local):
            state["params"] = interop.tree_map(lambda t: t.float(),
                                               state["params"])
            state["opt"] = adamw_init(state["params"], tc.opt)
    return cfg, tc, plan, whole, local, specs


def _gap(want: torch.Tensor, got: torch.Tensor) -> float:
    w, g = want.float(), got.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


def _train(name: str, mode: str, mesh, accum: int = 1,
           compress: bool = False, f32: bool = False) -> dict:
    from repro_torch import interop
    from repro_torch.dist import sharding
    from repro_torch.dist.parallel import ShardCtx
    from repro_torch.launch import train as T
    cfg, tc, plan, whole, local, specs = _setup(name, mode, mesh, accum,
                                                compress, f32)
    shard = ShardCtx(mesh)
    batches = _batches(cfg)
    bspecs = T.batch_specs(cfg)
    first = T.batch_on(batches[0], "cpu")
    rows = {k: sharding.shard_leaf(v, bspecs[k], mesh)
            for k, v in first.items()}
    wl, wp, wg = T.value_and_grad(whole["params"], cfg, first, plan)
    gl, gp, gg = T.mesh_value_and_grad(local["params"], cfg, rows, plan,
                                       shard, specs["params"])
    gg = sharding.gather_tree(gg, specs["params"], mesh)
    wg, gg = (interop.flatten_with_paths(t) for t in (wg, gg))
    out = {"loss": abs(float(gl) - float(wl)),
           "aux": abs(float(gp["aux"]) - float(wp["aux"])),
           "grad": max(_gap(wg[k], gg[k]) for k in wg)}

    ref_step = T.make_train_step(cfg, plan, tc)
    mesh_step = T.jit_train_step(cfg, plan, tc, mesh, specs, bspecs)
    out["step_loss"] = out["grad_norm"] = 0.0
    for b in batches:
        whole, wm = ref_step(whole, b)
        local, gm = mesh_step(local, _rank_batch(b, tc, mesh_step))
        out["step_loss"] = max(out["step_loss"],
                               abs(float(gm["loss"]) - float(wm["loss"])))
        out["grad_norm"] = max(out["grad_norm"], abs(
            float(gm["grad_norm"]) / float(wm["grad_norm"]) - 1))
    got = interop.flatten_with_paths(
        sharding.gather_tree(local["params"], specs["params"], mesh))
    want = interop.flatten_with_paths(whole["params"])
    out["params"] = max(float((got[k].float() - want[k].float()).abs().max())
                        for k in want)
    return out


def _equal(name: str, mode: str, mesh) -> None:
    """A (1, 1) mesh: the loss, every gradient and the params after two
    steps ``torch.equal`` to no mesh."""
    from repro_torch import interop
    from repro_torch.dist.parallel import ShardCtx
    from repro_torch.launch import train as T
    cfg, tc, plan, whole, local, specs = _setup(name, mode, mesh)
    batches = _batches(cfg)
    first = T.batch_on(batches[0], "cpu")
    wl, wp, wg = T.value_and_grad(whole["params"], cfg, first, plan)
    gl, gp, gg = T.mesh_value_and_grad(local["params"], cfg, first, plan,
                                       ShardCtx(mesh), specs["params"])
    assert torch.equal(wl, gl) and torch.equal(wp["aux"], gp["aux"])
    wg, gg = (interop.flatten_with_paths(t) for t in (wg, gg))
    assert all(torch.equal(wg[k], gg[k]) for k in wg)
    ref_step = T.make_train_step(cfg, plan, tc)
    mesh_step = T.jit_train_step(cfg, plan, tc, mesh, specs,
                                 T.batch_specs(cfg))
    for b in batches:
        whole, wm = ref_step(whole, b)
        local, gm = mesh_step(local, _rank_batch(b, tc, mesh_step))
        assert all(torch.equal(wm[k], gm[k]) for k in wm), (wm, gm)
    w, g = (interop.flatten_with_paths(t) for t in (whole, local))
    assert sorted(w) == sorted(g)
    assert all(torch.equal(w[k], g[k]) for k in w)


def _layer(kind: str, mode: str, mesh, **cfg_kw) -> float:
    """One layer of ``kind`` in float32, meshed against unsharded: the
    largest relative gap of its output, its input's gradient and its
    parameters' gradients. ``cfg_kw``: fields replaced in the smoke
    config (e.g. the KV layout's)."""
    from repro_torch import configs, interop
    from repro_torch.api.plan import build_plan
    from repro_torch.core.policy import uniform_policy
    from repro_torch.dist import sharding
    from repro_torch.dist.parallel import ShardCtx
    from repro_torch.launch.train import reduce_data_grads
    from repro_torch.models import attention as A, moe, ssm
    name = {"attn": "qwen3-1.7b", "ssm": "mamba2-370m",
            "moe_ep": "deepseek-moe-16b", "moe_dff": "mixtral-8x7b"}[kind]
    cfg = dataclasses.replace(configs.get(name, smoke=True), **cfg_kw)
    gen = torch.Generator().manual_seed(24)
    if kind == "attn":
        acfg = cfg.attn_cfg(cfg.pattern[0])
        params, specs = A.init(acfg, gen, torch.float32), A.param_specs(acfg)

        def fn(p, x, shard):
            return A.apply_train(p, acfg, x, torch.arange(S), plan,
                                 shard=shard), torch.zeros(())
    elif kind == "ssm":
        params = ssm.init(cfg.ssm, gen, torch.float32)
        specs = ssm.param_specs(cfg.ssm)

        def fn(p, x, shard):
            return ssm.apply_train(p, cfg.ssm, x, plan, shard), \
                torch.zeros(())
    else:
        params = moe.init(cfg.moe, gen, torch.float32)
        specs = moe.param_specs(cfg.moe)

        def fn(p, x, shard):
            return moe.apply_shardmap(p, cfg.moe, x, plan, shard,
                                      global_aux=True)
    plan = build_plan(cfg, uniform_policy(8, 8), mode)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    up = torch.randn((B, S, cfg.d_model), generator=gen)
    shard = ShardCtx(mesh)
    rows = sharding.local_slices(
        x.shape, shard.place(sharding.Spec("dp", None, None)), mesh)

    def run(p, x, up, sh):
        leaves = interop.tree_map(lambda t: t.detach().requires_grad_(True),
                                  p)
        x = x.clone().requires_grad_(True)
        y, aux = fn(leaves, x, sh)
        flat = interop.flatten_with_paths(leaves)
        # The objective: y against the upstream gradient, plus a MoE's
        # auxiliary loss, whose "data" share each rank carries.
        obj = (y * up).sum()
        if sh is not None:
            obj = sh.reduce_from(obj, "dp")
        got = torch.autograd.grad(obj + aux, [x] + list(flat.values()),
                                  allow_unused=True, materialize_grads=True)
        return y.detach(), aux.detach(), got[0], interop.map_with_paths(
            lambda k, _: dict(zip(flat, got[1:]))[k], p)

    wy, waux, wx, wg = run(params, x, up, None)
    gy, gaux, gx, gg = run(sharding.shard_tree(params, specs, mesh), x[rows],
                           up[rows], shard)
    gg = sharding.gather_tree(reduce_data_grads(gg, specs, shard), specs,
                              mesh)
    wg, gg = (interop.flatten_with_paths(t) for t in (wg, gg))
    return max([_gap(wy[rows], gy), _gap(wx[rows], gx), _gap(waux, gaux)]
               + [_gap(wg[k], gg[k]) for k in wg])


def check_layers(mesh, out_dir):
    return {f"{kind} {mode}": _layer(kind, mode, mesh)
            for kind in ("attn", "ssm", "moe_ep", "moe_dff")
            for mode in ("dense", "fake_quant")}


def check_qwen_dense(mesh, out_dir):
    return _train("qwen3-1.7b", "dense", mesh)


def check_qwen_fake_quant(mesh, out_dir):
    return _train("qwen3-1.7b", "fake_quant", mesh)


def check_qwen_accum_compressed(mesh, out_dir):
    return _train("qwen3-1.7b", "dense", mesh, accum=2, compress=True)


def check_deepseek_ep(mesh, out_dir):
    return _train("deepseek-moe-16b", "dense", mesh, f32=True)


def check_mixtral_dff(mesh, out_dir):
    return _train("mixtral-8x7b", "dense", mesh)


def check_mamba2(mesh, out_dir):
    return _train("mamba2-370m", "dense", mesh, f32=True)


def check_equal_qwen_dense(mesh, out_dir):
    _equal("qwen3-1.7b", "dense", mesh)


def check_equal_qwen_fake_quant(mesh, out_dir):
    _equal("qwen3-1.7b", "fake_quant", mesh)


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_layers, check_qwen_dense, check_qwen_fake_quant, check_qwen_accum_compressed,
    check_deepseek_ep, check_mixtral_dff, check_mamba2,
    check_equal_qwen_dense, check_equal_qwen_fake_quant)}
