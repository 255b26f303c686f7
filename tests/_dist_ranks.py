"""Rank-side checks of the port's meshed serving, run on the CPU over gloo
(the training checks are ``tests/_dist_train_ranks.py``'s, started here
with ``module=``).

:func:`start` starts one process per rank of a ("data", "model") mesh,
which runs the named checks; every rank writes ``rank<r>.json``
(check name -> "ok" or the traceback, and for each check held by
tolerance its largest logit difference and largest logit) into ``out_dir``, and a check passes
where every rank says "ok". Each check builds its own inputs from
a numpy seed and holds the meshed session against the unsharded port
session, which each rank computes for itself. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SEED = 23
BATCH, PROMPT, STEPS = 4, 16, 3
# The dense route and mixtral's d_ff-split experts sum bf16 partial
# products over the "model" ranks in float32: a rounding, not an error of
# the sharding. Their logits (largest |logit| 3.64 and 4.0) differ from
# the unsharded session's by at most 0.0546875 and 0.0625 at (1, 2) and
# (2, 2), 0 at (2, 1); the limit is three times that. A dropped partial
# sum moves them by 3.97 and 0.99 or more.
DENSE_ATOL = 0.1875


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _policy(dynamic: bool = False):
    from repro_torch.core.policy import uniform_policy
    pol = uniform_policy(8, 8)
    return dataclasses.replace(pol, dynamic_a=True) if dynamic else pol


def _same(want, got, what: str, atol: float | None) -> float:
    """Holds ``got`` to ``want`` (equal, or within ``atol``); returns their
    largest absolute difference."""
    err = (want.float() - got.float()).abs().max().item()
    if atol is None:
        assert torch.equal(want, got), (what, err)
    else:
        assert err <= atol, (what, err, atol)
    return err


def _serve(name: str, mode: str, mesh, dynamic=False, atol=None):
    """Prefill and STEPS decode steps (the last with per-row positions):
    every rank's logits equal the unsharded session's rows. Returns the
    largest difference of any step, and the largest logit."""
    import repro_torch
    from repro_torch import configs
    cfg = configs.get(name, smoke=True)
    ref = repro_torch.compile(cfg, _policy(dynamic), mode=mode, device="cpu")
    sh = repro_torch.compile(cfg, _policy(dynamic), mode=mode, device="cpu",
                             mesh=mesh)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                (BATCH, PROMPT))
    rows = sh.rows(BATCH)
    lr, cr = ref.prefill(toks, ref.init_cache(BATCH, 64))
    ls, cs = sh.prefill(toks, sh.init_cache(BATCH, 64))
    err = _same(lr[rows], ls, f"{name} {mode} prefill", atol)
    top = lr.float().abs().max().item()
    tok = torch.argmax(lr[:, 0], -1)
    for i in range(STEPS):
        pos = PROMPT + i
        if i == STEPS - 1:
            pos = torch.full((BATCH,), pos, dtype=torch.int32)
        lr, cr = ref.decode(tok, pos, cr)
        ls, cs = sh.decode(tok, pos, cs)
        err = max(err, _same(lr[rows], ls, f"{name} {mode} decode {i}",
                             atol))
        top = max(top, lr.float().abs().max().item())
        tok = torch.argmax(lr, -1)
    return cfg, ref, sh, toks, (err, top)


def _specs(cfg, mode):
    from repro_torch.models import model as M
    specs = M.param_spec_tree(cfg)
    if mode != "dense":
        specs = M.convert_specs_for_serving(M.param_skeleton(cfg), specs,
                                            mode)
    return specs


def check_qwen_packed(mesh, out_dir):
    """serve_packed exact; the rank's packed bytes are the slice of the
    unsharded packing; gather_tree puts them back; generate and
    jit_serve_steps give the session's results."""
    from repro_torch import interop
    from repro_torch.dist import sharding
    from repro_torch.launch.serve import jit_serve_steps
    from repro_torch.models import model as M
    cfg, ref, sh, toks, _ = _serve("qwen3-1.7b", "serve_packed", mesh)
    specs = _specs(cfg, "serve_packed")
    want = sharding.shard_tree(ref.params, specs, mesh)
    for key, t in interop.flatten_with_paths(sh.params).items():
        assert torch.equal(interop.flatten_with_paths(want)[key], t), key
    whole = sharding.gather_tree(sh.params, specs, mesh)
    for key, t in interop.flatten_with_paths(ref.params).items():
        assert torch.equal(interop.flatten_with_paths(whole)[key], t), key
    assert np.array_equal(sh.generate(toks, 4, 64), ref.generate(toks, 4, 64))
    prefill, decode = jit_serve_steps(cfg, sh.plan, mesh, specs,
                                      M.cache_shard_spec_tree(cfg))
    local = torch.as_tensor(toks)[sh.rows(BATCH)]
    got, _ = prefill(sh.params, local, sh.init_cache(BATCH, 64))
    want_l, _ = sh.prefill(toks, sh.init_cache(BATCH, 64))
    assert torch.equal(got, want_l)


def check_qwen_int8(mesh, out_dir):
    _serve("qwen3-1.7b", "serve_int8", mesh)


def check_qwen_dynamic(mesh, out_dir):
    """dynamic_a (K3's route) on the K-slices: exact, and equal to the
    static route."""
    _, ref, sh, toks, _ = _serve("qwen3-1.7b", "serve_packed", mesh,
                                 dynamic=True)
    import repro_torch
    static = repro_torch.compile(ref.cfg, _policy(), mode="serve_packed",
                                 device="cpu", mesh=mesh)
    a, _ = sh.prefill(toks, sh.init_cache(BATCH, 64))
    b, _ = static.prefill(toks, static.init_cache(BATCH, 64))
    assert torch.equal(a, b)


def check_qwen_dense(mesh, out_dir):
    return _serve("qwen3-1.7b", "dense", mesh, atol=DENSE_ATOL)[-1]


def _all_reduce_groups(fn) -> list:
    """The process groups of the all-reduces that ``fn()`` issues."""
    seen, real = [], dist.all_reduce

    def spy(*a, **k):
        seen.append(k.get("group"))
        return real(*a, **k)
    dist.all_reduce = spy
    try:
        fn()
    finally:
        dist.all_reduce = real
    return seen


def check_deepseek_ep(mesh, out_dir):
    """Exact, and a serving step all-reduces nothing over "data" (its
    only collectives there gather "fsdp" weights): the router's auxiliary
    loss, which serving discards, is not reduced."""
    _, _, sh, toks, _ = _serve("deepseek-moe-16b", "serve_packed", mesh)
    cache = sh.init_cache(BATCH, 64)
    used = _all_reduce_groups(lambda: sh.prefill(toks, cache))
    used += _all_reduce_groups(lambda: sh.decode(
        torch.zeros(BATCH, dtype=torch.long), PROMPT, cache))
    assert used, "the expert-parallel step all-reduced nothing"
    data = sh.shard.group("data")
    assert data not in used, sum(g is data for g in used)


def check_deepseek_int8(mesh, out_dir):
    _serve("deepseek-moe-16b", "serve_int8", mesh)


def check_jamba(mesh, out_dir):
    _serve("jamba-v0.1-52b", "serve_packed", mesh)


def check_mixtral_dff(mesh, out_dir):
    return _serve("mixtral-8x7b", "serve_packed", mesh, atol=DENSE_ATOL)[-1]


def check_ckpt_restore(mesh, out_dir):
    """A dense checkpoint restored with ``shardings=`` is the slices of
    the unsharded restore."""
    from repro_torch import configs, interop
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.dist import sharding
    from repro_torch.models import model as M
    cfg = configs.get("qwen3-1.7b", smoke=True)
    d = os.path.join(out_dir, "restore")
    if dist.get_rank() == 0:
        ck.save_checkpoint(d, 0, M.init_params(
            cfg, torch.Generator().manual_seed(SEED)))
    dist.barrier()
    skel = M.param_skeleton(cfg)
    whole, _ = ck.restore_checkpoint(d, 0, skel, device="cpu")
    specs = M.param_spec_tree(cfg)
    got, step = ck.restore_latest(d, skel, device="cpu",
                                  shardings=sharding.named_tree(specs, mesh))
    want = interop.flatten_with_paths(sharding.shard_tree(whole, specs, mesh))
    assert step == 0
    for key, t in interop.flatten_with_paths(got).items():
        assert torch.equal(want[key], t), key


def check_ckpt_save(mesh, out_dir):
    """A save of a meshed serving tree writes the bytes of the unsharded
    session's save, file for file."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.dist import sharding
    cfg = configs.get("qwen3-1.7b", smoke=True)
    sh = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                             device="cpu", mesh=mesh)
    a, b = os.path.join(out_dir, "sharded"), os.path.join(out_dir, "whole")
    named = sharding.named_tree(_specs(cfg, "serve_packed"), mesh)
    path = ck.save_checkpoint(a, 7, sh.params, shardings=named)
    if dist.get_rank() != 0:
        assert path is None
        return
    ref = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                              device="cpu")
    other = ck.save_checkpoint(b, 7, ref.params)
    names = sorted(os.listdir(path))
    assert names == sorted(os.listdir(other)) and len(names) > 10
    for n in names:
        with open(os.path.join(path, n), "rb") as f, \
                open(os.path.join(other, n), "rb") as g:
            assert f.read() == g.read(), n


def _reference_run(name: str, mesh, out_dir: str) -> None:
    """The port's meshed session on packed weights restored from the
    reference's checkpoint (``<out_dir>/<name>/ckpt``, once
    ``<name>/ready`` shows it written; restored with ``shardings=``
    straight to this rank's shards) over ``<out_dir>/<name>/tokens.npy``:
    the greedy loop step by step, as the reference's script runs it. Each
    rank saves (``port_rank<r>.npz``) the whole batch's logits of every
    step (its rows gathered over "data"), its ``generate`` tokens, and
    each step's router gap: per row, the least over the MoE layers of the
    k-th chosen expert's gate less the best gate left out, where a near
    tie lets the packages' rounding route the token differently (``inf``
    without MoE, and at the prefill)."""
    import repro_torch
    from repro_torch import configs
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.dist import sharding
    from repro_torch.models import model as M, moe
    cfg = configs.get(name, smoke=True)
    d = os.path.join(out_dir, name)
    toks = np.load(os.path.join(d, "tokens.npy"))
    for _ in range(3000):                  # the reference saves, then marks
        if os.path.exists(os.path.join(d, "ready")):
            break
        time.sleep(0.1)
    skel = M.convert_params_for_serving(M.param_skeleton(cfg), _policy(),
                                        "serve_packed")       # meta tensors
    params, _ = ck.restore_checkpoint(
        os.path.join(d, "ckpt"), 0, skel, device="cpu",
        shardings=sharding.named_tree(_specs(cfg, "serve_packed"), mesh))
    sess = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                               device="cpu", params=params, mesh=mesh)
    gaps = []
    route = moe._route

    def spy(logits, mcfg, shard=None):
        g = torch.softmax(logits.float(), -1).sort(-1, descending=True)[0]
        gaps.append((g[..., mcfg.top_k - 1] - g[..., mcfg.top_k]).amin(-1))
        return route(logits, mcfg, shard)

    logits, cache = sess.prefill(toks)
    steps = [sess._whole_rows(logits[:, 0])]
    gap = [torch.full((toks.shape[0],), np.inf)]
    moe._route = spy
    try:
        for i in range(GEN_LEN - 1):
            tok = torch.argmax(steps[-1], -1)
            gaps.clear()
            logits, cache = sess.decode(tok, toks.shape[1] + i, cache)
            steps.append(sess._whole_rows(logits))
            gap.append(sess._whole_rows(torch.stack(gaps).amin(0))
                       if gaps else gap[0])
    finally:
        moe._route = route
    np.savez(os.path.join(d, f"port_rank{dist.get_rank()}.npz"),
             steps=torch.stack(steps, 1).float().numpy(),
             router_gap=torch.stack(gap, 1).numpy(),
             tokens=sess.generate(toks, GEN_LEN))


GEN_LEN = 6


def _reference_train(mesh, out_dir: str) -> None:
    """The port's meshed training on the reference's seed-0 dense params
    (``<out_dir>/qwen3-1.7b/train_ckpt``, restored with ``shardings=``)
    and batch (``train_batch.npz``): the loss and gradients of
    ``mesh_value_and_grad``, then one ``jit_train_step`` on this rank's
    rows. Rank 0 saves them gathered (``port_train.npz``); every rank
    saves its ``compressed_psum`` over the world of its row ``r`` of
    ``compress_in.npz`` (``compress_port<r>.npz``)."""
    from repro_torch import configs, interop
    from repro_torch.api import plan as planlib
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.dist import sharding
    from repro_torch.dist.parallel import ShardCtx
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import Schedule, adamw_init, compressed_psum
    cfg = configs.get("qwen3-1.7b", smoke=True)
    d = os.path.join(out_dir, "qwen3-1.7b")
    tc = T.TrainConfig(sched=Schedule(warmup_steps=1, total_steps=10))
    specs = T.train_state_specs(cfg, tc)
    pspecs = specs["params"]
    params, _ = ck.restore_checkpoint(
        os.path.join(d, "train_ckpt"), 0, M.param_skeleton(cfg),
        device="cpu", shardings=sharding.named_tree(pspecs, mesh))
    batch = dict(np.load(os.path.join(d, "train_batch.npz")))
    plan = planlib.build_plan(cfg, _policy(), "dense")
    bspecs = T.batch_specs(cfg)
    rows = {k: sharding.shard_leaf(v, bspecs[k], mesh)
            for k, v in T.batch_on(batch, "cpu").items()}
    loss, _, grads = T.mesh_value_and_grad(params, cfg, rows, plan,
                                           ShardCtx(mesh), pspecs)
    grads = sharding.gather_tree(grads, pspecs, mesh)
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    step = T.jit_train_step(cfg, plan, tc, mesh, specs, bspecs)
    mine = T.batch_rows(len(batch["tokens"]), tc, step.shard)
    state, metrics = step(state, {k: v[mine] for k, v in batch.items()})
    new = sharding.gather_tree(state["params"], pspecs, mesh)
    r = dist.get_rank()
    if r == 0:
        def f32(tree):
            return {k: v.float().numpy() for k, v in
                    interop.flatten_with_paths(tree).items()}
        np.savez(os.path.join(d, "port_train.npz"), loss=float(loss),
                 **{k: float(metrics[k]) for k in ("grad_norm", "lr")},
                 step_loss=float(metrics["loss"]),
                 **{"grad:" + k: v for k, v in f32(grads).items()},
                 **{"param:" + k: v for k, v in f32(new).items()})
    tree = dict(np.load(os.path.join(out_dir, "compress_in.npz")))
    summed = compressed_psum(
        {"a": torch.from_numpy(tree["a"][r]),
         "b": torch.from_numpy(tree["b"][r]).to(torch.bfloat16)}, None)
    np.savez(os.path.join(out_dir, f"compress_port{r}.npz"),
             **{k: v.float().numpy() for k, v in summed.items()})


def check_reference_qwen(mesh, out_dir):
    _reference_run("qwen3-1.7b", mesh, out_dir)
    _reference_train(mesh, out_dir)


def check_reference_deepseek(mesh, out_dir):
    _reference_run("deepseek-moe-16b", mesh, out_dir)


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_qwen_packed, check_qwen_int8, check_qwen_dynamic, check_qwen_dense,
    check_deepseek_ep, check_deepseek_int8, check_jamba, check_mixtral_dff,
    check_ckpt_restore, check_ckpt_save, check_reference_qwen,
    check_reference_deepseek)}


def _rank(rank, world, port, model, out_dir, checks, module):
    torch.set_num_threads(1)
    from repro_torch.dist import init_process
    from repro_torch.launch.mesh import make_host_mesh
    init_process(rank, world, port, device="cpu", timeout_s=120)
    mesh = make_host_mesh(world, model=model, device="cpu")
    table = importlib.import_module(module).CHECKS
    results, errs = {}, {}
    for name in checks:
        try:
            err = table[name](mesh, out_dir)
            results[name] = "ok"
            if err is not None:
                errs[name] = err
        except Exception:          # reported per check by the parent
            results[name] = traceback.format_exc()
        dist.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"results": results, "max_abs_err": errs}, f)
    dist.destroy_process_group()


def start(shape: tuple, checks, out_dir: str, module: str = __name__):
    """Start ``checks`` (names in ``module``'s ``CHECKS``) on a gloo mesh
    of ``shape`` (data, model) on the CPU, one process per rank;
    :func:`collect` waits for them."""
    world = shape[0] * shape[1]
    ctx = mp.start_processes(_rank, args=(world, free_port(), shape[1],
                                          out_dir, list(checks), module),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, out_dir


def collect(started) -> tuple[dict, dict]:
    """({check: [each rank's result]}, {check: (the largest difference,
    the largest logit) on any rank}) of a :func:`start`ed mesh; the second
    holds the checks held by tolerance (a check that returns a dict of
    readings gets each reading's largest over the ranks)."""
    ctx, world, out_dir = started
    while not ctx.join():
        pass
    out, errs = {}, {}
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got = json.load(f)
        for name, res in got["results"].items():
            out.setdefault(name, []).append(res)
        for name, err in got["max_abs_err"].items():
            if isinstance(err, dict):
                old = errs.setdefault(name, {})
                errs[name] = {k: max(v, old.get(k, v)) for k, v in
                              err.items()}
            else:
                errs[name] = tuple(map(max, errs.get(name, (0.0, 0.0)),
                                       err))
    return out, errs
