"""Rank-side checks of the launch analysis's mesh generality, run on the
CPU over gloo: the KV cache split by sequence ("sp"), the ("pod",
"data", "model") mesh and the rule overrides of ``long_500k`` and
``serve_2d_tp``.

:func:`start` starts one process per rank of a gloo world, which runs
meshes of that world one after another, each given by its axis sizes
and names, with the dry run's rule overrides of a cell installed before
anything is compiled; every rank writes ``rank<r>.json`` as
``tests/_dist_ranks.py``'s do (collected by its ``collect``). Each check
holds the meshed session against the unsharded port session that each
rank computes for itself, on the smoke configs. Imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from _dist_ranks import free_port

SEED = 29
BATCH, PROMPT, STEPS = 4, 32, 3
# The decode over a sequence-split cache merges each rank's softmax
# parts (one MAX, one SUM over "sp"), its float32 sums in another order
# than the unsharded decode's. check_combine_f32 holds the attention
# output itself in float32: the float routes differed by at most
# 2.384e-7 (|out| up to 1.72) at (1, 2), (2, 2) and long_500k's sp of 2
# (limit three times that); ``attn_int8`` quantizes each rank's p on its
# own grid: 0.01393 (limit three times that). On the served smoke
# logits the float routes came out equal at every mesh (the reordering
# stayed below every bf16 rounding): the limit is one bf16 step of a
# logit in [4, 8); ``attn_int8``'s logits differed by at most 0.1328
# (limit three times that). A combine that drops its SUM moves the
# logits by 3 or more, the float32 output by 2.1.
SPLIT_ATOL = 0.03125
INT8_SPLIT_ATOL = 0.4
COMBINE_ATOL = 7.2e-7
INT8_COMBINE_ATOL = 0.042


def _policy():
    from repro_torch.core.policy import uniform_policy
    return uniform_policy(8, 8)


def _serve(cfg, mesh, atol):
    """Prefill, STEPS - 1 decode steps at one position (a 0-d tensor in the
    second) and one with per-row positions: every rank's logits equal to
    (``atol`` None) or within ``atol`` of the unsharded session's rows.
    Returns (the largest difference, the largest logit)."""
    import repro_torch
    ref = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                              device="cpu")
    sh = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                             device="cpu", mesh=mesh)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                (BATCH, PROMPT))
    rows = sh.rows(BATCH)
    img = None
    if cfg.n_img_tokens:
        img = torch.from_numpy(np.random.default_rng(SEED + 1).normal(
            size=(BATCH, cfg.n_img_tokens, cfg.d_model)).astype(
                np.float32)).to(torch.bfloat16)
    lr, cr = ref.prefill(toks, ref.init_cache(BATCH, 64), img)
    ls, cs = sh.prefill(toks, sh.init_cache(BATCH, 64), img)
    errs = [(lr[rows].float() - ls.float()).abs().max().item()]
    top = lr.float().abs().max().item()
    tok = torch.argmax(lr[:, 0], -1)
    for i in range(STEPS):
        pos = PROMPT + i
        if i == 1:
            pos = torch.tensor(pos)
        if i == STEPS - 1:
            pos = torch.full((BATCH,), pos, dtype=torch.int32)
        lr, cr = ref.decode(tok, pos, cr)
        ls, cs = sh.decode(tok, pos, cs)
        errs.append((lr[rows].float() - ls.float()).abs().max().item())
        top = max(top, lr.float().abs().max().item())
        tok = torch.argmax(lr, -1)
    err = max(errs)
    if atol is None:
        assert err == 0.0, errs
    else:
        assert err <= atol, (errs, atol)
    return err, top


def _split_cfg(name, **kw):
    from repro_torch import configs
    return dataclasses.replace(configs.get(name, smoke=True), **kw)


def _split(name, **kw):
    """A smoke arch served over a sequence-split cache (this mesh's "sp"
    group of two ranks or more)."""
    def check(mesh, shard):
        assert shard.size("sp") > 1
        atol = INT8_SPLIT_ATOL if kw.get("attn_int8") else SPLIT_ATOL
        return _serve(_split_cfg(name, **kw), mesh, atol)
    return check


def _exact(name, **kw):
    """A smoke arch whose every product on this mesh is an int32 sum."""
    return lambda mesh, shard: _serve(_split_cfg(name, **kw), mesh, None)


def check_train_split(mesh, shard):
    """The attention layer's training forward and backward with every KV
    head on each rank (the sequence-split layout's K/V: all-reduced whole,
    each rank's q heads picking theirs), in float32 against unsharded,
    within ``_dist_train_ranks``' layer limit, for each K/V placement."""
    from _dist_train_ranks import _layer
    from test_torch_dist_train import LAYER_RTOL
    gaps = {}
    for opt in ({}, {"kv_col_parallel": True}, {"kv_replicated": True}):
        gap = _layer("attn", "dense", mesh, decode_pin_seq=True, **opt)
        assert gap <= LAYER_RTOL, (opt, gap, LAYER_RTOL)
        gaps["+".join(opt) or "row"] = gap
    return gaps


def check_heads(mesh, shard):
    """The default layout on this mesh: KV heads over "tp", exact."""
    return _serve(_split_cfg("qwen3-1.7b"), mesh, None)


def check_combine_f32(mesh, shard):
    """``decode_attend_split`` on this rank's slots of a float32-filled
    cache against ``decode_attend`` on the whole cache, in float32, on
    every decode route and a window shorter than the cache: the float
    routes within ``COMBINE_ATOL``, ``attn_int8`` (its p quantized on
    each rank's own grid) within ``INT8_COMBINE_ATOL``. Returns the
    largest difference of each and the largest value."""
    from repro_torch.models import attention as A
    g = torch.Generator().manual_seed(SEED)
    n_sp, r = shard.size("sp"), shard.rank("sp")
    b, s, h, kv, d = 3, 16 * n_sp, 8, 2, 32
    err, top = {"float": 0.0, "int8": 0.0}, 0.0
    for window in (None, 5 * n_sp):
        for bits, int8 in ((16, False), (8, False), (8, True)):
            cfg = A.AttnConfig(d_model=h * d, n_heads=h, n_kv_heads=kv,
                               d_head=d, window=window, kv_cache_bits=bits,
                               attn_int8=int8, decode_pin_seq=True)
            k, v = (torch.randn((b, s, kv, d), generator=g) for _ in "kv")
            cache = A.init_cache(dataclasses.replace(cfg, window=None), b,
                                 s, torch.float32)
            entries = A._cache_entries(cache, cfg, k.to(torch.bfloat16),
                                       v.to(torch.bfloat16))
            for key, val in entries.items():
                cache[key].copy_(val)
            pos = s + 3          # the ring holds positions 4 .. s + 3
            slots = torch.arange(s)
            cache["slot_pos"].copy_(torch.where(slots < 4, slots + s,
                                                slots)[None].expand(b, s))
            q = torch.randn((b, 1, h, d), generator=g)
            want = A.decode_attend(q, cache, cfg, pos)
            lo = r * (s // n_sp)
            local = {key: t[:, lo:lo + s // n_sp].contiguous()
                     for key, t in cache.items()}
            got = A.decode_attend_split(q, local, cfg, pos, shard)
            route = "int8" if int8 else "float"
            err[route] = max(err[route], (want - got).abs().max().item())
            top = max(top, want.abs().max().item())
    assert err["float"] <= COMBINE_ATOL, (err, COMBINE_ATOL)
    assert err["int8"] <= INT8_COMBINE_ATOL, (err, INT8_COMBINE_ATOL)
    return dict(err, top=top)


def check_whole_heads(mesh, shard):
    """q heads that do not split over "tp" (2 heads on serve_2d_tp's 4
    ranks): every head on every rank, the projections still split. The
    served decode (the cache split by sequence) within the split limits;
    the attention layer's training forward and backward in float32
    within ``_dist_train_ranks``' layer limit."""
    from _dist_train_ranks import _layer
    from test_torch_dist_train import LAYER_RTOL
    assert shard.size("tp") > 2
    err = _serve(_split_cfg("qwen3-1.7b", n_heads=2, n_kv_heads=2), mesh,
                 SPLIT_ATOL)
    gap = _layer("attn", "dense", mesh, n_heads=2, n_kv_heads=2)
    assert gap <= LAYER_RTOL, (gap, LAYER_RTOL)
    return {"logits": err[0], "top": err[1], "train": gap}


def check_split_cache(mesh, shard):
    """The sequence-split cache's local slots: the slices of the
    unsharded cache's, positions and all, after a prefill."""
    import repro_torch
    from repro_torch.dist import sharding
    from repro_torch.models import model as M
    cfg = _split_cfg("gemma3-12b", decode_pin_seq=True)
    ref = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                              device="cpu")
    sh = repro_torch.compile(cfg, _policy(), mode="serve_packed",
                             device="cpu", mesh=mesh)
    toks = np.random.default_rng(SEED).integers(0, cfg.vocab,
                                                (BATCH, PROMPT))
    _, cr = ref.prefill(toks, ref.init_cache(BATCH, 64))
    _, cs = sh.prefill(toks, sh.init_cache(BATCH, 64))
    specs = shard.place(M.cache_shard_spec_tree(cfg, shard))
    want = sharding.shard_tree(cr, specs, mesh)
    from repro_torch import interop
    got = interop.flatten_with_paths(cs)
    for key, t in interop.flatten_with_paths(want).items():
        assert torch.equal(t, got[key]), key


CHECKS = {
    "heads": check_heads,
    "combine_f32": check_combine_f32,
    "mamba": _exact("mamba2-370m"),
    "qwen_kvcol_heads": _exact("qwen3-1.7b", kv_col_parallel=True),
    "qwen_kvrep_heads": _exact("qwen3-1.7b", kv_replicated=True),
    "train_split": check_train_split,
    "whole_heads": check_whole_heads,
    "qwen": _split("qwen3-1.7b"),
    "jamba": _split("jamba-v0.1-52b"),
    "split_cache": check_split_cache,
    "qwen_bf16": _split("qwen3-1.7b", decode_pin_seq=True),
    "qwen_kv8": _split("qwen3-1.7b", decode_pin_seq=True, kv_cache_bits=8),
    "qwen_int8": _split("qwen3-1.7b", decode_pin_seq=True, kv_cache_bits=8,
                        attn_int8=True),
    "qwen_mask": _split("qwen3-1.7b", decode_pin_seq=True,
                        mask_cache_update=True),
    "qwen_kvcol": _split("qwen3-1.7b", decode_pin_seq=True,
                         kv_col_parallel=True),
    "qwen_kvrep": _split("qwen3-1.7b", decode_pin_seq=True,
                         kv_replicated=True),
    "gemma_bf16": _split("gemma3-12b", decode_pin_seq=True),
    "gemma_kv8": _split("gemma3-12b", decode_pin_seq=True, kv_cache_bits=8),
    "gemma_int8": _split("gemma3-12b", decode_pin_seq=True, kv_cache_bits=8,
                         attn_int8=True),
    "gemma": _split("gemma3-12b"),
    "vision": _split("llama-3.2-vision-90b", decode_pin_seq=True),
}


def _rank(rank, world, port, meshes, out_dir):
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import init_process, sharding
    from repro_torch.dist.parallel import ShardCtx
    init_process(rank, world, port, device="cpu", timeout_s=120)
    results, errs = {}, {}
    for label, shape, names, overrides, checks in meshes:
        sharding.set_rule_overrides(overrides)
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        shard = ShardCtx(mesh)
        for name in checks:
            key = f"{label}/{name}"
            try:
                err = CHECKS[name](mesh, shard)
                results[key] = "ok"
                if err is not None:
                    errs[key] = err
            except Exception:          # reported per check by the parent
                results[key] = traceback.format_exc()
            dist.barrier()
        sharding.set_rule_overrides({})
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"results": results, "max_abs_err": errs}, f)
    dist.destroy_process_group()


def start(meshes, out_dir: str):
    """Start one process per rank of a gloo world on the CPU, which runs
    each of ``meshes`` in turn: (label, axis sizes, axis names, rule
    overrides installed before anything is compiled, checks), every mesh
    over the whole world. ``_dist_ranks.collect`` waits for them; its
    results are keyed "label/check"."""
    worlds = {int(np.prod(m[1])) for m in meshes}
    assert len(worlds) == 1, worlds
    world = worlds.pop()
    ctx = mp.start_processes(_rank, args=(world, free_port(), list(meshes),
                                          out_dir),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, out_dir
