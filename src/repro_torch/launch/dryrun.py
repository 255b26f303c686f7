"""Dry run of the launch grid: trace every (arch x shape) cell's step on a
fake world of 256 ranks (one pod) or 512 (two), prove its memory and
sharding coherent, and read the roofline terms from the traced program.

PyTorch-port counterpart of ``repro/launch/dryrun.py``::

    python -m repro_torch.launch.dryrun --arch musicgen_large \\
        --shape decode_32k --mesh single
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh single
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape all \\
        --mesh multi --weights serve_packed --exec-mode serve_packed

The reference lowers and compiles each cell with 512 placeholder devices.
The port runs one process as rank 0 of a fake process group
(``dist.init_process_group("fake", ...)``: collectives return at once),
builds the production mesh on it, and traces rank 0's step on fake
tensors (``launch.shapes``) on the ``torch_ref`` backend, as the
reference lowers ``xla``: train cells ``launch.train.jit_train_step``,
serving cells ``launch.serve.jit_serve_steps`` with the cache spec the
cell's rules select (``model.cache_shard_spec_tree``). Nothing is
allocated and nothing runs on a device. ``launch.opanalysis`` records the
step: its operations, HBM bytes, collectives by kind and peak memory per
rank; ``roofline_terms`` turns them into seconds on the H100 SXM's
datasheet constants. Every time here is modeled, not measured.

The reference's analyzer multiplies a scanned loop's body by its trip
count; the port's layer groups are Python loops, so the dry run traces
the step at one and at two layer groups and extrapolates linearly to the
config's groups (every group runs the same program: operations, bytes,
kernels and collectives are exact; the peak memory is extrapolated the
same way), and a single group ending in a run of like layers by that
run (:func:`depth_variants`).

Each cell writes one JSON record under ``--out-dir`` (``results/`` is
git-ignored) with the reference's fields: ``n_devices``,
``memory_analysis`` (argument, output and temp bytes per rank),
``flops``, ``hbm_bytes``, ``collective_by_kind``, ``t_compute_s``,
``t_memory_s``, ``t_collective_s``, ``dominant``, ``bound_s``,
``model_flops_global``, the ``ideal_*`` bounds, ``roofline_fraction``,
``profile`` with ``--profile``, and ``t_trace_s`` in place of
``t_lower_s`` / ``t_compile_s``. A cell whose per-rank peak passes the
card's 80 GiB is reported so (``over_hbm``), not failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.api.plan import build_plan
from repro_torch.dist import sharding
from repro_torch.kernels import work as W
from repro_torch.launch import opanalysis, shapes
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
HBM_PER_CARD = 80 * 2 ** 30          # H100 80GB HBM3
PEAK_FLOPS = W.BF16_FLOPS            # the ideal's compute rate
WORLDS = {"single": 256, "multi": 512}


def _attn_flops(cfg, cell, factor: float) -> float:
    """Attention score/value FLOPs (not in 6ND). factor: 3 for train
    (fwd+bwd), 1 for prefill. Causal halves the S^2 term; windows clamp."""
    total = 0.0
    b, s = cell.batch, cell.seq
    for spec in cfg.pattern:
        if spec.kind == "mamba":
            ssm = cfg.ssm
            # SSD intra-chunk quadratic + state terms per token
            per_tok = 2 * ssm.chunk * ssm.d_inner + 4 * ssm.d_state * ssm.d_inner
            total += per_tok * b * s
            continue
        n_ctx = min(spec.window or s, s) if spec.kind != "cross" \
            else cfg.n_img_tokens
        h, dh = cfg.n_heads, cfg.d_head
        causal_frac = 0.5 if (spec.kind == "attn" and not spec.window) else 1.0
        total += 4.0 * b * h * dh * s * n_ctx * causal_frac
    return total * factor * cfg.n_groups


def model_flops(cfg, cell) -> float:
    """Algorithmic FLOPs for the cell (GLOBAL, not per rank):
    6*N_active*D train / 2*N_active*D prefill / 2*N_active*B decode."""
    _, n_active = shapes.active_param_count(cfg)
    if cell.kind == "train":
        return 6.0 * n_active * cell.batch * cell.seq + _attn_flops(cfg, cell, 3.0)
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.batch * cell.seq + _attn_flops(cfg, cell, 1.0)
    # decode: one token per sequence; KV/state read compute
    kv_term = 0.0
    for spec in cfg.pattern:
        if spec.kind == "mamba":
            kv_term += 4.0 * cfg.ssm.d_state * cfg.ssm.d_inner * cell.batch
        else:
            n_ctx = min(spec.window or cell.seq, cell.seq)
            kv_term += 4.0 * cell.batch * cfg.n_heads * cfg.d_head * n_ctx
    return 2.0 * n_active * cell.batch + kv_term * cfg.n_groups


def ideal_bounds(cfg, cell, n_dev: int, weights: str, cache_bytes: float,
                 w_bits: int = 8) -> dict:
    """Analytic per-rank lower bounds for the cell -- the roofline 'ideal'
    (the reference's arithmetic, on the H100's bf16 peak and HBM3 rate).

    compute_ideal: MODEL_FLOPS at the bf16 tensor-core peak.
    memory_ideal: unavoidable HBM traffic -- weights at the mode's storage
    precision (the paper's lever), KV/SSM state, plus (train) optimizer
    state r/w and one residual-stream activation store+reload per layer.
    roofline_fraction := ideal_bound / achieved_bound  (1.0 = at roofline).
    """
    n_total, n_active = shapes.active_param_count(cfg)
    wb = {"dense": 2.0, "serve_int8": 1.0,
          "serve_packed": 2.0 * w_bits / 16.0}[weights]
    mflops = model_flops(cfg, cell) / n_dev
    if cell.kind == "train":
        # params bf16 r+w, grads bf16 w+r, adam moments f32 r+w each
        weight_traffic = n_total * (2 + 2 + 2 + 2 + 8 + 8) / n_dev
        act_traffic = (6.0 * cell.batch * cell.seq * cfg.d_model
                       * cfg.n_layers) / n_dev
        mem_bytes = weight_traffic + act_traffic
    elif cell.kind == "prefill":
        act_traffic = (4.0 * cell.batch * cell.seq * cfg.d_model
                       * cfg.n_layers) / n_dev
        mem_bytes = n_total * wb / n_dev + act_traffic + cache_bytes / n_dev
    else:  # decode: every live weight + the whole cache, once per token
        mem_bytes = n_active * wb / n_dev + cache_bytes / n_dev
    t_c = mflops / PEAK_FLOPS
    t_m = mem_bytes / W.HBM_BYTES_PER_S
    return {"ideal_compute_s": t_c, "ideal_memory_s": t_m,
            "ideal_bound_s": max(t_c, t_m), "ideal_mem_bytes": mem_bytes}


def overrides_for(cell, mesh_kind: str, serve_2d_tp: bool = False) -> dict:
    ov = {}
    if cell.name == "long_500k":
        ov["dp"] = ()
        ov["sp"] = ("pod", "data", "model") if mesh_kind == "multi" \
            else ("data", "model")
    if serve_2d_tp and cell.kind in ("decode", "prefill"):
        # 2D tensor parallelism for serving: weights sharded over
        # (data, model); no per-step FSDP all-gather.
        ov["fsdp"] = ()
        ov["tp"] = ("data", "model") if cell.name != "long_500k" else "model"
    return ov


_OPTS = ("flashvjp", "rematdots", "rematnone", "moedff", "moeep", "moesm",
         "kvcol", "kvrep", "pinseq", "kv8", "gqa", "maskupd", "attnint8")


def apply_opts(cfg, opts):
    """Config-level optimization toggles, the reference's:

    flashvjp   memory-efficient attention backward (custom VJP)
    rematdots  save dot outputs instead of full-recompute remat
    rematnone  no activation checkpointing at all
    moedff     TP-within-expert (d_ff sharded) instead of expert-parallel
    moeep      expert-parallel (experts over tp)
    moesm      the explicit shard_map expert-parallel switch
    kvcol      K/V projections column-parallel
    kvrep      K/V projections replicated over tp
    pinseq     the KV cache split by sequence (flash-decoding)
    kv8        int8 KV cache (the paper's precision-scaled memory on KV)
    gqa        grouped decode (no route of its own in the port)
    maskupd    elementwise where() cache writes
    attnint8   integer QK/PV on the int8 cache
    block<N>   attention block size N
    """
    r = dataclasses.replace
    table = {
        "flashvjp": lambda c: r(c, flash_vjp=True),
        "rematdots": lambda c: r(c, remat="dots"),
        "rematnone": lambda c: r(c, remat="none"),
        "moedff": lambda c: r(c, moe=r(c.moe, expert_parallel=False)),
        "moeep": lambda c: r(c, moe=r(c.moe, expert_parallel=True)),
        "moesm": lambda c: r(c, moe=r(c.moe, shard_map_ep=True)),
        "kvcol": lambda c: r(c, kv_col_parallel=True),
        "kvrep": lambda c: r(c, kv_replicated=True),
        "pinseq": lambda c: r(c, decode_pin_seq=True),
        "kv8": lambda c: r(c, kv_cache_bits=8),
        "gqa": lambda c: r(c, gqa_decode=True),
        "maskupd": lambda c: r(c, mask_cache_update=True),
        "attnint8": lambda c: r(c, attn_int8=True),
    }
    for o in [o for o in opts if o]:
        if o in table:
            cfg = table[o](cfg)
        elif o.startswith("block"):
            cfg = r(cfg, attn_block=int(o[5:]))
        else:
            raise ValueError(f"unknown opt {o}")
    return cfg


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def fake_world(n: int) -> None:
    """This process as rank 0 of a fake process group of ``n`` ranks (one
    default group a process: a world of another size replaces it)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def production_mesh(mesh_kind: str):
    """The production mesh of ``mesh_kind`` on a fake world."""
    from repro_torch.launch.mesh import make_production_mesh
    fake_world(WORLDS[mesh_kind])
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


# ---------------------------------------------------------------------------
# One step, traced
# ---------------------------------------------------------------------------

def _local(tree, specs, shard):
    """This rank's shards of a fake tree, each in a storage of its own
    (a contiguous slice would otherwise keep the whole leaf's)."""
    if shard is None:
        return tree
    from repro_torch import interop

    def own(t):
        whole = t.untyped_storage().nbytes() != t.numel() * t.element_size()
        return t.clone() if whole else t
    with shapes.fake_mode():
        return interop.tree_map(own, sharding.shard_tree(
            tree, shard.place(specs), shard.mesh))


def build_step(cfg, cell, weights: str, exec_mode: str, shard=None,
               cache_len: int | None = None, decode_pos: int | None = None):
    """(fn, args, inference) of one cell's step for this rank: ``fn(*args)``
    runs it; ``args`` are rank-local fake tensors (a train step's batch:
    the rank's "dp" rows, which ``launch.train.batch_rows`` gives it at
    the cell's one microbatch); ``inference``: run under
    ``torch.inference_mode``. ``cache_len``: the cache's slots (the
    cell's sequence when None); ``decode_pos``: the decode's position as
    the int ``ServingSession.generate`` passes (a 0-d int32 tensor, the
    reference's, when None)."""
    from repro_torch.core.policy import uniform_policy
    policy = uniform_policy(8, 8)
    plan = build_plan(cfg, policy, mode=exec_mode, backend="torch_ref")
    mesh = None if shard is None else shard.mesh
    batch, bspecs = shapes.batch_structs(cfg, cell)
    batch = _local(batch, bspecs, shard)
    if cell.kind == "train":
        from repro_torch.launch.train import (TrainConfig, jit_train_step,
                                              make_train_step)
        tc = TrainConfig(opt=AdamWConfig(
            moment_dtype="bfloat16" if cfg.d_model >= 8192 else "float32"))
        state, sspecs = shapes.train_state_structs(cfg, tc.opt)
        fn = make_train_step(cfg, plan, tc) if shard is None else \
            jit_train_step(cfg, plan, tc, mesh, sspecs, bspecs)
        return fn, (_local(state, sspecs, shard), batch), False
    from repro_torch.launch.serve import jit_serve_steps
    params, pspecs = shapes.param_structs(cfg, serving_mode=weights,
                                          policy=policy)
    sized = dataclasses.replace(cell, seq=cache_len or cell.seq)
    cache, _ = shapes.cache_structs(cfg, sized)
    cspecs = M.cache_shard_spec_tree(cfg, shard)
    prefill, decode = jit_serve_steps(cfg, plan, mesh, pspecs, cspecs)
    params, cache = _local(params, pspecs, shard), _local(cache, cspecs,
                                                          shard)
    if cell.kind == "prefill":
        args = (params, batch["tokens"], cache)
        if cfg.n_img_tokens:
            args += (batch["img_embeds"],)
        return prefill, args, True
    pos = batch["pos"] if decode_pos is None else decode_pos
    return decode, (params, batch["token"], pos, cache), True


def trace(fn, args, inference: bool, comm=None, profile: bool = False):
    """(totals, profile or None, seconds) of one run of ``fn(*args)`` on
    fake tensors under :class:`~repro_torch.launch.opanalysis.OpAnalysis`."""
    t0 = time.perf_counter()
    grad = torch.inference_mode() if inference else torch.enable_grad()
    with shapes.fake_mode(), grad, opanalysis.OpAnalysis(
            comm, profile=profile, arguments=args) as a:
        out = fn(*args)
    t = a.totals()
    t.output_bytes = float(opanalysis.storage_bytes((out, args))
                           - opanalysis.storage_bytes(args))
    return t, (a.attribute() if profile else None), \
        time.perf_counter() - t0


def _extrapolate(t1, t2, n: int):
    """t1 + (n - 1) (t2 - t1) of two numbers or Counters/dicts."""
    if isinstance(t1, dict):
        keys = list(t1) + [k for k in t2 if k not in t1]
        return {k: _extrapolate(t1.get(k, 0), t2.get(k, 0), n)
                for k in keys}
    return t1 + (n - 1) * (t2 - t1)


def depth_variants(cfg):
    """(a, b, n): two shallower configs whose traces give the whole one's
    as T(a) + n (T(b) - T(a)) -- one and two layer groups (n = groups -
    1), or, for a single group whose pattern ends in a run of r >= 3
    like layers (deepseek's 27 MoE layers after a dense one), that run
    cut to one and two layers (n = r - 1); None where neither applies."""
    if cfg.n_groups > 2:
        return (dataclasses.replace(cfg, n_layers=cfg.period),
                dataclasses.replace(cfg, n_layers=2 * cfg.period),
                cfg.n_groups - 1)
    pat = cfg.pattern
    run = 1
    while run < len(pat) and pat[-1 - run] == pat[-1]:
        run += 1
    if cfg.n_groups == 1 and run >= 3:
        head = pat[:len(pat) - run]
        return tuple(dataclasses.replace(
            cfg, pattern=head + pat[-1:] * k, n_layers=len(head) + k)
            for k in (1, 2)) + (run - 1,)
    return None


def traced_totals(cfg, cell, weights: str, exec_mode: str, shard=None,
                  full_depth: bool = False, profile: bool = False,
                  cache_len: int | None = None,
                  decode_pos: int | None = None) -> tuple:
    """(Totals, profile, trace seconds, layers traced) of a cell's step on
    this rank: traced at two shallower depths and extrapolated
    (:func:`depth_variants`; module docstring), or traced whole
    (``full_depth``). The argument bytes are the whole config's.
    ``cache_len``, ``decode_pos``: :func:`build_step`'s."""
    def run(c):
        fn, args, inf = build_step(c, cell, weights, exec_mode, shard,
                                   cache_len, decode_pos)
        step_shard = getattr(fn, "shard", None)
        return trace(fn, args, inf, step_shard and step_shard.comm, profile)

    variants = None if full_depth else depth_variants(cfg)
    if variants is None:
        t, prof, secs = run(cfg)
        return t, prof, secs, cfg.n_layers
    a, b, n = variants
    t1, p1, s1 = run(a)
    t2, p2, s2 = run(b)
    fields = {f.name: _extrapolate(getattr(t1, f.name), getattr(t2, f.name),
                                   n + 1)
              for f in dataclasses.fields(t1)}
    t = opanalysis.Totals(**fields)
    prof = None
    if profile:
        prof = {k: sorted(_extrapolate(dict(p1[k]), dict(p2[k]),
                                       n + 1).items(),
                          key=lambda kv: -kv[1])[:12] for k in p1}
    _, args, _ = build_step(cfg, cell, weights, exec_mode, shard, cache_len,
                            decode_pos)
    t.argument_bytes = float(opanalysis.storage_bytes(args))
    return t, prof, s1 + s2, a.n_layers + b.n_layers


def serving_counts(cfg, weights: str, batch: int, prompt: int,
                   cache_len: int) -> dict:
    """The world-one dry run of a served request: {"prefill": Totals of a
    ``batch`` x ``prompt`` prefill, "decode": Totals of the decode step
    that follows it} over a cache of ``cache_len`` slots, traced on fake
    tensors on ``torch_ref`` (int32 tokens; the decode's position the
    int ``prompt``, as ``ServingSession.generate`` passes it). What the
    card's own step, run under ``OpAnalysis``, must count alike
    (``chip_smoke.py``'s launch phase)."""
    out = {}
    for kind in ("prefill", "decode"):
        cell = shapes.ShapeCell(f"serve_{kind}", kind, prompt, batch)
        out[kind] = traced_totals(cfg, cell, weights, weights,
                                  cache_len=cache_len,
                                  decode_pos=prompt)[0]
    return out


def train_counts(cfg, exec_mode: str, batch: int, seq: int):
    """The world-one dry run of one train step (:func:`serving_counts`'
    counterpart): the Totals of :func:`build_step`'s train step in
    ``exec_mode`` (``dense`` or ``fake_quant``; AdamW, float32 moments
    below d_model 8192, accum 1) on a fake state and a fake batch of
    ``batch`` x ``seq`` int32 tokens and labels, traced on ``torch_ref``
    with its backward. What the card's step, run under ``OpAnalysis`` on
    a batch laid out alike, must count alike (``chip_smoke.py``'s train
    phase); a schedule changes its values, not its operations."""
    cell = shapes.ShapeCell("train_step", "train", seq, batch)
    return traced_totals(cfg, cell, "dense", exec_mode)[0]


def _cache_bytes(cfg, cell) -> float:
    cache, _ = shapes.cache_structs(cfg, cell)
    return float(shapes.tree_bytes(cache))


def run_cell(arch: str, shape_name: str, mesh_kind: str, weights: str = "dense",
             exec_mode: str = "dense", tag: str = "", serve_2d_tp: bool = False,
             out_dir: str = RESULTS_DIR, verbose: bool = True,
             opts=(), profile_ops: bool = False) -> dict:
    from repro_torch.dist.parallel import ShardCtx
    cfg = apply_opts(configs.get(arch), opts)
    if opts and not tag:
        tag = "-".join(opts) + ("-2dtp" if serve_2d_tp else "")
    elif serve_2d_tp and not tag:
        tag = "2dtp"
    cell = shapes.SHAPES[shape_name]
    if not shapes.cell_is_applicable(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "skipped": "full-attention arch: long_500k inapplicable"}

    mesh = production_mesh(mesh_kind)
    n_dev = mesh.size()
    sharding.set_rule_overrides(overrides_for(cell, mesh_kind, serve_2d_tp))
    try:
        shard = ShardCtx(mesh)
        totals, profile, t_trace, traced = traced_totals(
            cfg, cell, weights, exec_mode, shard, profile=profile_ops)
        arg_bytes = totals.argument_bytes
        mflops = model_flops(cfg, cell)
        terms = opanalysis.roofline_terms(totals, mflops / n_dev)
        cache_bytes = _cache_bytes(cfg, cell) if cell.kind != "train" \
            else 0.0
        ideal = ideal_bounds(cfg, cell, n_dev, weights, cache_bytes)
        terms.update(ideal)
        terms["roofline_fraction"] = ideal["ideal_bound_s"] / terms["bound_s"]
        peak = max(totals.peak_bytes, arg_bytes)
        mem_d = {"argument_size_in_bytes": arg_bytes,
                 "output_size_in_bytes": totals.output_bytes,
                 "temp_size_in_bytes": max(
                     0.0, peak - arg_bytes - totals.output_bytes),
                 "peak_size_in_bytes": peak}
        rec = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "weights": weights, "exec_mode": exec_mode, "tag": tag,
            "n_devices": n_dev, "t_trace_s": round(t_trace, 2),
            "layers_traced": traced,
            "memory_analysis": mem_d, "over_hbm": peak > HBM_PER_CARD,
            "n_ops": totals.n_ops, "n_collectives": totals.n_collectives,
            "link_bytes": totals.link_bytes,
            "model_flops_global": mflops, **terms,
        }
        if profile is not None:
            rec["profile"] = profile
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_kind} "
                  f"({weights}/{exec_mode}{('/' + tag) if tag else ''}): "
                  f"OK args={arg_bytes / 2**30:.2f}GiB/dev "
                  f"peak={peak / 2**30:.2f}GiB/dev"
                  f"{' OVER 80GiB' if rec['over_hbm'] else ''} "
                  f"compute={terms['t_compute_s']*1e3:.2f}ms "
                  f"mem={terms['t_memory_s']*1e3:.2f}ms "
                  f"coll={terms['t_collective_s']*1e3:.2f}ms "
                  f"dominant={terms['dominant']} "
                  f"roofline_frac={terms['roofline_fraction']:.3f} "
                  f"kernels={terms['kernels']} (trace {t_trace:.1f}s)",
                  flush=True)
    finally:
        sharding.set_rule_overrides({})

    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}__{shape_name}__{mesh_kind}__{weights}"
    if exec_mode != "dense":
        fname += f"__{exec_mode}"
    if tag:
        fname += f"__{tag}"
    with open(os.path.join(out_dir, fname + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def repair_json(out_dir: str = RESULTS_DIR):
    """Recompute the ANALYTIC fields (model_flops, ideal bounds, roofline
    fraction) of existing result JSONs, after fixes to the analytic model,
    without tracing again."""
    import glob
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            continue
        tag_opts = tuple(o for o in rec.get("tag", "").split("-")
                         if o in _OPTS or o.startswith("block"))
        cfg = apply_opts(configs.get(rec["arch"]), tag_opts)
        cell = shapes.SHAPES[rec["shape"]]
        n_dev = rec["n_devices"]
        mflops = model_flops(cfg, cell)
        cache_bytes = _cache_bytes(cfg, cell) if cell.kind != "train" \
            else 0.0
        ideal = ideal_bounds(cfg, cell, n_dev, rec.get("weights", "dense"),
                             cache_bytes)
        rec["model_flops_global"] = mflops
        rec["model_flops_per_device"] = mflops / n_dev
        rec["useful_flop_ratio"] = (mflops / n_dev) / max(rec["flops"], 1)
        rec.update(ideal)
        rec["roofline_fraction"] = ideal["ideal_bound_s"] / rec["bound_s"]
        with open(p, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[repair] {os.path.basename(p)}: "
              f"frac={rec['roofline_fraction']:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repair", action="store_true",
                    help="recompute analytic fields of existing JSONs")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all",
                    choices=["all"] + list(shapes.SHAPE_ORDER))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--weights", default="dense",
                    choices=["dense", "serve_int8", "serve_packed"])
    ap.add_argument("--exec-mode", default="dense",
                    choices=["dense", "fake_quant", "serve_int8",
                             "serve_packed"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--serve-2d-tp", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: " + ",".join(_OPTS) + ",block<N>")
    ap.add_argument("--profile", action="store_true",
                    help="attach per-op memory/collective attribution")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    if args.repair:
        repair_json(args.out_dir)
        return

    archs = list(configs.LM_ARCHS) if args.arch == "all" else [args.arch]
    shape_names = list(shapes.SHAPE_ORDER) if args.shape == "all" \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures, t_all = [], time.perf_counter()
    for mk in meshes:
        for arch in archs:
            for shp in shape_names:
                try:
                    run_cell(arch, shp, mk, args.weights, args.exec_mode,
                             args.tag, args.serve_2d_tp, args.out_dir,
                             opts=tuple(o for o in args.opt.split(",") if o),
                             profile_ops=args.profile)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shp, mk, repr(e)))
                    print(f"[dryrun] {arch} x {shp} x {mk}: FAIL {e!r}",
                          flush=True)
                    traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for f in failures:
            print("   ", f)
        raise SystemExit(1)
    print(f"[dryrun] all requested cells traced in "
          f"{time.perf_counter() - t_all:.1f} s.")


if __name__ == "__main__":
    main()

