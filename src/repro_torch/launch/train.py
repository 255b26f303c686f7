"""Training launcher of the PyTorch port: the train step and a supervised,
checkpointed loop, on the card unless asked otherwise.

PyTorch-port counterpart of ``repro/launch/train.py``::

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 100 \\
        --batch 8 --seq 128
    python -m repro_torch.launch.train --device cpu --arch qwen3-1.7b \\
        --steps 3 --batch 2 --seq 32 --ckpt-dir /tmp/run --ckpt-every 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
        --steps 3 --batch 4 --seq 32

:func:`make_train_step` builds the step, a pure ``(state, batch) ->
(state, metrics)`` function: the loss and its gradients by autograd,
gradient accumulation over ``accum`` microbatches (float32 sums), the
optional error-feedback gradient compression, the LR schedule and AdamW.
The state is ``{"params", "opt": {"mu", "nu", "step"}}`` (plus ``"err"``
with compression), the reference's tree, so each package restores the
other's train checkpoints (``interop.train_state_from_numpy`` carries a
state across in memory).

The CLI trains ``configs.get(arch, smoke=True)``, as the reference's
does, from seed-0 weights on the data pipeline's synthetic batches, in
``--mode dense`` or ``fake_quant`` (QAT at ``--a-bits`` / ``--w-bits``),
under the :class:`~repro_torch.runtime.supervisor.Supervisor` (restart,
spike guard, SIGTERM checkpoint). It trains on the data-parallel
``make_host_mesh`` of the world that ``torch.distributed``'s
environment names (``RANK``, ``WORLD_SIZE``, ``MASTER_PORT``, as
``torchrun`` sets them; a group of one without it, or the caller's
initialized group), each rank drawing only its rows of every batch. With
``--ckpt-dir`` it checkpoints every ``--ckpt-every`` steps through
``ckpt.CheckpointManager`` (the shards gathered, rank 0 writing) and
resumes every rank from the newest checkpoint there, whatever world
saved it. Rank 0 prints. ``--device`` defaults to ``cuda``; without a
card it raises unless ``--device cpu`` is given.

On a ("data", "model") mesh (:func:`repro_torch.launch.mesh.make_host_mesh`,
one process per rank) :func:`make_train_state` gives each rank its shards
of the seed's state and :func:`jit_train_step` the rank's SPMD step: the
model's training forward on the rank's batch rows (:func:`batch_rows`)
and shards (``model.loss_fn(..., shard=)``), the gradients of every leaf
that "data" replicates SUM-reduced over "data" ("fsdp" leaves were
reduce-scattered by their gathers' backward), then the unsharded step's
compression, schedule, clip (by the global norm) and AdamW on the local
shards. Every rank returns the global metrics.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist

from repro_torch import configs, interop
from repro_torch.api import plan as planlib
from repro_torch.data import rank_rows
from repro_torch.dist import sharding
from repro_torch.dist.sharding import Spec
from repro_torch.models import model as M
from repro_torch.optim import (AdamWConfig, CompressionConfig, Schedule,
                               adamw_init, adamw_update, compress_state_init,
                               compressed_gradient, make_schedule,
                               opt_state_specs)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    sched: Schedule = Schedule()
    accum: int = 1                    # gradient-accumulation microbatches
    compression: CompressionConfig = CompressionConfig()


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to train on the CPU")
    return device


def train_state_specs(cfg, tc: TrainConfig) -> dict:
    """The train state's spec tree: ``{"params", "opt"}`` (and ``"err"``
    with compression), the reference's ``make_train_state`` specs."""
    specs = M.param_spec_tree(cfg)
    out = {"params": specs, "opt": opt_state_specs(specs)}
    if tc.compression.enabled:
        out["err"] = specs
    return out


def make_train_state(cfg, tc: TrainConfig,
                     generator: torch.Generator | None = None,
                     device="cuda", mesh=None) -> tuple:
    """(state, its spec tree): random params drawn with ``generator`` (a
    seed-0 generator on ``device`` when None) and zero optimizer state, on
    ``device``. On a ``mesh`` each rank draws the whole params from the
    same seed and keeps its shards, so every mesh trains the slices of
    the unsharded state."""
    device = _device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    specs = train_state_specs(cfg, tc)
    params = M.init_params(cfg, generator, device)
    if mesh is not None:
        params = sharding.shard_tree(params, specs["params"], mesh)
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    if tc.compression.enabled:
        state["err"] = compress_state_init(params)
    return state, specs


def train_state_like(cfg, tc: TrainConfig) -> dict:
    """The unsharded train state's keys, shapes and dtypes as meta
    tensors (the ``like`` of a restore), nothing drawn."""
    params = M.param_skeleton(cfg)

    def empty(dtype):
        return lambda p: torch.empty(p.shape, dtype=dtype, device="meta")
    state = {"params": params,
             "opt": {"mu": interop.tree_map(empty(tc.opt._mdt), params),
                     "nu": interop.tree_map(empty(tc.opt._mdt), params),
                     "step": torch.empty((), dtype=torch.int32,
                                         device="meta")}}
    if tc.compression.enabled:
        state["err"] = interop.tree_map(empty(torch.bfloat16), params)
    return state


def batch_specs(cfg) -> dict:
    """The batch's specs: rows over "dp" (the reference's launcher's)."""
    specs = {"tokens": Spec("dp", None), "labels": Spec("dp", None)}
    if cfg.n_img_tokens:
        specs["img_embeds"] = Spec("dp", None, None)
    return specs


def batch_rows(global_batch: int, tc: TrainConfig, shard=None) -> list[int]:
    """The rows of a global batch of ``global_batch`` that this rank's
    train step takes, in the order it takes them: each microbatch's
    "dp" block (``data.rank_rows``; every row without a ``shard``). A
    batch that does not split into "dp" ranks x ``tc.accum`` equal parts
    raises ``ValueError``, as the reference's sharded argument does."""
    if shard is None:
        return rank_rows(global_batch, tc.accum)
    return rank_rows(global_batch, tc.accum, shard.size("dp"),
                     shard.rank("dp"))


def batch_on(batch: dict, device) -> dict:
    """A data-pipeline batch (numpy or tensors) on ``device``: token ids
    as int64, ``img_embeds`` in their dtype."""
    out = {k: torch.as_tensor(batch[k], device=device).long()
           for k in ("tokens", "labels")}
    if "img_embeds" in batch:
        out["img_embeds"] = torch.as_tensor(batch["img_embeds"],
                                            device=device)
    return out


def value_and_grad(params: dict, cfg, batch: dict, plan,
                   shard=None) -> tuple:
    """(loss, {"nll", "aux"}, gradients like params) of one batch, all
    detached; a leaf the loss does not reach gets zeros, as in JAX. On a
    mesh (``shard``) the batch is this rank's rows and the params its
    shards, and the gradients are this rank's before the "data"
    reduction (:func:`mesh_value_and_grad`)."""
    leaves = interop.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
    loss, parts = M.loss_fn(leaves, cfg, batch, plan, shard)
    flat = interop.flatten_with_paths(leaves)
    grads = dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()), allow_unused=True,
        materialize_grads=True)))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            interop.map_with_paths(lambda key, _: grads[key], leaves))


def reduce_data_grads(grads: dict, specs: dict, shard) -> dict:
    """Every gradient leaf SUM-reduced over the rows' ("dp") mesh axes
    that do not split it (one all-reduce per dtype and set of axes over
    the leaves laid end to end); the "fsdp" leaves were reduce-scattered
    by their gathers' backward."""
    if shard.size("dp") == 1:
        return grads
    flat = interop.flatten_with_paths(grads)
    spec_of = interop.flatten_with_paths(specs)
    out = dict(flat)
    by_dtype = {}
    for k, g in flat.items():
        axes = tuple(a for a in shard.axes("dp") if a not in
                     sharding.sharded_axes(spec_of[k], shard.mesh))
        if axes:
            by_dtype.setdefault((g.dtype, axes), []).append(k)
    for (_, axes), keys in by_dtype.items():
        summed = shard.comm.all_reduce(
            torch.cat([flat[k].reshape(-1) for k in keys]), "sum",
            shard.group_over(axes))
        for k, piece in zip(keys, summed.split([flat[k].numel()
                                                for k in keys])):
            out[k] = piece.reshape(flat[k].shape)
    return interop.map_with_paths(lambda key, _: out[key], grads)


def mesh_value_and_grad(params: dict, cfg, batch: dict, plan, shard,
                        specs: dict) -> tuple:
    """:func:`value_and_grad` on a mesh with the gradients reduced over
    "data": (the global loss, its parts, this rank's shards of the
    unsharded gradients); ``specs``: the params'."""
    loss, parts, grads = value_and_grad(params, cfg, batch, plan, shard)
    return loss, parts, reduce_data_grads(grads, specs, shard)


def make_train_step(cfg, plan: planlib.ExecutionPlan, tc: TrainConfig,
                    shard=None, specs: dict | None = None):
    """The train step ``(state, batch) -> (new state, metrics)`` of
    ``cfg`` under ``plan`` (``dense`` or ``fake_quant``). ``batch``: the
    data pipeline's dict (numpy or tensors), put on the params' device.
    The input state is left unchanged. Metrics: ``loss``, ``grad_norm``
    and ``lr`` (and, without accumulation, ``nll`` and ``aux``), as 0-d
    tensors. A batch whose rows do not split into ``accum`` equal
    microbatches raises ``ValueError``, as the reference's reshape does.
    ``shard`` and ``specs`` (the params'): the meshed step
    (:func:`jit_train_step`), whose ``batch`` is this rank's rows
    (:func:`batch_rows`); the step's ``shard`` attribute is the
    ``ShardCtx`` (None unsharded), whose ``comm.calls`` counts the
    collectives."""
    sched_fn = make_schedule(tc.sched)

    def train_step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        device = next(iter(interop.flatten_with_paths(params).values())
                      ).device
        batch = batch_on(batch, device)
        if tc.accum == 1:
            loss, parts, grads = value_and_grad(params, cfg, batch, plan,
                                                shard)
        else:
            if batch["tokens"].shape[0] % tc.accum:
                raise ValueError(
                    f"a batch of {batch['tokens'].shape[0]} rows does not "
                    f"split into {tc.accum} equal microbatches")
            n = batch["tokens"].shape[0] // tc.accum
            grads = interop.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(tc.accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_, _, g = value_and_grad(params, cfg, mb, plan, shard)
                grads = interop.tree_map(
                    lambda a, b: a + b.to(torch.float32), grads, g)
                loss = loss + l_
            grads = interop.tree_map(lambda g: g / tc.accum, grads)
            loss, parts = loss / tc.accum, {}

        new_state = dict(state)
        if shard is not None:
            grads = reduce_data_grads(grads, specs, shard)
        if tc.compression.enabled:
            reduce_max = None if shard is None else sharding.map_specs(
                lambda _, spec: shard.max_over(
                    sharding.sharded_axes(spec, shard.mesh)), grads, specs)
            grads, new_state["err"] = compressed_gradient(
                grads, state["err"], tc.compression, reduce_max)
        lr = sched_fn(state["opt"]["step"])
        new_state["params"], new_state["opt"], om = adamw_update(
            params, grads, state["opt"], tc.opt, lr, shard, specs)
        return new_state, {"loss": loss, **parts, **om}

    train_step.shard = shard          # its Comm counts the collectives
    return train_step


def jit_train_step(cfg, plan: planlib.ExecutionPlan, tc: TrainConfig, mesh,
                   state_specs: dict, batch_specs: dict):
    """This rank's SPMD train step on ``mesh`` (the reference's
    ``jit_train_step``; the port compiles nothing, the name stays).
    ``state`` holds the rank's shards placed by ``state_specs``
    (:func:`make_train_state` with ``mesh=``); ``batch`` holds only the
    rows this rank trains on, its "dp" block of every microbatch in order
    (:func:`batch_rows` with the step's ``shard``: the rows that
    ``batch_specs``, the reference's ``in_shardings`` of the batch, give
    the rank), so every mesh trains on the unsharded step's data.
    Accumulation, compression (each leaf's scale the whole leaf's), the
    schedule, the clip and AdamW run as in :func:`make_train_step`, after
    the "data" reduction; the metrics (``loss``, ``grad_norm``, ``lr``)
    are the global values on every rank. The input state is left
    unchanged (the reference donates it)."""
    from repro_torch.dist.parallel import ShardCtx
    return make_train_step(cfg, plan, tc, ShardCtx(mesh),
                           state_specs["params"])


def main(argv=None) -> dict:
    """The CLI (module docstring); returns ``{step: loss}`` of the steps
    this call ran (the global loss, the same on every rank)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mode", default="dense",
                    choices=["dense", "fake_quant"])
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--w-bits", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.examples import join_world
    device = _device(args.device)
    rank, world, started = join_world(device)
    try:
        return _train_on_world(args, device, rank, world)
    finally:
        if started:
            dist.destroy_process_group()


def _train_on_world(args, device, rank: int, world: int) -> dict:
    """:func:`main` on the joined world's (world, 1) mesh."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.policy import uniform_policy
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.supervisor import Supervisor

    cfg = configs.get(args.arch, smoke=True)
    plan = planlib.build_plan(cfg, uniform_policy(args.a_bits, args.w_bits),
                              mode=args.mode)
    tc = TrainConfig(accum=args.accum,
                     sched=Schedule(total_steps=args.steps, warmup_steps=5))
    # The (world, 1) mesh puts rank r at "data" index r. An uneven batch
    # raises here on every rank alike, before any collective.
    rows = rank_rows(args.batch, args.accum, world, rank)
    mesh = make_host_mesh(world, model=1, device=device)
    state, specs = make_train_state(cfg, tc, device=device, mesh=mesh)
    shardings = sharding.named_tree(specs, mesh)
    like = train_state_like(cfg, tc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch,
                      n_img_tokens=cfg.n_img_tokens, d_model=cfg.d_model)
    step_fn = jit_train_step(cfg, plan, tc, mesh, specs, batch_specs(cfg))
    mgr = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
           if args.ckpt_dir else None)
    losses = {}

    def say(text):
        if rank == 0:
            print(text, flush=True)

    def run_step(state, step):
        state, metrics = step_fn(state, synthetic_batch(dcfg, step, rows))
        losses[step] = float(metrics["loss"])
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:5d} loss {losses[step]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e}")
        return state, metrics["loss"]

    def restore():
        if mgr is None:
            return None, None
        restored, step = mgr.restore_latest(like, device=device,
                                            shardings=shardings)
        if restored is not None:
            say(f"resumed at step {step} from {args.ckpt_dir}")
        return restored, step

    def save(step, state):
        if mgr is not None:
            mgr.save_async(step, state, shardings=shardings)

    def agree_stop(stop: bool) -> bool:
        # A SIGTERM reaches one process: every rank stops where any does.
        if world == 1:
            return stop
        flag = torch.tensor([int(stop)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    sup = Supervisor(step_fn=run_step, save_fn=save, restore_fn=restore,
                     save_every=args.ckpt_every, handle_sigterm=True,
                     agree_stop=agree_stop)
    _, run = sup.train(state, args.steps)
    if mgr:
        mgr.wait()
    say(f"done: step {run.step}, restarts {run.n_restarts}, skipped spikes "
        f"{run.n_skipped_spikes}, {world} rank(s)")
    return losses


if __name__ == "__main__":
    main()
