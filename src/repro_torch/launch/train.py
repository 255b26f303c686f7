"""Training launcher of the PyTorch port: the train step and a supervised,
checkpointed loop, on the card unless asked otherwise.

PyTorch-port counterpart of ``repro/launch/train.py``::

    python -m repro_torch.launch.train --arch qwen3-1.7b --steps 100 \\
        --batch 8 --seq 128
    python -m repro_torch.launch.train --device cpu --arch qwen3-1.7b \\
        --steps 3 --batch 2 --seq 32 --ckpt-dir /tmp/run --ckpt-every 2

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
spike guard, SIGTERM checkpoint). With ``--ckpt-dir`` it checkpoints
every ``--ckpt-every`` steps through ``ckpt.CheckpointManager`` and
resumes from the newest checkpoint there. ``--device`` defaults to
``cuda``; without a card it raises unless ``--device cpu`` is given. Not
ported yet: ``jit_train_step`` (the mesh) comes with ROADMAP A.13b.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import configs, interop
from repro_torch.api import plan as planlib
from repro_torch.models import model as M
from repro_torch.optim import (AdamWConfig, CompressionConfig, Schedule,
                               adamw_init, adamw_update, compress_state_init,
                               compressed_gradient, make_schedule)


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


def make_train_state(cfg, tc: TrainConfig,
                     generator: torch.Generator | None = None,
                     device="cuda") -> dict:
    """Random params drawn with ``generator`` (a seed-0 generator on
    ``device`` when None) and zero optimizer state, on ``device``."""
    device = _device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, generator, device)
    state = {"params": params, "opt": adamw_init(params, tc.opt)}
    if tc.compression.enabled:
        state["err"] = compress_state_init(params)
    return state


def batch_on(batch: dict, device) -> dict:
    """A data-pipeline batch (numpy or tensors) on ``device``: token ids
    as int64, ``img_embeds`` in their dtype."""
    out = {k: torch.as_tensor(batch[k], device=device).long()
           for k in ("tokens", "labels")}
    if "img_embeds" in batch:
        out["img_embeds"] = torch.as_tensor(batch["img_embeds"],
                                            device=device)
    return out


def value_and_grad(params: dict, cfg, batch: dict, plan) -> tuple:
    """(loss, {"nll", "aux"}, gradients like params) of one batch, all
    detached; a leaf the loss does not reach gets zeros, as in JAX."""
    leaves = interop.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
    loss, parts = M.loss_fn(leaves, cfg, batch, plan)
    flat = interop.flatten_with_paths(leaves)
    grads = dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()), allow_unused=True,
        materialize_grads=True)))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            interop.map_with_paths(lambda key, _: grads[key], leaves))


def make_train_step(cfg, plan: planlib.ExecutionPlan, tc: TrainConfig):
    """The train step ``(state, batch) -> (new state, metrics)`` of
    ``cfg`` under ``plan`` (``dense`` or ``fake_quant``). ``batch``: the
    data pipeline's dict (numpy or tensors), put on the params' device.
    The input state is left unchanged. Metrics: ``loss``, ``grad_norm``
    and ``lr`` (and, without accumulation, ``nll`` and ``aux``), as 0-d
    tensors. A batch whose rows do not split into ``accum`` equal
    microbatches raises ``ValueError``, as the reference's reshape does."""
    sched_fn = make_schedule(tc.sched)

    def train_step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        device = next(iter(interop.flatten_with_paths(params).values())
                      ).device
        batch = batch_on(batch, device)
        if tc.accum == 1:
            loss, parts, grads = value_and_grad(params, cfg, batch, plan)
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
                l_, _, g = value_and_grad(params, cfg, mb, plan)
                grads = interop.tree_map(
                    lambda a, b: a + b.to(torch.float32), grads, g)
                loss = loss + l_
            grads = interop.tree_map(lambda g: g / tc.accum, grads)
            loss, parts = loss / tc.accum, {}

        new_state = dict(state)
        if tc.compression.enabled:
            grads, new_state["err"] = compressed_gradient(
                grads, state["err"], tc.compression)
        lr = sched_fn(state["opt"]["step"])
        new_state["params"], new_state["opt"], om = adamw_update(
            params, grads, state["opt"], tc.opt, lr)
        return new_state, {"loss": loss, **parts, **om}

    return train_step


def main(argv=None):
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

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.core.policy import uniform_policy
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.runtime.supervisor import Supervisor

    device = _device(args.device)
    cfg = configs.get(args.arch, smoke=True)
    plan = planlib.build_plan(cfg, uniform_policy(args.a_bits, args.w_bits),
                              mode=args.mode)
    tc = TrainConfig(accum=args.accum,
                     sched=Schedule(total_steps=args.steps, warmup_steps=5))
    state = make_train_state(cfg, tc, device=device)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch,
                      n_img_tokens=cfg.n_img_tokens, d_model=cfg.d_model)
    step_fn = make_train_step(cfg, plan, tc)
    mgr = (CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
           if args.ckpt_dir else None)

    def run_step(state, step):
        state, metrics = step_fn(state, synthetic_batch(dcfg, step))
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e}", flush=True)
        return state, metrics["loss"]

    def restore():
        if mgr is None:
            return None, None
        restored, step = mgr.restore_latest(state, device=device)
        if restored is not None:
            print(f"resumed at step {step} from {args.ckpt_dir}", flush=True)
        return restored, step

    def save(step, state):
        if mgr is not None:
            mgr.save_async(step, state)

    sup = Supervisor(step_fn=run_step, save_fn=save, restore_fn=restore,
                     save_every=args.ckpt_every, handle_sigterm=True)
    _, run = sup.train(state, args.steps)
    if mgr:
        mgr.wait()
    print(f"done: step {run.step}, restarts {run.n_restarts}, skipped "
          f"spikes {run.n_skipped_spikes}", flush=True)


if __name__ == "__main__":
    main()
