"""Fault-tolerance demo: kill a training run mid-flight, restart, verify
bit-exact continuation; then rescale the device mesh across a restart
(elastic). Injected failures exercise the Supervisor's restart path.

Every run trains on a ("data", "model") mesh of the world's ranks
(``torch.distributed``'s environment, or one rank): the data axis first,
checkpoints gathered to rank 0; the elastic restore puts a checkpoint
saved from that layout onto the transposed one (every rank on "model").

Run:  python -m repro_torch.examples.fault_tolerance [--device cpu]
      torchrun --nproc-per-node 2 -m repro_torch.examples.fault_tolerance \\
          --device cpu
"""
from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.api.plan import build_plan
from repro_torch.ckpt.checkpoint import (CheckpointManager,
                                        restore_checkpoint, save_checkpoint)
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.dist import sharding
from repro_torch.examples import join_world, resolve_device, run as cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import (TrainConfig, batch_rows,
                                      batch_specs, jit_train_step,
                                      make_train_state, train_state_like)
from repro_torch.models.transformer import LayerSpec, ModelConfig
from repro_torch.optim import Schedule
from repro_torch.runtime import Supervisor, TransientWorkerError


def tiny_model() -> ModelConfig:
    return ModelConfig(name="ft-demo", family="dense", n_layers=2,
                       d_model=64, vocab=512, n_heads=4, n_kv_heads=2,
                       d_head=16, d_ff=128, pattern=(LayerSpec(),),
                       max_seq=128, remat="none")


def run(steps: int, ckpt_dir: str, device, world: int,
        inject_failure_at=None) -> tuple:
    """``steps`` supervised steps on a (world, 1) mesh, checkpointing
    every 10; ``inject_failure_at``: a step whose first attempt raises
    ``TransientWorkerError``. Returns (this rank's state, RunState)."""
    cfg = tiny_model()
    tc = TrainConfig(sched=Schedule(peak_lr=1e-3, warmup_steps=5,
                                    total_steps=steps))
    mesh = make_host_mesh(world, model=1, device=device)
    state, sspecs = make_train_state(cfg, tc, device=device, mesh=mesh)
    shardings = sharding.named_tree(sspecs, mesh)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4)
    mgr = CheckpointManager(ckpt_dir, every=10, keep_n=3)
    step_fn = jit_train_step(cfg, build_plan(cfg, mode="dense"), tc, mesh,
                             sspecs, batch_specs(cfg))
    rows = batch_rows(dcfg.global_batch, tc, step_fn.shard)   # this rank's
    like = train_state_like(cfg, tc)
    fired = {"done": False}

    def one_step(st, idx):
        if inject_failure_at is not None and idx == inject_failure_at \
                and not fired["done"]:
            fired["done"] = True
            raise TransientWorkerError(f"injected node loss at {idx}")
        st, m = step_fn(st, synthetic_batch(dcfg, idx, rows))
        return st, float(m["loss"])

    def save(step, st):
        mgr.save_async(step, st, shardings=shardings)
        mgr.wait()

    sup = Supervisor(step_fn=one_step, save_fn=save,
                     restore_fn=lambda: mgr.restore_latest(
                         like, device=device, shardings=shardings),
                     save_every=10)
    return sup.train(state, steps)


def main(device="cuda") -> dict:
    """The three parts; returns {"restarts", "leaves", "world"}."""
    device = resolve_device(device)
    rank, world, started = join_world(device)
    base = None
    try:
        base = [tempfile.mkdtemp(prefix="loom_ft_") if rank == 0 else None]
        dist.broadcast_object_list(base, src=0)
        base = base[0]
        # --- 1. uninterrupted reference run -------------------------------
        ref_state, _ = run(25, os.path.join(base, "ref"), device, world)

        # --- 2. run with an injected worker failure at step 17 ------------
        ft_state, info = run(25, os.path.join(base, "ft"), device, world,
                             inject_failure_at=17)
        assert info.n_restarts == 1, info
        want = interop.flatten_with_paths(ref_state)
        got = interop.flatten_with_paths(ft_state)
        # same data addressing + restored state => identical trajectory
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        if rank == 0:
            print(f"[ft] restart at step 17 reproduced the uninterrupted "
                  f"trajectory bit-exactly, every leaf of the state "
                  f"(restarts={info.n_restarts})")

        # --- 3. elastic rescale across a restart ---------------------------
        cfg, tc = tiny_model(), TrainConfig()
        data_mesh = make_host_mesh(world, model=1, device=device)
        state, sspecs = make_train_state(cfg, tc, device=device,
                                         mesh=data_mesh)
        save_checkpoint(os.path.join(base, "el"), 5, state,
                        shardings=sharding.named_tree(sspecs, data_mesh))
        # restore onto a DIFFERENT mesh layout (every rank on "model")
        model_mesh = make_host_mesh(world, model=world, device=device)
        restored, step = restore_checkpoint(
            os.path.join(base, "el"), 5, train_state_like(cfg, tc),
            device=device,
            shardings=sharding.named_tree(sspecs, model_mesh))
        whole, _ = make_train_state(cfg, tc, device=device)
        want = interop.flatten_with_paths(
            sharding.shard_tree(whole, sspecs, model_mesh))
        got = interop.flatten_with_paths(restored)
        assert step == 5 and sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        dist.barrier()          # every rank has read the files
        if rank == 0:
            print(f"[ft] elastic restore from a ({world}, 1) mesh onto "
                  f"(1, {world}): OK (step {step}, {len(got)} leaves, each "
                  f"this rank's slice of the saved state)")
            print("fault_tolerance done.")
        return {"restarts": info.n_restarts, "leaves": len(got),
                "world": world}
    finally:
        if rank == 0 and base:
            shutil.rmtree(base, ignore_errors=True)
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    cli(main, __doc__)
