"""End-to-end example: train a ~100M-param qwen3-family model for a few
hundred steps with the port's production stack: the meshed train step
(``jit_train_step`` on a ("data", "model") mesh of the world's ranks),
optional QAT (fake-quant at ``--qat-bits``), checkpoints gathered from
the mesh, the fault-tolerant supervisor and the deterministic, resumable
data pipeline.

Run:  python -m repro_torch.examples.train_lm --small --steps 60 [--device cpu]
      python -m repro_torch.examples.train_lm --steps 300          (~100M)
      torchrun --nproc-per-node 2 -m repro_torch.examples.train_lm \\
          --small --device cpu
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch import interop
from repro_torch.api.plan import build_plan
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core.policy import uniform_policy
from repro_torch.data import DataConfig, synthetic_batch
from repro_torch.dist.sharding import named_tree
from repro_torch.examples import join_world, resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import (TrainConfig, batch_rows,
                                      batch_specs, jit_train_step,
                                      make_train_state, train_state_like)
from repro_torch.models.transformer import LayerSpec, ModelConfig
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.runtime import Supervisor


def model_100m(small: bool = False) -> ModelConfig:
    if small:
        return ModelConfig(
            name="lm-10m", family="dense", n_layers=4, d_model=256,
            vocab=4096, n_heads=4, n_kv_heads=2, d_head=64, d_ff=768,
            qk_norm=True, pattern=(LayerSpec(),), max_seq=512, remat="none")
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        vocab=16384, n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048,
        qk_norm=True, pattern=(LayerSpec(),), max_seq=1024, remat="none")


def main(device="cuda", steps: int = 300, batch: int = 8, seq: int = 256,
         small: bool = False, qat_bits: int = 0, ckpt_dir: str = "") -> dict:
    """Train, and return {"losses", "restarts", "spikes"}; the mean loss
    of the last ten steps must be below the first ten's."""
    device = resolve_device(device)
    rank, world, started = join_world(device)
    try:
        cfg = model_100m(small)
        tc = TrainConfig(opt=AdamWConfig(lr=3e-4),
                         sched=Schedule(peak_lr=3e-4, warmup_steps=20,
                                        total_steps=steps))
        n_params = sum(t.numel() for t in interop.flatten_with_paths(
            train_state_like(cfg, tc)["params"]).values())
        if rank == 0:
            print(f"[train_lm] {cfg.name}: {n_params / 1e6:.1f}M params, "
                  f"{world} rank(s)")
        mode = "fake_quant" if qat_bits else "dense"
        plan = build_plan(cfg, uniform_policy(qat_bits or 16, qat_bits or 16),
                          mode=mode)
        mesh = make_host_mesh(world, device=device)
        state, sspecs = make_train_state(cfg, tc, device=device, mesh=mesh)
        shardings = named_tree(sspecs, mesh)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
        ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                            f"loom_{cfg.name}")
        mgr = CheckpointManager(ckpt_dir, every=100, keep_n=2)
        step_fn = jit_train_step(cfg, plan, tc, mesh, sspecs,
                                 batch_specs(cfg))
        rows = batch_rows(batch, tc, step_fn.shard)     # this rank's
        like = train_state_like(cfg, tc)
        losses = []

        def one_step(st, idx):
            st, metrics = step_fn(st, synthetic_batch(dcfg, idx, rows))
            loss = float(metrics["loss"])
            losses.append(loss)
            if idx % 20 == 0 and rank == 0:
                print(f"  step {idx:4d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            return st, loss

        sup = Supervisor(
            step_fn=one_step,
            save_fn=lambda s, st: mgr.save_async(s, st, shardings=shardings),
            restore_fn=lambda: mgr.restore_latest(like, device=device,
                                                  shardings=shardings),
            save_every=100)
        state, run = sup.train(state, steps)
        mgr.wait()
    finally:
        if started:
            dist.destroy_process_group()
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    if rank == 0:
        print(f"[train_lm] loss {first:.3f} -> {last:.3f} over "
              f"{len(losses)} steps (restarts={run.n_restarts}, spikes "
              f"skipped={run.n_skipped_spikes})")
    assert last < first, "training must reduce the loss"
    if rank == 0:
        print("train_lm done.")
    return {"losses": losses, "restarts": run.n_restarts,
            "spikes": run.n_skipped_spikes}


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--qat-bits", type=int, default=0,
                    help="if set, train with fake-quant at this precision")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    main(device=a.device, steps=a.steps, batch=a.batch, seq=a.seq,
         small=a.small, qat_bits=a.qat_bits, ckpt_dir=a.ckpt_dir)


if __name__ == "__main__":
    cli()
