"""Rank-side checks of the train CLI and of the rank's batch rows, run on
the CPU over gloo through ``_dist_ranks.start(..., module=
"_train_cli_ranks")``. Imports no JAX.

The CLI checks call ``repro_torch.launch.train.main`` in the rank, which
joins the rank's initialized group and trains on its own (world, 1)
mesh; each writes ``<check>_rank<r>.json`` into the world's directory
(``ARGS``' qwen3-1.7b smoke run unless named):

* ``cli``: 3 steps; the losses and what the rank printed.
* ``save_two``: 3 steps checkpointed at step 3 into ``two/``.
* ``resume_on_two``: resumes the world-one checkpoint the parent saved
  into ``one/`` (at step 3) and trains to step 6; the losses.
* ``bad_batch``: ``--batch 3`` and ``--batch 4 --accum 4``, which do not
  split over two data ranks x ``accum``; the error each raised and its
  seconds.
* ``sigterm``: 20 steps checkpointed only on a stop, into ``term/``; rank
  1 sends itself a SIGTERM while it draws step 1's batch. The losses and
  (rank 0) the checkpoint directory's entries.

The rows checks hold ``jit_train_step`` fed this rank's rows
(``launch.train.batch_rows``) to the same step fed the global batch's
rows as the step cut them before it took the rank's rows (each
microbatch's "dp" slice by ``shard_leaf``, concatenated): the rows, every
step's loss and grad norm ``torch.equal``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import time

import torch
import torch.distributed as dist

ARGS = ["--device", "cpu", "--arch", "qwen3-1.7b", "--batch", "4", "--seq",
        "32"]
BAD_BATCHES = {"batch3": ["--batch", "3"],
               "accum4": ["--batch", "4", "--accum", "4"]}


def _write(out_dir: str, name: str, got: dict) -> None:
    with open(os.path.join(out_dir, f"{name}_rank{dist.get_rank()}.json"),
              "w") as f:
        json.dump(got, f)


def _main(argv: list) -> tuple:
    """(``{step: loss}`` as [[step, loss], ...], what this rank printed)
    of the CLI."""
    from repro_torch.launch import train
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train.main(argv)
    return sorted(losses.items()), out.getvalue()


def check_cli(mesh, out_dir):
    losses, printed = _main(ARGS + ["--steps", "3"])
    _write(out_dir, "cli", {"losses": losses, "printed": printed})


def check_save_two(mesh, out_dir):
    losses, _ = _main(ARGS + ["--steps", "3", "--ckpt-dir",
                              os.path.join(out_dir, "two"),
                              "--ckpt-every", "3"])
    _write(out_dir, "save_two", {"losses": losses})


def check_resume_on_two(mesh, out_dir):
    losses, printed = _main(ARGS + ["--steps", "6", "--ckpt-dir",
                                    os.path.join(out_dir, "one"),
                                    "--ckpt-every", "3"])
    _write(out_dir, "resume_on_two", {"losses": losses, "printed": printed})


def check_bad_batch(mesh, out_dir):
    got = {}
    for case, extra in BAD_BATCHES.items():
        t0 = time.perf_counter()
        try:
            _main(ARGS + ["--steps", "1"] + extra)
            got[case] = ["no error", time.perf_counter() - t0]
        except ValueError as exc:
            got[case] = [f"ValueError: {exc}", time.perf_counter() - t0]
    _write(out_dir, "bad_batch", got)


def check_sigterm(mesh, out_dir):
    import repro_torch.data as data
    real = data.synthetic_batch

    def draw(cfg, step, rows=None):
        if step == 1 and dist.get_rank() == 1:
            os.kill(os.getpid(), signal.SIGTERM)      # a preemption notice
        return real(cfg, step, rows)
    d = os.path.join(out_dir, "term")
    data.synthetic_batch = draw
    try:
        losses, printed = _main(ARGS + ["--steps", "20", "--ckpt-dir", d,
                                        "--ckpt-every", "100"])
    finally:
        data.synthetic_batch = real
    _write(out_dir, "sigterm", {"losses": losses, "printed": printed,
                                "saved": sorted(os.listdir(d))})


def _global_form(batch: dict, tc, shard, bspecs) -> dict:
    """The rows of a global batch that the meshed step cut for itself
    before it took only the rank's: each microbatch's "dp" slice by the
    batch's specs, concatenated."""
    from repro_torch.dist import sharding
    from repro_torch.launch.train import batch_on
    batch = batch_on(batch, "cpu")
    n = len(batch["tokens"]) // tc.accum
    return {k: torch.cat([
        sharding.shard_leaf(v[i * n:(i + 1) * n], shard.place(bspecs[k]),
                            shard.mesh) for i in range(tc.accum)])
        for k, v in batch.items()}


def _rows(mesh, accum: int) -> None:
    from repro_torch import configs
    from repro_torch.api.plan import build_plan
    from repro_torch.core.policy import uniform_policy
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train as T
    from repro_torch.optim import Schedule
    cfg = configs.get("qwen3-1.7b", smoke=True)
    tc = T.TrainConfig(accum=accum,
                       sched=Schedule(warmup_steps=1, total_steps=10))
    plan = build_plan(cfg, uniform_policy(8, 8), "dense")
    bspecs = T.batch_specs(cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)
    state, specs = T.make_train_state(cfg, tc, device="cpu", mesh=mesh)
    step = T.jit_train_step(cfg, plan, tc, mesh, specs, bspecs)
    rows = T.batch_rows(dcfg.global_batch, tc, step.shard)
    assert len(rows) == dcfg.global_batch // step.shard.size("dp")
    mine, cut = state, state
    for i in range(2):
        local = T.batch_on(synthetic_batch(dcfg, i, rows), "cpu")
        whole = _global_form(synthetic_batch(dcfg, i), tc, step.shard,
                             bspecs)
        assert all(torch.equal(local[k], whole[k]) for k in whole)
        mine, got = step(mine, local)
        cut, want = step(cut, whole)
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[k], want[k]), (i, k, got[k], want[k])


def check_rows_accum1(mesh, out_dir):
    _rows(mesh, 1)


def check_rows_accum2(mesh, out_dir):
    _rows(mesh, 2)


CHECKS = {f.__name__[len("check_"):]: f for f in (
    check_cli, check_save_two, check_resume_on_two, check_bad_batch,
    check_sigterm, check_rows_accum1, check_rows_accum2)}
