"""The train CLI (``python -m repro_torch.launch.train``) on a mesh of
every rank, on the CPU over gloo: a world of one in this process, two
ranks spawned together (``tests/_train_cli_ranks.py``'s CLI checks, one
world for all of them), and two ranks started by ``torchrun``. qwen3-1.7b
smoke, batch 4 x 32 tokens.

* A world of one trains as ``make_train_step`` does: losses
  ``torch.equal``.
* Two ranks train on a (2, 1) mesh, each drawing only its rows: rank 0
  prints, rank 1 prints nothing; every loss within ``LOSS_RTOL`` (the
  chip check's ``DIST_LOSS_RTOL``) of the world of one's, the first
  within ``_train_parity.LOSS_RTOL`` of the reference's train step on
  the same params and batch (un-jitted).
* A checkpoint saved by two ranks resumes on one, and one saved by one
  resumes on two, each at step 3 to step 6 with losses within
  ``LOSS_RTOL`` of the uninterrupted world of one's.
* A batch that does not split into two data ranks x ``--accum`` raises
  ``ValueError`` on both ranks, within ``BAD_BATCH_S``.
* A SIGTERM to one rank stops both at the same step, with one
  checkpoint.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _dist_ranks as R
import _train_cli_ranks as C

_ROOT = Path(__file__).resolve().parents[1]
# The 2-rank losses against the world of one's: the chip check's limit
# (chip_smoke.DIST_LOSS_RTOL; measured here at most 2e-4).
LOSS_RTOL = 1.5e-3
BAD_BATCH_S = 30.0
CHECKS = ("cli", "save_two", "resume_on_two", "bad_batch", "sigterm")


def _main(argv: list) -> dict:
    from repro_torch.launch import train
    return train.main(C.ARGS + argv)


def _close(got: dict, want: dict) -> float:
    """The largest relative difference of ``got``'s losses from
    ``want``'s at ``got``'s steps."""
    return max(abs(v - want[s]) / abs(want[s]) for s, v in got.items())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-one runs (uninterrupted to step 6; 3 steps saved at
    step 3 into ``one/``), then the 2-rank world's checks, then the
    world-one resume of the 2-rank checkpoint."""
    out = str(tmp_path_factory.mktemp("cli2x1"))
    got = {"one": _main(["--steps", "6"])}
    got["save_one"] = _main(["--steps", "3", "--ckpt-dir",
                             os.path.join(out, "one"), "--ckpt-every", "3"])
    results, _ = R.collect(R.start((2, 1), CHECKS, out, "_train_cli_ranks"))
    got["results"] = results
    got["ranks"] = {}
    for check in CHECKS:
        got["ranks"][check] = []
        for r in range(2):
            path = os.path.join(out, f"{check}_rank{r}.json")
            got["ranks"][check].append(json.load(open(path))
                                       if os.path.exists(path) else None)
    got["resume_on_one"] = _main(["--steps", "6", "--ckpt-dir",
                                  os.path.join(out, "two"),
                                  "--ckpt-every", "3"])
    return got


def _ranks(runs, check: str) -> list:
    res = runs["results"][check]
    assert res == ["ok", "ok"], "\n".join(r for r in res if r != "ok")
    return runs["ranks"][check]


def _losses(rank_out: dict) -> dict:
    return {int(s): v for s, v in rank_out["losses"]}


def test_world_of_one_equals_make_train_step(runs):
    from repro_torch import configs
    from repro_torch.api.plan import build_plan
    from repro_torch.core.policy import uniform_policy
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train as T
    from repro_torch.optim import Schedule
    cfg = configs.get("qwen3-1.7b", smoke=True)
    tc = T.TrainConfig(sched=Schedule(total_steps=6, warmup_steps=5))
    step = T.make_train_step(cfg, build_plan(cfg, uniform_policy(8, 8),
                                             mode="dense"), tc)
    state, _ = T.make_train_state(cfg, tc, device="cpu")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    want = []
    for i in range(6):
        state, m = step(state, synthetic_batch(dcfg, i))
        want.append(float(m["loss"]))
    got = runs["one"]
    assert sorted(got) == list(range(6))
    assert torch.equal(torch.tensor([got[i] for i in range(6)]),
                       torch.tensor(want))
    assert runs["save_one"] == {i: got[i] for i in range(3)}


def test_two_ranks_print_once_and_match_world_one(runs):
    r0, r1 = _ranks(runs, "cli")
    assert r0["losses"] == r1["losses"]            # the global loss
    got = _losses(r0)
    assert sorted(got) == [0, 1, 2]
    err = _close(got, runs["one"])
    print(f"2 ranks against a world of one: relative {err:.3g}")
    assert err <= LOSS_RTOL, (got, runs["one"])
    assert "step     0 loss" in r0["printed"]
    assert "done: step 3, restarts 0, skipped spikes 0, 2 rank(s)" in \
        r0["printed"]
    assert r1["printed"] == ""


def test_two_ranks_first_loss_matches_the_reference(runs):
    """The reference's train step (un-jitted) on the CLI's seed-0 params,
    carried across, and the data pipeline's step-0 batch."""
    import jax
    import jax.numpy as jnp
    from _train_parity import LOSS_RTOL as REF_RTOL
    from repro.api import plan as jplan
    from repro.configs import get as jget
    from repro.core.policy import uniform_policy as juniform
    from repro.data import DataConfig as JDataConfig
    from repro.data import synthetic_batch as jbatch
    from repro.launch import train as jtrain
    from repro.optim import Schedule as JSchedule, adamw_init
    from repro_torch import configs, interop
    from repro_torch.launch import train as T
    cfg, jcfg = (configs.get("qwen3-1.7b", smoke=True),
                 jget("qwen3-1.7b", smoke=True))
    tc = T.TrainConfig()
    params = T.make_train_state(cfg, tc, device="cpu")[0]["params"]
    jparams = interop.tree_map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.dtype(interop.dtype_name(t.dtype))), params)
    jtc = jtrain.TrainConfig(sched=JSchedule(total_steps=3, warmup_steps=5))
    batch = {k: jnp.asarray(v) for k, v in jbatch(JDataConfig(
        vocab=jcfg.vocab, seq_len=32, global_batch=4), 0).items()}
    with jax.disable_jit():
        _, m = jtrain.make_train_step(
            jcfg, jplan.build_plan(jcfg, juniform(8, 8), mode="dense"), jtc)(
                {"params": jparams, "opt": adamw_init(jparams, jtc.opt)},
                batch)
    want = float(m["loss"])
    got = _losses(_ranks(runs, "cli")[0])[0]
    print(f"first loss {got!r}, the reference's {want!r}")
    np.testing.assert_allclose(got, want, rtol=REF_RTOL)


@pytest.mark.parametrize("case", ["two_to_one", "one_to_two"])
def test_elastic_resume(runs, case):
    if case == "two_to_one":
        saved = _losses(_ranks(runs, "save_two")[0])
        resumed = runs["resume_on_one"]
    else:
        saved = runs["save_one"]
        r0, r1 = _ranks(runs, "resume_on_two")
        assert r0["losses"] == r1["losses"]
        assert "resumed at step 3" in r0["printed"] and r1["printed"] == ""
        resumed = _losses(r0)
    assert sorted(saved) == [0, 1, 2] and sorted(resumed) == [3, 4, 5]
    err = _close(resumed, runs["one"])
    print(f"{case}: resumed against uninterrupted, relative {err:.3g}")
    assert err <= LOSS_RTOL, (resumed, runs["one"])


@pytest.mark.parametrize("case", sorted(C.BAD_BATCHES))
def test_bad_batch_raises_on_every_rank(runs, case):
    for rank_out in _ranks(runs, "bad_batch"):
        msg, seconds = rank_out[case]
        assert msg.startswith("ValueError") and "equal microbatches" in msg
        assert seconds < BAD_BATCH_S


def test_sigterm_to_one_rank_stops_both_at_one_step(runs):
    r0, r1 = _ranks(runs, "sigterm")
    assert r0["losses"] == r1["losses"]
    assert sorted(_losses(r0)) == [0, 1]           # stopped after step 1
    assert r0["saved"] == ["step_00000002"]         # one checkpoint
    assert "done: step 2" in r0["printed"]


def test_cli_under_torchrun():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train``: a
    (2, 1) mesh, rank 0's lines once."""
    env = dict(PYTHONPATH=str(_ROOT / "src"), PATH=os.environ["PATH"],
               OMP_NUM_THREADS="1", HOME=os.environ.get("HOME", "/tmp"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"]
        + C.ARGS + ["--steps", "3"], env=env, cwd=_ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("step     0 loss") for ln in lines) == 1
    assert [ln for ln in lines if ln.startswith("done:")] == [
        "done: step 3, restarts 0, skipped spikes 0, 2 rank(s)"]


def test_cli_restores_the_sigterm_handler():
    """The CLI's SIGTERM handler lives for its run only."""
    old = signal.getsignal(signal.SIGTERM)
    _main(["--steps", "1"])
    assert signal.getsignal(signal.SIGTERM) is old
