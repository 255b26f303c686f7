"""PyTorch port, the rest of training on the CPU against the JAX package:
AdamW (float32 and bf16 moments), global-norm clipping, the LR schedules,
error-feedback gradient compression, the data pipeline, the training
supervisor (the reference's own tests, mirrored), a reference train
checkpoint resumed by the port and stepped by both packages, and the
train CLI (resume, gradient accumulation).

The optimizer, schedule and compression from the same inputs agree within
1e-6 relative, of the value or of its leaf's max (the same float32
operations in the same order; measured: 1.7e-6 of one moment's value,
4.7e-10 absolute, where its two terms nearly cancel); the data pipeline
bit for bit.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import get as jget
from repro.core.policy import uniform_policy as juniform_policy
from repro.api import plan as jplan
from repro.data import pipeline as jdata
from repro.launch import train as jtrain
from repro_torch import configs, interop, optim
from repro_torch.api import plan as planlib
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.policy import uniform_policy
from repro_torch.data import pipeline as data
from repro_torch.launch import train
from repro_torch.runtime.supervisor import (StepMonitor, Supervisor,
                                            TransientWorkerError)

from _train_parity import GRAD_FRAC, f32, grad_gaps, lm_batch

RTOL = 1e-6
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed: int, dtype=np.float32) -> dict:
    """A small param-like tree: 2-D leaves (decayed), a 1-D and a stacked
    3-D one, from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 16)).astype(dtype),
            "blocks": {"p0": {"g": rng.normal(size=(16,)).astype(dtype),
                              "w": rng.normal(size=(2, 4, 8)).astype(
                                  dtype)}}}


def _close(got, want, rtol=RTOL):
    """Each leaf within ``rtol`` of the value or of the leaf's max: a
    value near a cancellation (a moment's ``m b1 + g (1 - b1)``) carries
    the float32 ulp of its terms."""
    g, w = f32(got), f32(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=rtol,
                                   atol=rtol * float(np.abs(w[k]).max()),
                                   err_msg=k)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(moments):
    """Three AdamW steps from the same params and gradients (each step's
    gradients from numpy), clipped (the first step's norm is above
    grad_clip): params, moments, grad_norm and the step counter."""
    jcfg = joptim.AdamWConfig(moment_dtype=moments, grad_clip=5.0)
    tcfg = optim.AdamWConfig(moment_dtype=moments, grad_clip=5.0)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = interop.params_from_numpy(_tree(0))
    jo, to = joptim.adamw_init(jp, jcfg), optim.adamw_init(tp, tcfg)
    assert to["mu"]["w"].dtype == interop.torch_dtype(moments)
    for step in range(3):
        g = _tree(10 + step)
        g = jax.tree.map(lambda a: a * (3.0 if step == 0 else 0.1), g)
        lr = 3e-4 * (step + 1)
        jp, jo, jm = joptim.adamw_update(
            jp, jax.tree.map(jnp.asarray, g), jo, jcfg,
            jnp.asarray(lr, jnp.float32))
        tp, to, tm = optim.adamw_update(
            tp, interop.params_from_numpy(g), to, tcfg,
            torch.tensor(lr, dtype=torch.float32))
        _close(tp, jp)
        _close({"mu": to["mu"], "nu": to["nu"]},
               {"mu": jo["mu"], "nu": jo["nu"]})
        assert int(to["step"]) == int(jo["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)


def test_global_norm_and_clip_match_jax():
    g = _tree(3)
    jn = joptim.global_norm(jax.tree.map(jnp.asarray, g))
    np.testing.assert_allclose(
        float(optim.global_norm(interop.params_from_numpy(g))), float(jn),
        rtol=RTOL)
    for max_norm in (0.5, 1e6):
        jc, jnorm = joptim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), max_norm)
        tc, tnorm = optim.clip_by_global_norm(interop.params_from_numpy(g),
                                              max_norm)
        _close(tc, jc)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=RTOL)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(kind):
    cfg = dict(peak_lr=3e-4, warmup_steps=5, total_steps=40, kind=kind)
    jlr = joptim.make_schedule(joptim.Schedule(**cfg))
    tlr = optim.make_schedule(optim.Schedule(**cfg))
    for step in range(48):
        want = float(jlr(jnp.asarray(step, jnp.int32)))
        got = tlr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("error_feedback", [True, False])
def test_compressed_gradient_matches_jax(bits, error_feedback):
    """Three steps of error-feedback compression: the dequantized
    gradients and the carried bf16 residuals."""
    jcfg = joptim.CompressionConfig(bits=bits, enabled=True,
                                    error_feedback=error_feedback)
    tcfg = optim.CompressionConfig(bits=bits, enabled=True,
                                   error_feedback=error_feedback)
    je = joptim.compress_state_init(jax.tree.map(jnp.asarray, _tree(0)))
    te = optim.compress_state_init(interop.params_from_numpy(_tree(0)))
    for step in range(3):
        g = _tree(20 + step)
        jg, je = joptim.compressed_gradient(jax.tree.map(jnp.asarray, g),
                                            je, jcfg)
        tg, te = optim.compressed_gradient(interop.params_from_numpy(g),
                                           te, tcfg)
        _close(tg, jg)
        _close(te, je)
    off = optim.CompressionConfig(bits=bits)
    g = interop.params_from_numpy(_tree(1))
    assert optim.compressed_gradient(g, te, off) == (g, te)


def test_data_pipeline_is_the_reference_bit_for_bit():
    for kw in (dict(vocab=256, seq_len=64, global_batch=4),
               dict(vocab=151936, seq_len=512, global_batch=2, seed=3),
               dict(vocab=256, seq_len=32, global_batch=4, mean_doc_len=8)):
        jc, tc = jdata.DataConfig(**kw), data.DataConfig(**kw)
        for step in (0, 7):
            want, got = jdata.synthetic_batch(jc, step), \
                data.synthetic_batch(tc, step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        for host in range(2):
            want = jdata.host_shard_batch(jc, 5, host, 2)
            got = data.host_shard_batch(tc, 5, host, 2)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        jit_, tit = jdata.make_iterator(jc, 3), data.make_iterator(tc, 3)
        for _ in range(2):
            (js, jb), (ts, tb) = next(jit_), next(tit)
            assert js == ts
            np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


def test_data_pipeline_image_embeddings():
    """A VLM batch's image embeddings: float32 [rows, n_img_tokens,
    d_model], a pure function of (seed, step), the same for every row
    subset's draw; the tokens stay the reference's. (The reference's own
    image draw raises on numpy 2: it keys the stream by row -1.)"""
    kw = dict(vocab=256, seq_len=32, global_batch=4, n_img_tokens=8,
              d_model=16)
    tc = data.DataConfig(**kw)
    with pytest.raises(ValueError):
        jdata.synthetic_batch(jdata.DataConfig(**kw), 0)
    got = data.synthetic_batch(tc, 2)
    assert got["img_embeds"].shape == (4, 8, 16)
    assert got["img_embeds"].dtype == np.float32
    np.testing.assert_array_equal(got["img_embeds"],
                                  data.synthetic_batch(tc, 2)["img_embeds"])
    assert not np.array_equal(got["img_embeds"],
                              data.synthetic_batch(tc, 3)["img_embeds"])
    want = jdata.synthetic_batch(jdata.DataConfig(
        vocab=256, seq_len=32, global_batch=4), 2)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# -- the supervisor: the reference's tests (tests/test_substrate.py and
#    tests/test_faults.py), mirrored ---------------------------------------

def test_supervisor_restart_on_worker_failure():
    saved = {}
    fail_once = {"armed": True}

    def step_fn(state, idx):
        if idx == 5 and fail_once["armed"]:
            fail_once["armed"] = False
            raise TransientWorkerError("boom")
        return state + 1, 1.0

    def save_fn(step, state):
        saved["state"], saved["step"] = state, step

    def restore_fn():
        return saved.get("state"), saved.get("step")

    sup = Supervisor(step_fn=step_fn, save_fn=save_fn, restore_fn=restore_fn,
                     save_every=2)
    final, run = sup.train(0, 10)
    assert run.n_restarts == 1
    assert final == 10  # every step applied exactly once


def test_supervisor_spike_guard():
    def step_fn(state, idx):
        loss = 1.0 if idx != 6 else 1e6      # poisoned batch
        return state + 1, loss

    sup = Supervisor(step_fn=step_fn, save_fn=lambda *_: None,
                     restore_fn=lambda: (None, None), spike_factor=10.0)
    _, run = sup.train(0, 10)
    assert run.n_skipped_spikes == 1


def test_step_monitor_flags_stragglers():
    mon = StepMonitor(k_sigma=3.0, warmup=5)
    flagged = [mon.observe(1.0 + 0.01 * (i % 3)) for i in range(20)]
    assert not any(flagged)
    assert mon.observe(10.0)  # a 10x step is a straggler


def test_spike_guard_survives_nonfinite_seed():
    losses = {0: float("nan"), 1: float("inf"), 4: 100.0}
    sup = Supervisor(step_fn=lambda s, i: (s + 1, losses.get(i, 1.0)),
                     save_fn=lambda step, s: None,
                     restore_fn=lambda: (None, None), save_every=1000)
    final, run = sup.train(0, 7)
    assert run.n_skipped_nonfinite == 2   # nan + inf before the EMA seeded
    assert run.n_skipped_spikes == 1      # 100.0 vs EMA ~1.0: still armed
    assert np.isfinite(run.loss_ema)
    assert final == 4                     # 7 steps, 3 dropped updates


def test_sigterm_handoff_checkpoints_and_resumes():
    saved = {}

    def save_fn(step, state):
        saved["step"], saved["state"] = step, state

    def restore_fn():
        return saved.get("state"), saved.get("step")

    def step_fn(state, idx):
        if idx == 4 and "state" not in saved:     # preempt the first run
            os.kill(os.getpid(), signal.SIGTERM)
        return state + 1, 1.0

    old = signal.getsignal(signal.SIGTERM)
    try:
        sup = Supervisor(step_fn=step_fn, save_fn=save_fn,
                         restore_fn=restore_fn, save_every=1000,
                         handle_sigterm=True)
        state, run = sup.train(0, 10)
        assert run.step == 5 and state == 5       # stopped at the boundary
        assert saved["step"] == 5                 # ...with a handoff save
        sup2 = Supervisor(step_fn=step_fn, save_fn=save_fn,
                          restore_fn=restore_fn, save_every=1000)
        final, run2 = sup2.train(0, 10)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert run2.n_restarts == 1                   # resumed, not restarted
    assert final == 10 and run2.step == 10


# -- state across packages ----------------------------------------------------

def test_reference_train_checkpoint_resumed_and_stepped(tmp_path):
    """A qwen3-1.7b smoke train state, stepped once by the reference and
    saved by its ``CheckpointManager``, restored by the port (leaves equal
    to ``train_state_from_numpy`` of the reference's state, bit for bit);
    then one more step in each package from it, on the same batch: the
    loss within 1e-2 relative, the moments within 5% of each leaf's max
    (as the gradients), the params within two learning rates plus one
    bf16 ulp (Adam's first steps move a weight by about the learning rate
    whatever the gradient's size, so a gradient near 0 may take either
    sign). Measured: moments 1.3% of a leaf's max at most."""
    jcfg = jget("qwen3-1.7b", smoke=True)
    cfg = configs.get("qwen3-1.7b", smoke=True)
    sched = dict(warmup_steps=1, total_steps=10)
    jtc = jtrain.TrainConfig(sched=joptim.Schedule(**sched))
    tc = train.TrainConfig(sched=optim.Schedule(**sched))
    jstate, _ = jtrain.make_train_state(jax.random.PRNGKey(0), jcfg, jtc)
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jplan.build_plan(jcfg, juniform_policy(8, 8)), jtc))
    batches = [lm_batch(jcfg, seed) for seed in (0, 1)]
    jstate, _ = jstep(jstate, jax.tree.map(jnp.asarray, batches[0]))
    mgr = JCheckpointManager(str(tmp_path), every=1)
    mgr.save_async(1, jstate)
    mgr.wait()

    like, _ = train.make_train_state(cfg, tc, device="cpu")
    state, step = ckpt.restore_latest(str(tmp_path), like)
    assert step == 1
    carried = interop.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate))
    got, want = (interop.flatten_with_paths(t) for t in (state, carried))
    assert sorted(got) == sorted(want)
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
               for k in want)
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 1

    jnew, jm = jstep(jstate, jax.tree.map(jnp.asarray, batches[1]))
    tnew, tm = train.make_train_step(
        cfg, planlib.build_plan(cfg, uniform_policy(8, 8)), tc)(
            state, batches[1])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-2)
    assert int(tnew["opt"]["step"]) == 2
    for key in ("mu", "nu"):
        gaps = grad_gaps(jnew["opt"][key], tnew["opt"][key])
        assert max(gaps.values()) <= GRAD_FRAC * (2 if key == "nu" else 1)
    lr = float(jm["lr"])
    jp, tp = f32(jnew["params"]), f32(tnew["params"])
    for k in jp:
        bound = 2 * lr + np.abs(jp[k]) * 2.0 ** -8
        assert (np.abs(tp[k] - jp[k]) <= bound).all(), k


def test_train_state_from_numpy_rejects_other_trees():
    with pytest.raises(ValueError, match="not a train state"):
        interop.train_state_from_numpy({"params": {}})


# -- the CLI ----------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "qwen3-1.7b", "--batch", "2", "--seq", "32", *args],
        env=env, capture_output=True, text=True, timeout=300)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    d = str(tmp_path / "run")
    first = _cli("--steps", "3", "--ckpt-dir", d, "--ckpt-every", "2")
    assert first.returncode == 0, first.stderr
    assert "done: step 3" in first.stdout
    assert ckpt.latest_step(d) == 2
    second = _cli("--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2")
    assert second.returncode == 0, second.stderr
    assert "resumed at step 2" in second.stdout
    assert "done: step 4, restarts 1" in second.stdout
    assert ckpt.latest_step(d) == 4


def test_cli_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


@pytest.mark.parametrize("batch,accum", [(5, 2), (2, 4)])
def test_cli_refuses_a_batch_that_does_not_split(batch, accum):
    """``--batch 5 --accum 2`` would drop a row and ``--batch 2 --accum 4``
    would leave every microbatch empty: both raise, as the reference's
    reshape to ``(accum, batch // accum, ...)`` does."""
    old = signal.getsignal(signal.SIGTERM)
    try:
        with pytest.raises(ValueError, match="equal microbatches"):
            train.main(["--device", "cpu", "--steps", "1", "--batch",
                        str(batch), "--seq", "32", "--accum", str(accum)])
    finally:
        signal.signal(signal.SIGTERM, old)


def test_cli_accumulation_equals_one_batch(tmp_path):
    """``--accum 2`` and ``--accum 1`` on the same batch (one step,
    checkpointed): the first moment within 2% of each leaf's max, the
    params within two learning rates plus one bf16 ulp. Measured: 0.8%."""
    old = signal.getsignal(signal.SIGTERM)
    states = {}
    try:
        for accum in (1, 2):
            d = str(tmp_path / f"accum{accum}")
            train.main(["--device", "cpu", "--steps", "1", "--batch", "4",
                        "--seq", "32", "--accum", str(accum), "--ckpt-dir",
                        d, "--ckpt-every", "1"])
            like, _ = train.make_train_state(
                configs.get("qwen3-1.7b", smoke=True), train.TrainConfig(),
                device="cpu")
            states[accum], step = ckpt.restore_latest(d, like)
            assert step == 1
    finally:
        signal.signal(signal.SIGTERM, old)
    one, two = states[1], states[2]
    assert max(grad_gaps(one["opt"]["mu"], two["opt"]["mu"]).values()) <= 0.02
    lr = float(optim.make_schedule(train.TrainConfig(
        sched=optim.Schedule(total_steps=1, warmup_steps=5)).sched)(
            torch.tensor(0)))
    p1, p2 = f32(one["params"]), f32(two["params"])
    for k in p1:
        assert (np.abs(p2[k] - p1[k]) <= 2 * lr + np.abs(p1[k]) * 2.0 ** -8
                ).all(), k
