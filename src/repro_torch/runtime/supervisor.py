"""Fault-tolerant training supervisor: restart, stragglers, spike guard.

PyTorch-port counterpart of ``repro/runtime/supervisor.py``. The failure
model: (a) a worker dies (hardware, preemption) and the job restarts from
its last checkpoint; (b) a worker is slow (straggler) and the step-time
distribution grows a tail; (c) a bad batch or a loss spike must not
poison the run.

  * Checkpoint/restart: the supervisor calls the caller's ``save_fn`` and
    ``restore_fn`` (``launch/train.py`` hands it the port's
    ``ckpt.CheckpointManager``); a SIGTERM (preemption notice) makes it
    checkpoint at the next step boundary and stop. On a mesh every rank
    must stop at the same boundary (the save gathers the shards
    collectively), so ``agree_stop`` combines each rank's flag there. The
    data pipeline is a pure function of the step, so a resumed run
    redraws the same batches.
  * Straggler detection: :class:`StepMonitor` keeps a running mean and
    variance of step wall time and flags steps beyond ``k_sigma``; the
    ``on_straggler`` hook decides what to do.
  * Loss-spike and non-finite guards: a step whose loss exceeds
    ``spike_factor`` x its EMA, or is not finite, is dropped (the
    previous state is kept).

:class:`TransientWorkerError` (a failure a restart should heal) is also
raised by the fault points and retried by the serving supervisor and the
batching engine, which use :class:`StepMonitor` too.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np


class TransientWorkerError(RuntimeError):
    """Injected/observed worker failure that a restart should heal."""


@dataclasses.dataclass
class RunState:
    step: int = 0
    loss_ema: float = float("nan")
    n_restarts: int = 0
    n_skipped_spikes: int = 0
    n_skipped_nonfinite: int = 0   # non-finite losses before the EMA seeded
    n_straggler_events: int = 0


class StepMonitor:
    """Running mean/variance of step wall time (Welford) with k-sigma
    straggler detection."""

    def __init__(self, k_sigma: float = 4.0, warmup: int = 8):
        self.k = k_sigma
        self.warmup = warmup
        self.n = 0
        self.mean = 0.0
        self.m2 = 0.0

    def observe(self, dt: float) -> bool:
        """Returns True when ``dt`` is a straggler step."""
        self.n += 1
        delta = dt - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (dt - self.mean)
        if self.n <= self.warmup:
            return False
        std = max((self.m2 / (self.n - 1)) ** 0.5, 1e-9)
        return dt > self.mean + self.k * std


class Supervisor:
    """Wraps a step function with restart, straggler and spike handling.

    ``step_fn(state, step_idx) -> (state, loss)``; ``restore_fn() ->
    (state, step)`` or ``(None, None)``; ``save_fn(step, state)``, where
    ``step`` counts the steps applied. The supervisor owns the loop.
    ``agree_stop(stop) -> stop``: called with this process's stop flag at
    every step boundary, returns the flag every rank acts on (a MAX over
    the world on a mesh); the flag as it is when None. The spike and
    non-finite guards need no agreement where every rank sees the global
    loss.
    """

    def __init__(self, *, step_fn: Callable, save_fn: Callable,
                 restore_fn: Callable, save_every: int = 50,
                 max_restarts: int = 3, spike_factor: float = 10.0,
                 on_straggler: Optional[Callable] = None,
                 handle_sigterm: bool = False,
                 agree_stop: Optional[Callable[[bool], bool]] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.spike_factor = spike_factor
        self.on_straggler = on_straggler or (lambda step, dt: None)
        self.agree_stop = agree_stop or (lambda stop: stop)
        self.handle_sigterm = handle_sigterm
        self.monitor = StepMonitor()
        self.run = RunState()
        self._stop = False

    def _sigterm(self, signum, frame):
        # Preemption notice: checkpoint at the next step boundary.
        self._stop = True

    def train(self, init_state, n_steps: int):
        """Run steps up to ``n_steps`` from the restored state (or
        ``init_state`` at step 0). Returns (state, RunState). With
        ``handle_sigterm`` a SIGTERM during the call stops the run at the
        next step boundary with a save; the previous handler is put back
        on return."""
        old = signal.signal(signal.SIGTERM, self._sigterm) \
            if self.handle_sigterm else None
        try:
            return self._train(init_state, n_steps)
        finally:
            if old is not None:
                signal.signal(signal.SIGTERM, old)

    def _train(self, init_state, n_steps: int):
        state, start = self.restore_fn()
        if state is None:
            state, start = init_state, 0
        else:
            self.run.n_restarts += 1
        self.run.step = start
        while True:
            stop = self.agree_stop(self._stop)    # the step boundary
            if stop or self.run.step >= n_steps:
                break
            t0 = time.monotonic()
            prev_state = state
            try:
                state, loss = self.step_fn(state, self.run.step)
            except TransientWorkerError:
                # Reload the last checkpoint and go on: the data pipeline
                # is stateless, so no batch is lost or repeated.
                if self.run.n_restarts >= self.max_restarts:
                    raise
                self.run.n_restarts += 1
                restored, rstep = self.restore_fn()
                if restored is None:
                    restored, rstep = init_state, 0
                state, self.run.step = restored, rstep
                continue
            dt = time.monotonic() - t0
            if self.monitor.observe(dt):
                self.run.n_straggler_events += 1
                self.on_straggler(self.run.step, dt)

            loss = float(loss)
            if not np.isfinite(loss):
                # A non-finite loss never reaches the EMA (seeding it with
                # NaN would disarm the spike guard for good).
                if np.isfinite(self.run.loss_ema):
                    self.run.n_skipped_spikes += 1
                else:
                    self.run.n_skipped_nonfinite += 1
                state = prev_state          # drop the poisoned update
                self.run.step += 1
                continue
            if np.isfinite(self.run.loss_ema) and \
                    loss > self.spike_factor * self.run.loss_ema:
                self.run.n_skipped_spikes += 1
                state = prev_state
                self.run.step += 1
                continue
            self.run.loss_ema = (loss if not np.isfinite(self.run.loss_ema)
                                 else 0.98 * self.run.loss_ema + 0.02 * loss)
            self.run.step += 1
            if self.run.step % self.save_every == 0:
                self.save_fn(self.run.step, state)
        self._stop = stop
        if stop:
            self.save_fn(self.run.step, state)
        return state, self.run
