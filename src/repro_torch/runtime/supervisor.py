"""Worker-failure type, run state and step-time monitor.

The part of ``repro/runtime/supervisor.py`` that serving needs:
:class:`TransientWorkerError` (a failure a restart should heal, raised by
the fault points and retried by the serving supervisor and the batching
engine), :class:`RunState` and :class:`StepMonitor` (the serving
supervisor's straggler detector). The training ``Supervisor`` comes with
the training slice (ROADMAP A.12).
"""
from __future__ import annotations

import dataclasses


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
