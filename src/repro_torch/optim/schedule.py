"""LR schedules: linear warmup, then cosine or linear decay, as functions of
the step counter (a tensor; no Python-side state, so a resumed run picks
up where it stopped). PyTorch-port counterpart of
``repro/optim/schedule.py``, in float32 as the reference computes it."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Schedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_ratio: float = 0.1
    kind: str = "cosine"             # "cosine" | "linear" | "constant"


def make_schedule(cfg: Schedule):
    """``lr(step)``: the float32 0-d learning rate at an integer step
    tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = cfg.peak_lr * torch.clamp(
            (s + 1.0) / max(1, cfg.warmup_steps), max=1.0)
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        if cfg.kind == "cosine":
            decay = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (
                1.0 + torch.cos(math.pi * frac))
        elif cfg.kind == "linear":
            decay = cfg.min_ratio + (1 - cfg.min_ratio) * (1.0 - frac)
        else:
            decay = torch.ones_like(s)
        return torch.where(s < cfg.warmup_steps, warm, cfg.peak_lr * decay)
    return lr
