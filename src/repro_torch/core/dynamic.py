"""Dynamic precision reduction: runtime activation plane counts per group.

PyTorch-port counterpart of ``repro/core/dynamic.py``. Per group of
concurrently processed activations an OR-tree and a leading-one detector
find the minimum sufficient signed precision; only that many activation
bit planes then execute for the group. The activations are quantized on
the static path's grid, so the trimming is value-preserving.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quantize as q


def group_effective_bits(xq: torch.Tensor, group_size: int) -> torch.Tensor:
    """Effective signed precision per group along the last axis.

    xq: int [..., K]. Returns int32 [..., ceil(K/group_size)]. A ragged
    trailing group is zero-padded; zeros never raise the OR, so it reports
    its real elements' precision (an all-zero group: the 1-bit floor).
    """
    k = xq.shape[-1]
    pad = (-k) % group_size
    if pad:
        xq = F.pad(xq, (0, pad))
    g = xq.reshape(*xq.shape[:-1], (k + pad) // group_size, group_size)
    return q.effective_bits(g, axis=-1)


def serve_group_counts(xq: torch.Tensor, group_size: int,
                       max_bits: int) -> torch.Tensor:
    """Activation plane counts of the dynamic serving linear.

    xq: int [M, K], M already a multiple of ``group_size``; a group is
    ``group_size`` consecutive rows. Returns int32 [M / group_size], each
    clamped to ``max_bits`` (the detector reports Pa + 1 for qmin, which
    the static planes already cover).
    """
    m, k = xq.shape
    if m % group_size:
        raise ValueError(f"M={m} is not a multiple of the group {group_size}")
    eff = group_effective_bits(xq.reshape(m // group_size, group_size * k),
                               group_size * k)
    return torch.clamp(eff.reshape(-1), max=max_bits).to(torch.int32)


def conv_window_group_counts(xq: torch.Tensor, kernel: int, stride: int,
                             group_size: int, max_bits: int) -> torch.Tensor:
    """Activation plane counts of the dynamic serving conv.

    A group is ``group_size`` consecutive output windows of one image in
    row-major (Ho, Wo) order; its OR-tree covers every value its windows
    read: the max |value| over each k*k*C window ("same" geometry, zero
    padding), then the max over the group's windows.

    xq: int [B, H, W, C]. Returns int32 [B, ceil(Ho*Wo/group_size)], on
    xq's device, each clamped to ``max_bits``. A ragged trailing group
    covers only its real windows; an all-zero group reports the 1-bit floor.
    """
    b = xq.shape[0]
    # Max over channels, then over the k x k window. max_pool2d takes
    # floats only; |values| <= 2^15 are exact in float32, and its implicit
    # -inf padding never wins against a window's real (>= 0) values.
    mag = torch.amax(xq.to(torch.int32).abs(), dim=3).to(torch.float32)[:, None]
    win = F.max_pool2d(mag, kernel, stride, padding=kernel // 2)
    flat = win.reshape(b, -1).to(torch.int32)        # [B, Ho*Wo]
    eff = group_effective_bits(flat, group_size)
    return torch.clamp(eff, max=max_bits).to(torch.int32)


def f32_mean(v: torch.Tensor) -> torch.Tensor:
    """The float32 mean of integer counts as the reference's ``jnp.mean``
    takes it: the exact sum times the float32 reciprocal of the count
    (XLA's rewrite of the division), on every device."""
    total = torch.sum(v.to(torch.int64)).to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=v.device)
    return total * q.true_div(one, float(v.numel()))


def dynamic_stats(xq: torch.Tensor, static_bits: int,
                  group_size: int) -> dict:
    """The savings dynamic precision reduction achieves against the static
    profile -- the quantity that drives Loom's runtime speedup. The means
    are float32 0-d tensors on ``xq``'s device."""
    eff = torch.clamp(group_effective_bits(xq, group_size), max=static_bits)
    mean = f32_mean(eff)
    return {
        "mean_effective_bits": mean,
        "static_bits": static_bits,
        "plane_fraction_executed": q.true_div(mean, static_bits),
    }


def trim_to_group_bits(xq: torch.Tensor, group_size: int,
                       max_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp each group to its effective precision (identity on values --
    every value fits in its group's effective bits) and return (xq,
    per-group plane counts) for the serial engine."""
    eff = torch.clamp(group_effective_bits(xq, group_size), max=max_bits)
    return xq, eff


def expected_speedup(eff_bits: torch.Tensor,
                     static_bits: int) -> torch.Tensor:
    """Cycle-model speedup of dynamic trimming for a serial-activation
    layer: planes executed shrink from static_bits to E[eff]."""
    one = torch.full((), float(static_bits), dtype=torch.float32,
                     device=eff_bits.device)
    return one / f32_mean(eff_bits)
