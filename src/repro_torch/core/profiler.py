"""Per-layer precision profiling -- the method of Judd et al. [6].

PyTorch-port counterpart of ``repro/core/profiler.py``. Given a metric
of a model under a precision policy, find for each layer the minimum
activation/weight precision that keeps the metric within a relative
tolerance of the full-precision result: Table-1-style profiles for any
model of the package. The ``measure_*`` functions report the per-group
precisions Loom's OR-trees see in live weights and activations (Sec 4.6
and Lascorz et al.), on any device, as Python numbers.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import dynamic, policy, quantize as q, weightgroups


def profile_layer_precisions(
    eval_fn: Callable[[policy.PrecisionPolicy], float],
    layer_names: Sequence[str],
    *,
    tolerance: float = 0.0,
    min_bits: int = 2,
    max_bits: int = 16,
    what: str = "a_bits",
) -> dict:
    """One-layer-at-a-time descending search (as in Judd et al.): for each
    layer, lower its precision until the metric degrades beyond tolerance
    relative to the 16-bit baseline, holding other layers at 16 bits.

    eval_fn(policy) -> metric (higher is better, e.g. accuracy or -loss);
    it may run on any framework and device. Returns {layer_name:
    min_bits_ok}.
    """
    base = eval_fn(policy.uniform_policy(16, 16))
    floor = base * (1.0 - tolerance) if base >= 0 else base * (1.0 + tolerance)
    result = {}
    for name in layer_names:
        ok = max_bits
        for bits in range(max_bits - 1, min_bits - 1, -1):
            lp = {name: policy.LayerPrecision(
                a_bits=bits if what == "a_bits" else 16,
                w_bits=bits if what == "w_bits" else 16)}
            pol = policy.PrecisionPolicy(default=policy.LayerPrecision(16, 16),
                                         per_layer=lp)
            if eval_fn(pol) >= floor:
                ok = bits
            else:
                break
        result[name] = ok
    return result


def measure_weight_group_precision(w: torch.Tensor, static_bits: int,
                                   group_size: int = 16) -> dict:
    """Per-filter-group effective weight precision of one layer's weights.

    On the layer's static Pw grid (from :func:`profile_layer_precisions`
    with ``what="w_bits"``), the OR-tree minimum sufficient precision of
    each group of ``group_size`` output columns (16 filters in the paper)
    -- the counts pack time freezes into the execution plan. ``w``: float
    [K, N] (k*k*Cin folded into K for convs), on any device.
    """
    wq, _ = q.quantize(w.to(torch.float32), static_bits)
    counts = weightgroups.weight_group_counts(wq, static_bits, group_size)
    mean = float(dynamic.f32_mean(counts))
    return {
        "mean_effective_bits": mean,
        "static_bits": static_bits,
        "plane_fraction_executed": mean / static_bits,
        "group_size": group_size,
        "n_groups": int(counts.shape[0]),
        "per_group_bits": [int(c) for c in counts.tolist()],
    }


def measure_dynamic_precision(x: torch.Tensor, static_bits: int,
                              group_size: int = 256) -> dict:
    """The live per-group effective precision of an activation tensor (what
    Loom's OR-tree + leading-one detector would see at run time), over
    groups of ``group_size`` consecutive values of the flattened tensor."""
    xq, _ = q.quantize(x, static_bits)
    flat = xq.reshape(-1)
    pad = (-flat.shape[0]) % group_size
    if pad:
        flat = F.pad(flat, (0, pad))
    return {k: float(v) for k, v in
            dynamic.dynamic_stats(flat, static_bits, group_size).items()}
