"""Static per-filter-group weight precision (the paper's Sec 4.6 lever).

PyTorch-port counterpart of ``repro/core/weightgroups.py``. A group is
``group_size`` consecutive output columns of the 2-D [K, N] weight
matrix; its count is the OR-tree effective plane count, clamped to
[1, bits]. Executing a group's first ``count`` planes with the
(count-1)-th negated equals 2's-complement truncation at that width.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quantize as q


def weight_group_counts(wq: torch.Tensor, bits: int,
                        group_size: int) -> torch.Tensor:
    """Effective weight plane count per group of output columns.

    wq: int [K, N]. Returns int32 [ceil(N/group_size)].
    """
    k, n = wq.shape
    pad = (-n) % group_size
    if pad:
        wq = F.pad(wq, (0, pad))  # zeros never raise the OR
    g = wq.reshape(k, (n + pad) // group_size, group_size)
    eff = q.effective_bits(g, axis=(0, 2))
    return torch.clamp(eff, max=bits).to(torch.int32)


def truncate_signed(v: torch.Tensor, counts) -> torch.Tensor:
    """2's-complement truncation of ``v`` at per-element width ``counts``:
    keep the low ``counts`` bits, reinterpret signed at that width."""
    low = v & ((1 << counts) - 1)
    return low - (((low >> (counts - 1)) & 1) << counts)


def truncate_columns_grouped(wq: torch.Tensor, counts,
                             group_size: int) -> torch.Tensor:
    """Truncate each column group of ``wq`` [K, N] at its effective width
    (a ragged last group covers only its real columns)."""
    n = wq.shape[-1]
    c = torch.as_tensor(counts, dtype=torch.int32, device=wq.device)
    ccol = torch.repeat_interleave(c, group_size)[:n]
    return truncate_signed(wq, ccol[None, :])


def group_plane_weights(counts, bits: int) -> torch.Tensor:
    """Per-group shift/negate metadata: the signed weight of each plane.

    Returns int32 [n_groups, bits]: plane p of group g contributes
    ``out[g, p] * plane_p`` -- +2^p below the group's MSB, -2^(count-1) at
    it (the SIP negation block moved to the effective width), 0 for the
    skipped planes: the per-group metadata a SIP-style accelerator ships
    next to the packed planes. ``counts``: a list, numpy array or tensor
    (the result lies on a tensor's device).
    """
    c = torch.as_tensor(counts, dtype=torch.int32).reshape(-1, 1)
    p = torch.arange(bits, dtype=torch.int32, device=c.device).reshape(1, -1)
    w = torch.where(p == c - 1, -(1 << p), 1 << p)
    return torch.where(p < c, w, 0).to(torch.int32)


def _ints(counts) -> list:
    if isinstance(counts, torch.Tensor):
        counts = counts.reshape(-1).tolist()
    return [c.item() if hasattr(c, "item") else c for c in counts]


def grouped_packed_nbytes(shape_kn: tuple[int, int], counts,
                          group_size: int) -> int:
    """Bytes of the per-group packed store: each group keeps only its
    ``count`` planes. Ragged tail groups are charged only their real
    columns; K%8 zero-padding is charged as in ``bitpack.packed_nbytes``."""
    k, n = shape_kn
    k8rows = -(-k // 8)
    total = 0
    for g, c in enumerate(_ints(counts)):
        cols = min(group_size, n - g * group_size)
        total += int(c) * k8rows * cols
    return total


def mean_group_bits(counts) -> float:
    """Mean effective weight precision over the groups -- the quantity the
    cycle model's weight-serial pass count scales with."""
    vals = [float(c) for c in _ints(counts)]
    return sum(vals) / len(vals)
