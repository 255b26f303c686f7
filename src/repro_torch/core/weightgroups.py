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
