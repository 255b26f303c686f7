"""Gradient compression: error-feedback int-k quantization of gradient
leaves (Seide et al.'s 1-bit SGD generalised to k bits), the paper's
precision lever applied to the gradient reduction.

PyTorch-port counterpart of ``repro/optim/compression.py``: each leaf
plus its carried residual is quantized to k bits under one absmax scale
and dequantized; the quantization error is carried (bf16) to the next
step, so the compression's bias vanishes to first order. On a mesh each
leaf's scale is the whole leaf's (``reduce_max``).

:func:`compressed_psum` is the reference's int-k all-reduce: each rank's
leaf quantized to int8 under its own absmax scale, the payloads and the
float32 scales all-gathered over a process group, dequantized and summed
in the reference's order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import interop
from repro_torch.core.quantize import true_div


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    enabled: bool = False
    error_feedback: bool = True


def compress_state_init(params: dict) -> dict:
    """Residual (error-feedback) buffers, one bf16 zeros per leaf."""
    return interop.tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.bfloat16, device=p.device), params)


def _scale(x32: torch.Tensor, bits: int, reduce_max=None) -> torch.Tensor:
    absmax = torch.amax(x32.abs())
    if reduce_max is not None:
        absmax = reduce_max(absmax.reshape(1)).reshape(())
    return true_div(torch.clamp(absmax, min=1e-30), (1 << (bits - 1)) - 1)


def _quant(x32: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    return torch.clamp(torch.round(x32 / scale), -qmax - 1, qmax)


def _quant_dequant(g32: torch.Tensor, bits: int,
                   reduce_max=None) -> torch.Tensor:
    scale = _scale(g32, bits, reduce_max)
    return _quant(g32, scale, bits) * scale


def compressed_gradient(grads: dict, err_state: dict,
                        cfg: CompressionConfig, reduce_max=None) -> tuple:
    """Each leaf plus its residual, quantized and dequantized at
    ``cfg.bits``; returns (grads in their dtypes, new residuals). The
    identity when compression is off. ``reduce_max``: a tree like
    ``grads`` of the maps from a shard's absmax to the whole leaf's (None
    where the rank holds the whole leaf), on a mesh."""
    if not cfg.enabled:
        return grads, err_state
    if reduce_max is None:
        reduce_max = interop.tree_map(lambda _: None, grads)

    def one(g, e, red):
        g32 = g.to(torch.float32) + e.to(torch.float32)
        gq = _quant_dequant(g32, cfg.bits, red)
        new_e = (g32 - gq).to(e.dtype) if cfg.error_feedback else e
        return gq.to(g.dtype), new_e

    out = interop.tree_map(one, grads, err_state, reduce_max)
    return (interop.tree_map(lambda t: t[0], out),
            interop.tree_map(lambda t: t[1], out))


def compressed_psum(tree, group, bits: int = 8):
    """The SUM over ``group`` (a process group; None: the world) of each
    rank's leaves, moved as ``bits``-bit integers (the reference's
    ``compressed_psum`` under ``shard_map``): each leaf quantized under
    its own absmax scale, the int8 payloads and float32 scales
    all-gathered (:class:`~repro_torch.dist.parallel.Comm`), dequantized
    and summed over the ranks, cast back to the leaf's dtype. Exact sum
    of the quantized values; the error is at most one quantization step
    per rank."""
    from repro_torch.dist.parallel import Comm
    comm = Comm()
    if group is None:
        import torch.distributed as dist
        group = dist.group.WORLD

    def one(x):
        x32 = x.to(torch.float32)
        scale = _scale(x32, bits)
        q = _quant(x32, scale, bits).to(torch.int8)
        qs = comm.all_gather(q[None], 0, group)              # [P, ...] int8
        ss = comm.all_gather(scale.reshape(1), 0, group)      # [P]
        return torch.sum(qs.to(torch.float32)
                         * ss.reshape((-1,) + (1,) * x.ndim),
                         dim=0).to(x.dtype)

    return interop.tree_map(one, tree)
