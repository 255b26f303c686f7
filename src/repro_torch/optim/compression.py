"""Gradient compression: error-feedback int-k quantization of gradient
leaves (Seide et al.'s 1-bit SGD generalised to k bits), the paper's
precision lever applied to the gradient reduction.

PyTorch-port counterpart of ``repro/optim/compression.py``: each leaf
plus its carried residual is quantized to k bits under one absmax scale
and dequantized; the quantization error is carried (bf16) to the next
step, so the compression's bias vanishes to first order. The reference's
``compressed_psum`` (the collective over a pod axis) comes with ROADMAP
A.13b (training on a mesh).
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


def _quant_dequant(g32: torch.Tensor, bits: int) -> torch.Tensor:
    qmax = (1 << (bits - 1)) - 1
    scale = true_div(torch.clamp(torch.amax(g32.abs()), min=1e-30), qmax)
    return torch.clamp(torch.round(g32 / scale), -qmax - 1, qmax) * scale


def compressed_gradient(grads: dict, err_state: dict,
                        cfg: CompressionConfig) -> tuple:
    """Each leaf plus its residual, quantized and dequantized at
    ``cfg.bits``; returns (grads in their dtypes, new residuals). The
    identity when compression is off."""
    if not cfg.enabled:
        return grads, err_state

    def one(g, e):
        g32 = g.to(torch.float32) + e.to(torch.float32)
        gq = _quant_dequant(g32, cfg.bits)
        new_e = (g32 - gq).to(e.dtype) if cfg.error_feedback else e
        return gq.to(g.dtype), new_e

    out = interop.tree_map(one, grads, err_state)
    return (interop.tree_map(lambda t: t[0], out),
            interop.tree_map(lambda t: t[1], out))
