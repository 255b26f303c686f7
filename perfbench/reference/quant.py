"""Symmetric fixed-point quantization and the integer product, in plain
PyTorch, as the configurations state them: a scale of ``absmax / qmax``
(a true division in float32), values rounded half to even and clipped
to the signed range; the integer product exact (float64, whose 53-bit
mantissa holds every partial sum of these sizes), then scaled back in
float32.
"""
from __future__ import annotations

import torch

TINY = torch.finfo(torch.float32).tiny


def full_float32() -> None:
    """Float32 products and convolutions in full float32 on the card:
    TF32 off for both (cuDNN's default is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def scale_of(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    absmax = torch.clamp(absmax.to(torch.float32), min=TINY)
    return absmax / torch.full_like(absmax, qmax(bits))


def quantize(x: torch.Tensor, bits: int, per_row: bool) -> tuple:
    """(integer values as float32, scale): one scale per row of the last
    dim (``per_row``) or one for the whole tensor."""
    x = x.to(torch.float32)
    if per_row:
        absmax = x.abs().amax(dim=-1, keepdim=True)
    else:
        absmax = x.abs().amax().reshape((1,) * x.ndim)
    s = scale_of(absmax, bits)
    xq = torch.clamp(torch.round(x / s), -qmax(bits) - 1, qmax(bits))
    return xq, s


def quantize_weight(w: torch.Tensor, bits: int) -> tuple:
    """A weight [K, N] under one absmax scale: (values float32, scale
    [1, 1])."""
    return quantize(w.reshape(w.shape[0], -1), bits, per_row=False)


def int_matmul(xq: torch.Tensor, wq: torch.Tensor,
               cols: int = 16384) -> torch.Tensor:
    """The exact integer product of integer-valued float tensors x [M, K]
    and w [K, N], returned as float32 (each sum rounded once, as an int32
    result converts), over blocks of ``cols`` columns."""
    x64 = xq.to(torch.float64)
    out = [(x64 @ wq[:, j:j + cols].to(torch.float64)).to(torch.float32)
           for j in range(0, wq.shape[1], cols)]
    return torch.cat(out, dim=-1)


def loom_linear(x: torch.Tensor, w: torch.Tensor, a_bits: int,
                w_bits: int) -> torch.Tensor:
    """A served linear: x [M, K] quantized per row at ``a_bits``, the
    dense weight [K, N] per tensor at ``w_bits``, the integer product,
    scaled back: float32 [M, N]."""
    xq, xs = quantize(x, a_bits, per_row=True)
    wq, ws = quantize_weight(w, w_bits)
    return int_matmul(xq, wq) * (xs * ws)
