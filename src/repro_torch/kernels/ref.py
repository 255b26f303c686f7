"""Plain PyTorch oracles for the port's kernels.

PyTorch-port counterpart of ``repro/kernels/ref.py``. Each function is the
specification its Hopper kernel must match bit for bit, and it runs on any
device: the CPU tests use it, and ``chip_smoke.py`` holds the kernels
against it on the card.

The integer core of each oracle is one exact product. On the CPU it runs
in int64. PyTorch has no integer matmul on CUDA, so there it runs in
float64, which is exact too: every product and partial sum is an integer
of magnitude at most K * 2^(Pa-1) * 2^(Pw-1) <= 2048 * 2^7 * 2^15 = 2^33
(Pa <= 8, Pw <= 16 on the serving path), far inside float64's 2^53.
Either way the sum is narrowed to int32 last, with the same wrap-around
as the reference's int32 accumulator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitpack


def _exact_dtype(device: torch.device) -> torch.dtype:
    return torch.float64 if device.type == "cuda" else torch.int64


def _narrow(acc: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.int64).to(torch.int32)


def bitserial_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                         w_bits: int) -> torch.Tensor:
    """int8 [M, K] @ packed uint8 [Pw, K//8, N] -> exact int32 [M, N]."""
    dt = _exact_dtype(x.device)
    wq = bitpack.unpack_weights(w_packed, w_bits)          # int32 [K, N]
    return _narrow(x.to(dt) @ wq.to(dt))


def conv_window_slices(xp: torch.Tensor, kernel: int, stride: int, ho: int,
                       wo: int) -> list:
    """The k*k window-offset strided slices of a PADDED NHWC map, in the
    canonical (di, dj) order: concatenated along channels they give patch
    features in (di, dj, c) order, the pack_weights row order. Returns
    k*k views [B, Ho, Wo, C]."""
    out = []
    for di in range(kernel):
        for dj in range(kernel):
            out.append(xp[:, di:di + (ho - 1) * stride + 1:stride,
                          dj:dj + (wo - 1) * stride + 1:stride, :])
    return out


def bitserial_conv_ref(x: torch.Tensor, w_packed: torch.Tensor, *,
                       kernel: int, stride: int = 1,
                       w_bits: int) -> torch.Tensor:
    """Exact "same"-padded conv (pad = k//2, Ho = ceil(H/stride)).

    x: int [B, H, W, C] (NHWC); w_packed: uint8 [Pw, ceil(k*k*C/8), N].
    Returns int32 [B, Ho, Wo, N]: the k*k window walk, one [C, N] weight
    slab per window offset, summed exactly.
    """
    b, h, w, c = x.shape
    dt = _exact_dtype(x.device)
    wq = bitpack.unpack_weights(w_packed, w_bits, k=kernel * kernel * c)
    w3 = wq.to(dt).reshape(kernel * kernel, c, -1)
    pad = kernel // 2
    ho, wo = -(-h // stride), -(-w // stride)
    xp = F.pad(x.to(dt), (0, 0, pad, pad, pad, pad))
    acc = torch.zeros((b, ho, wo, w3.shape[-1]), dtype=dt, device=x.device)
    for sl, wslab in zip(conv_window_slices(xp, kernel, stride, ho, wo), w3):
        acc += sl @ wslab
    return _narrow(acc)
