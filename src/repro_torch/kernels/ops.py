"""Serving-path orchestration around the backend op surface.

PyTorch-port counterpart of ``repro/kernels/ops.py`` (the static serving
linear and conv). These functions own the numeric steps that are the same
on every backend -- activation quantization, K padding against the packed
layout, and the final dequantizing cast -- and hand the integer core to a
:class:`~repro_torch.api.backend.Backend`. The float steps keep the
reference's exact order, so the logits match it bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.api.backend import resolve_backend
from repro_torch.core import quantize as q


def loom_linear_serve(x: torch.Tensor, w_packed: torch.Tensor,
                      w_scale: torch.Tensor, *, a_bits: int, w_bits: int,
                      backend=None, w_counts=None, w_group: int = 16,
                      a_axis: int | None = -1) -> torch.Tensor:
    """Serving-path linear: activations quantized to a_bits at run time,
    weights pre-packed bit-serially. Output in x.dtype.

    x: [..., K]; w_packed: uint8 [Pw, K8/8, N]; w_scale: per-tensor f32.
    ``a_axis``: -1 = one scale per row (the default), None = one scale for
    the whole tensor.
    """
    be = resolve_backend(backend)
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, k)
    k8 = w_packed.shape[1] * 8
    if k8 != k:  # pack_weights zero-pads K%8 rows; mirror on activations
        x2 = F.pad(x2, (0, k8 - k))
    a_bits = min(a_bits, 8)  # int8 kernel ABI
    xq, x_scale = q.quantize(x2, a_bits, axis=a_axis)
    y = be.matmul_planes(xq.to(torch.int8), w_packed, w_bits=w_bits,
                         w_counts=w_counts, w_group=w_group)
    out = (y * (x_scale * w_scale).to(torch.float32)).to(x.dtype)
    return out if x.ndim == 2 else out.reshape(*lead, -1)


def conv_accum_fits_f32(kkc: int, a_bits: int, w_bits: int) -> bool:
    """True when every partial sum of the integer conv is <= 2^24 in
    magnitude, i.e. exactly representable in a float32 mantissa."""
    return kkc << (a_bits - 1 + w_bits - 1) <= 1 << 24


def loom_conv_serve(x: torch.Tensor, w_packed: torch.Tensor,
                    w_scale: torch.Tensor, *, kernel: int, stride: int,
                    a_bits: int, backend=None, conv_tile: int | None = None,
                    w_counts=None, w_group: int = 16) -> torch.Tensor:
    """Serving-path fused conv.

    x: [B, H, W, C] float (NHWC); w_packed: uint8 [Pw, ceil(k*k*C/8), N]
    in the (di, dj, c) row order of pack_weights. Activations are quantized
    to a_bits with ONE scale for the whole batch, as the reference does;
    the conv runs integer-exact over the packed planes. Output in x.dtype.
    """
    be = resolve_backend(backend)
    w_bits = w_packed.shape[0]
    a_bits = min(a_bits, 8)  # int8 kernel ABI
    xq, x_scale = q.quantize(x.to(torch.float32), a_bits)
    y = be.conv_planes(xq.to(torch.int8), w_packed, kernel=kernel,
                       stride=stride, w_bits=w_bits, conv_tile=conv_tile,
                       w_counts=w_counts, w_group=w_group)
    return (y * (x_scale * w_scale).to(torch.float32)).to(x.dtype)
