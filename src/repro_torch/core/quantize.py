"""Fixed-point quantization with 2's-complement bit-plane decomposition.

PyTorch-port counterpart of ``repro/core/quantize.py``. A P-bit signed
2's-complement value obeys

    x_q = -2^(P-1) * b_{P-1} + sum_{p=0}^{P-2} 2^p * b_p

(the SIP's MSB negation block). Every float step here is one IEEE
float32 elementwise op in the same order as the reference: the scale is
``absmax / qmax`` and the grid is ``round(x / scale)``, both true
divisions, rounded half to even (``torch.round``), so the port's
quantized operands equal the reference's bit for bit.

:func:`fake_quant` is the training side (QAT): the forward rounds onto
the quantized grid, the backward is the identity (the straight-through
estimator).
"""
from __future__ import annotations

import torch


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def qmin(bits: int) -> int:
    return -(1 << (bits - 1))


def _dims(x: torch.Tensor, axis) -> tuple:
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(a % x.ndim for a in ((axis,) if isinstance(axis, int) else axis))


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as an IEEE division on every device. PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, one ulp off
    the true quotient at some inputs; a divisor tensor on ``a``'s device
    takes the true division, as the reference does."""
    return a / torch.full_like(a, b)


def compute_scale(x: torch.Tensor, bits: int, axis=None,
                  keepdims: bool = True) -> torch.Tensor:
    """Symmetric absmax scale so that max|x| maps to qmax(bits).

    Computed in float32 whatever ``x``'s dtype: the reference's clamp
    against float32's ``tiny`` promotes a bf16 absmax to float32 before
    the division."""
    return scale_from_absmax(
        torch.amax(x.abs(), dim=_dims(x, axis), keepdim=keepdims), bits)


def scale_from_absmax(absmax: torch.Tensor, bits: int) -> torch.Tensor:
    """:func:`compute_scale` from an absmax already taken (e.g. reduced
    over the ranks that hold a row's pieces)."""
    absmax = torch.clamp(absmax.to(torch.float32),
                         min=torch.finfo(torch.float32).tiny)
    return true_div(absmax, qmax(bits))


def quantize(x: torch.Tensor, bits: int, scale: torch.Tensor | None = None,
             axis=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to signed ``bits``-bit integers (stored as int32).

    Returns (x_q, scale). Symmetric, round-half-to-even, clipped to the
    signed range.
    """
    if scale is None:
        scale = compute_scale(x, bits, axis=axis)
    xq = torch.clamp(torch.round(x / scale), qmin(bits), qmax(bits))
    return xq.to(torch.int32), scale


def dequantize(xq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return xq.to(torch.float32) * scale


class _FakeQuant(torch.autograd.Function):
    """``dequantize(*quantize(x, bits))`` in x's dtype; the gradient passes
    through unchanged, with no clipping mask (the reference's ``_fq_bwd``)."""

    @staticmethod
    def forward(ctx, x, bits, reduce_max):
        scale = None
        if reduce_max is not None:
            absmax = torch.amax(x.abs(), dim=_dims(x, None), keepdim=True)
            scale = scale_from_absmax(reduce_max(absmax), bits)
        return dequantize(*quantize(x, bits, scale=scale)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, bits: int, reduce_max=None) -> torch.Tensor:
    """Straight-through fake quantization of x to ``bits`` bits under one
    per-tensor absmax scale. ``reduce_max`` (x a rank's piece of a
    tensor on a mesh) maps the local absmax to the whole tensor's."""
    return _FakeQuant.apply(x, bits, reduce_max)


def to_twos_complement(xq: torch.Tensor, bits: int) -> torch.Tensor:
    """Map signed ints to their unsigned 2's-complement bit pattern (P bits)."""
    return torch.bitwise_and(xq, (1 << bits) - 1)


def bit_planes(xq: torch.Tensor, bits: int) -> torch.Tensor:
    """Decompose signed ints into ``bits`` 2's-complement bit planes.

    Returns uint8 of shape (bits,) + xq.shape with values in {0, 1}; plane p
    holds bit p, and ``xq == sum_p plane_weights(bits)[p] * planes[p]``.
    """
    tc = to_twos_complement(xq.to(torch.int32), bits)
    shifts = torch.arange(bits, dtype=torch.int32, device=xq.device)
    shifts = shifts.reshape((bits,) + (1,) * xq.ndim)
    return torch.bitwise_and(tc[None] >> shifts, 1).to(torch.uint8)


def plane_weights(bits: int, device=None) -> torch.Tensor:
    """Signed weight of each 2's-complement bit plane (int32: P<=16 fits)."""
    w = 1 << torch.arange(bits, dtype=torch.int32, device=device)
    w[bits - 1] = -w[bits - 1]
    return w


def effective_bits(xq: torch.Tensor, axis=None,
                   keepdims: bool = False) -> torch.Tensor:
    """Per-group effective precision: bits needed for max|group| + sign,
    ``ceil(log2(max|x| + 1)) + 1`` in float32 as the reference computes it.
    Zero groups need 1 bit."""
    m = torch.amax(xq.abs(), dim=_dims(xq, axis), keepdim=keepdims)
    nbits = torch.ceil(torch.log2(m.to(torch.float32) + 1.0)).to(torch.int32)
    return torch.clamp(nbits + 1, min=1)


def group_planes(xq: torch.Tensor, bits: int,
                 plane_width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decompose into ceil(bits/plane_width) planes of ``plane_width`` bits.

    The low planes are unsigned, in [0, 2^w - 1]; the top plane is signed
    at its own width (the value sign-extended first), the MSB negation at
    plane granularity. Returns (planes int32 of shape (n_planes,) +
    xq.shape, shifts int32 (n_planes,)), and
    ``xq == sum_p shifts[p] * planes[p]``.
    """
    n_planes = -(-bits // plane_width)
    padded_bits = n_planes * plane_width
    tc = to_twos_complement(xq.to(torch.int32), bits)
    sign = (tc >> (bits - 1)) & 1
    ext_mask = ((1 << padded_bits) - 1) ^ ((1 << bits) - 1)
    tc = torch.where(sign == 1, tc | ext_mask, tc)
    shifts = torch.arange(n_planes, dtype=torch.int32,
                          device=xq.device) * plane_width
    planes = (tc[None] >> shifts.reshape((n_planes,) + (1,) * xq.ndim)) \
        & ((1 << plane_width) - 1)
    top = planes[n_planes - 1]
    planes[n_planes - 1] = torch.where(top >= 1 << (plane_width - 1),
                                       top - (1 << plane_width), top)
    return planes, (1 << shifts).to(torch.int32)
