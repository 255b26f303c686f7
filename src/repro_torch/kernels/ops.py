"""Serving-path orchestration around the backend op surface.

PyTorch-port counterpart of ``repro/kernels/ops.py`` (the serving linear
and conv, static and with runtime activation trimming, the integer
products of the bit-parallel ``serve_int8`` route, and the entry points
of the activation quantizer and of attention). These functions
own the numeric steps that are the same on every backend -- activation
quantization, K padding against the packed layout, the OR-tree plane
counts, and the final dequantizing cast -- and hand the integer core to a
:class:`~repro_torch.api.backend.Backend`. The float steps keep the
reference's exact order, so the logits match it bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.api.backend import (dense_weights, resolve_backend,
                                     sum_int8_subplanes)
from repro_torch.core import bitpack, dynamic, quantize as q
from repro_torch.kernels import ref
from repro_torch.runtime import tracing


def loom_linear_serve(x: torch.Tensor, w_packed: torch.Tensor,
                      w_scale: torch.Tensor, *, a_bits: int, w_bits: int,
                      backend=None, w_counts=None, w_group: int = 16,
                      a_axis: int | None = -1, x_scale=None,
                      int_sum=None) -> torch.Tensor:
    """Serving-path linear: activations quantized to a_bits at run time,
    weights pre-packed bit-serially. Output in x.dtype.

    x: [..., K]; w_packed: uint8 [Pw, K8/8, N]; w_scale: per-tensor f32.
    ``a_axis``: -1 = one scale per row (the default), None = one scale for
    the whole tensor. A row-parallel shard (``repro_torch.dist.parallel``)
    passes ``x_scale`` ([rows, 1] float32, the whole row's scale) and
    ``int_sum``, applied to the int32 product before dequantization (the
    sum over the ranks' K-slices).
    """
    be = resolve_backend(backend)
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, k)
    k8 = w_packed.shape[1] * 8
    if k8 != k:  # pack_weights zero-pads K%8 rows; mirror on activations
        x2 = F.pad(x2, (0, k8 - k))
    a_bits = min(a_bits, 8)  # int8 kernel ABI
    with tracing.span("ops.quantize"):
        xq, x_scale = q.quantize(x2, a_bits, scale=x_scale, axis=a_axis)
        xq8 = xq.to(torch.int8)
    y = be.matmul_planes(xq8, w_packed, w_bits=w_bits, w_counts=w_counts,
                         w_group=w_group)
    del xq8                    # held only through the kernel's call
    if int_sum is not None:
        y = int_sum(y)
    with tracing.span("ops.dequantize"):
        out = (y * (x_scale * w_scale).to(torch.float32)).to(x.dtype)
    return out if x.ndim == 2 else out.reshape(*lead, -1)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def loom_linear_serve_dynamic(x: torch.Tensor, w_packed: torch.Tensor,
                              w_scale: torch.Tensor, *, a_bits: int,
                              w_bits: int, group_size: int = 256,
                              backend=None, w_counts=None, w_group: int = 16,
                              a_axis: int | None = -1, x_scale=None,
                              int_sum=None) -> torch.Tensor:
    """Serving linear with runtime activation-plane trimming; bit-identical
    to :func:`loom_linear_serve`.

    The activations are quantized on the static path's grid, then each
    group of ``group_size`` rows runs only its OR-tree count of activation
    planes. The matmul is transposed so that the activations become the
    plane-serial packed operand of ``matmul_planes_dynamic``:

        y.T[N, Mp] = Wq.T[N, K8] @ Xq[K8, Mp]

    with ``Xq`` packed at Pa at run time and rows zero-padded to Mp, a
    multiple of the group. The dense weights ride int8; Pw > 8 splits them
    into 7-bit subplanes whose shifted partials sum exactly. ``w_counts``
    composes static weight-group trimming in by truncating the dense
    weights per filter group first. ``x_scale`` and ``int_sum`` as in
    :func:`loom_linear_serve`: a row-parallel shard counts the planes of
    its own K-slice, never more than the whole row needs, so the product
    stays exact.
    """
    be = resolve_backend(backend)
    lead = x.shape[:-1]
    k = x.shape[-1]
    x2 = x if x.ndim == 2 else x.reshape(-1, k)
    k8 = w_packed.shape[1] * 8
    if k8 != k:
        x2 = F.pad(x2, (0, k8 - k))
    a_bits = min(a_bits, 8)
    with tracing.span("ops.quantize"):
        xq, x_scale = q.quantize(x2, a_bits, scale=x_scale, axis=a_axis)
    m = xq.shape[0]
    # A group is group_size rows; a small batch is one 8-row-aligned group.
    g = min(group_size, _round_up(m, 8))
    mp = _round_up(m, g)
    if mp != m:
        xq = F.pad(xq, (0, 0, 0, mp - m))     # zero rows: the 1-bit floor
    with tracing.span("trim.counts"):
        counts = dynamic.serve_group_counts(xq, g, a_bits)      # [mp / g]
    with tracing.span("trim.pack_activations"):
        x_packed = bitpack.pack_weights(xq.T, a_bits)           # [Pa, K8/8, mp]

    def run(plane):
        _count_planes(counts, a_bits)
        return be.matmul_planes_dynamic(plane.T.contiguous(), x_packed,
                                        counts, w_bits=a_bits, bn=g)

    yt = sum_int8_subplanes(
        dense_weights(w_packed, w_bits, w_counts, w_group), w_bits, run)
    # Row-major like the static path's output: the float ops downstream
    # (attention's products) may sum in another order for another layout.
    y = yt.T[:m].contiguous()
    if int_sum is not None:
        y = int_sum(y)
    with tracing.span("ops.dequantize"):
        out = (y * (x_scale * w_scale).to(torch.float32)).to(x.dtype)
    return out if x.ndim == 2 else out.reshape(*lead, -1)


def _count_planes(counts: torch.Tensor, a_bits: int) -> None:
    """The activation planes one dynamic call hands its kernel, and the
    static planes of the same groups."""
    tracing.count("trim.a_planes", counts)
    tracing.count("trim.a_static_planes", counts.numel() * a_bits)


def conv_accum_fits_f32(kkc: int, a_bits: int, w_bits: int) -> bool:
    """True when every partial sum of the integer conv is <= 2^24 in
    magnitude, i.e. exactly representable in a float32 mantissa."""
    return kkc << (a_bits - 1 + w_bits - 1) <= 1 << 24


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 product ``x [..., K] @ w [K, N]`` -> int32 [..., N],
    the reference's ``dot_general(..., preferred_element_type=int32)``.

    One ``torch._int_mm`` on every device. Its CUDA route takes M > 16
    rows and K, N multiples of 8, so the operands are zero-padded at call
    time (rows to at least 32 and a multiple of 8, K and N to multiples
    of 8) and the result sliced back; zero rows and columns add nothing
    to an integer sum. The stored ``w`` is never padded. A shape that
    ``_int_mm`` still refuses raises."""
    lead, n = x.shape[:-1], w.shape[1]
    x2 = x.reshape(-1, x.shape[-1])
    m, k = x2.shape
    pad_m = max(32, _round_up(m, 8)) - m
    pad_k, pad_n = (-k) % 8, (-n) % 8
    if pad_m or pad_k:
        x2 = F.pad(x2, (0, pad_k, 0, pad_m))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_n, 0, pad_k))
    y = torch._int_mm(x2.contiguous(), w.contiguous())
    return y[:m, :n].reshape(*lead, n)


# Stems with C <= this fold their k*k window offsets into the channel dim
# (one product over K = k*k*C) instead of walking k*k passes of K = C.
STEM_FOLD_MAX_C = 4


def int_conv_same(x_int: torch.Tensor, w4: torch.Tensor, stride: int,
                  exact_f32: bool = False,
                  fold_kk: bool | None = None) -> torch.Tensor:
    """Integer "same"-padded conv as k*k shift-and-matmul passes.

    x_int: int [B, H, W, C]; w4: int [k, k, C, N] -> exact int32
    [B, ceil(H/stride), ceil(W/stride), N]. Each window offset (di, dj)
    multiplies one strided slice of the padded map by its [C, N] slab; no
    patch tensor is built unless ``fold_kk``, which concatenates the k*k
    slices and runs one product over K = k*k*C (default: when C <=
    :data:`STEM_FOLD_MAX_C`). ``exact_f32``: the products run in float32;
    the caller guarantees :func:`conv_accum_fits_f32`, so every partial
    sum is an integer a float32 mantissa holds and the result is exact in
    any summation order (TF32 included: the operands are below 2^11).
    Otherwise they run in int64 on the CPU and float64 on the card (exact,
    as :mod:`repro_torch.kernels.ref` takes them), narrowed to int32 last.
    """
    k, _, c, n = w4.shape
    pad = k // 2
    b, h, w_, _ = x_int.shape
    ho, wo = -(-h // stride), -(-w_ // stride)
    dt = torch.float32 if exact_f32 else ref._exact_dtype(x_int.device)
    xp = F.pad(x_int.to(dt), (0, 0, pad, pad, pad, pad))
    if fold_kk is None:
        fold_kk = c <= STEM_FOLD_MAX_C
    slices = ref.conv_window_slices(xp, k, stride, ho, wo)
    if fold_kk:
        patches = torch.cat(slices, dim=-1)             # [B, Ho, Wo, kkC]
        return ref._narrow(patches @ w4.to(dt).reshape(k * k * c, n))
    wc = w4.to(dt).reshape(k * k, c, n)
    acc = torch.zeros((b, ho, wo, n), dtype=dt, device=x_int.device)
    for sl, wslab in zip(slices, wc):
        acc += sl @ wslab
    return ref._narrow(acc)


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
    with tracing.span("ops.quantize"):
        xq, x_scale = q.quantize(x.to(torch.float32), a_bits)
        xq8 = xq.to(torch.int8)
    y = be.conv_planes(xq8, w_packed, kernel=kernel, stride=stride,
                       w_bits=w_bits, conv_tile=conv_tile,
                       w_counts=w_counts, w_group=w_group)
    del xq8                    # held only through the kernel's call
    with tracing.span("ops.dequantize"):
        return (y * (x_scale * w_scale).to(torch.float32)).to(x.dtype)


def loom_conv_serve_dynamic(x: torch.Tensor, w_packed: torch.Tensor,
                            w_scale: torch.Tensor, *, kernel: int, stride: int,
                            a_bits: int, group_size: int = 256, backend=None,
                            conv_tile: int | None = None, w_counts=None,
                            w_group: int = 16) -> torch.Tensor:
    """Serving conv with runtime activation-plane trimming; bit-identical
    to :func:`loom_conv_serve`.

    The activations are quantized on the static path's per-tensor grid;
    the OR-tree (:func:`repro_torch.core.dynamic.conv_window_group_counts`)
    gives each group of ``group_size`` output windows its plane count, and
    ``conv_planes_dynamic`` runs only that many activation planes. A small
    map is one 8-window-aligned group. ``w_counts`` composes static
    weight-group trimming in.
    """
    be = resolve_backend(backend)
    w_bits = w_packed.shape[0]
    a_bits = min(a_bits, 8)  # int8 kernel ABI, as in loom_conv_serve
    with tracing.span("ops.quantize"):
        xq, x_scale = q.quantize(x.to(torch.float32), a_bits)
    nwin = -(-x.shape[1] // stride) * -(-x.shape[2] // stride)
    gsz = min(group_size, _round_up(nwin, 8))
    with tracing.span("trim.counts"):
        counts = dynamic.conv_window_group_counts(xq, kernel, stride, gsz,
                                                  a_bits)
    with tracing.span("ops.quantize"):      # its int8 cast, as above
        xq8 = xq.to(torch.int8)
    _count_planes(counts, a_bits)
    y = be.conv_planes_dynamic(xq8, w_packed, counts, kernel=kernel,
                               stride=stride, w_bits=w_bits, group_size=gsz,
                               conv_tile=conv_tile, w_counts=w_counts,
                               w_group=w_group)
    del xq8                    # held only through the kernel's call
    with tracing.span("ops.dequantize"):
        return (y * (x_scale * w_scale).to(torch.float32)).to(x.dtype)


def quantize_activations(x: torch.Tensor, *, group_size: int = 256,
                         bits: int = 8, backend=None):
    """Dynamic per-group activation quantization (Loom's runtime path):
    x [..., K] -> (xq int8 [..., K], scale f32 [..., K/G], eff_bits int32
    [..., K/G]), computed in float32."""
    be = resolve_backend(backend)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32).contiguous()
    xq, scale, eff = be.dynamic_quant(x2, group_size=group_size, bits=bits)
    return (xq.reshape(*lead, -1), scale.reshape(*lead, -1),
            eff.reshape(*lead, -1))


def attention(q_: torch.Tensor, k_: torch.Tensor, v_: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              backend=None) -> torch.Tensor:
    """Full-sequence attention ([B, H, S, D], KV already head-repeated)."""
    be = resolve_backend(backend)
    return be.attention(q_, k_, v_, causal=causal, window=window)
