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
from repro_torch.core.quantize import true_div
from repro_torch.core.weightgroups import truncate_columns_grouped, truncate_signed


def _exact_dtype(device: torch.device) -> torch.dtype:
    return torch.float64 if device.type == "cuda" else torch.int64


def _narrow(acc: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.int64).to(torch.int32)


def bitserial_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor,
                         w_bits: int) -> torch.Tensor:
    """int8 [M, K] @ packed uint8 [Pw, K//8, N] -> exact int32 [M, N],
    over blocks of N whose int32 and float64 weights take about 256 MiB
    (an LM head's at once would take tens of GB: 56.6 for
    nemotron-4-340b's)."""
    dt = _exact_dtype(x.device)
    xd = x.to(dt)
    return bitpack.by_columns(
        lambda wp: _narrow(xd @ bitpack.unpack_weights(wp, w_bits).to(dt)),
        w_packed, 12 * 8 * w_packed.shape[1])


def bitserial_matmul_dynamic_ref(x: torch.Tensor, w_packed: torch.Tensor,
                                 plane_counts, w_bits: int,
                                 bn: int) -> torch.Tensor:
    """K3's plain version: column group j (columns [j*bn, (j+1)*bn), the
    last one may be ragged) uses only its first ``plane_counts[j]`` planes,
    plane count-1 negated. That is 2's-complement truncation of the
    unpacked column at its count, which is how it is computed here.
    Counts must lie in [1, Pw]."""
    dt = _exact_dtype(x.device)
    wq = truncate_columns_grouped(bitpack.unpack_weights(w_packed, w_bits),
                                  plane_counts, bn)
    return _narrow(x.to(dt) @ wq.to(dt))


# Static per-filter-group weight trimming on the linear path is the same
# function with the pack-time counts and bn = the filter group.
bitserial_matmul_wgroup_ref = bitserial_matmul_dynamic_ref


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


def _conv_walk(xp: torch.Tensor, w3: torch.Tensor, kernel: int, stride: int,
               ho: int, wo: int, cmap: torch.Tensor | None) -> torch.Tensor:
    """Exact conv of a PADDED int map ``xp`` [B, Hp, Wp, C] (int32 when
    ``cmap`` is given, else the exact dtype) with ``w3`` [k*k, C, N]: one
    slab per window offset. ``cmap`` [B, Ho, Wo, 1] truncates each window's
    activations at its plane count first."""
    acc = torch.zeros((xp.shape[0], ho, wo, w3.shape[-1]), dtype=w3.dtype,
                      device=xp.device)
    for sl, wslab in zip(conv_window_slices(xp, kernel, stride, ho, wo), w3):
        if cmap is not None:
            sl = truncate_signed(sl, cmap).to(w3.dtype)
        acc += sl @ wslab
    return acc


def _conv_exact(x: torch.Tensor, wq: torch.Tensor, *, kernel: int,
                stride: int, counts=None, group_size: int = 256,
                rows_per_band: int | None = None) -> torch.Tensor:
    """Exact "same"-padded conv of int x [B, H, W, C] with int weights
    [>= k*k*C, N] (rows past k*k*C are the K8 pad and are not read).
    ``counts`` [B, G]: window p of image b has its activations truncated at
    counts[b, p // group_size]. It runs one band of ``rows_per_band``
    output rows (None = one band) at a time, each band computed from only
    its own input row band, halo included."""
    b, h, w, c = x.shape
    dt = _exact_dtype(x.device)
    w3 = wq[:kernel * kernel * c].to(dt).reshape(kernel * kernel, c, -1)
    pad = kernel // 2
    ho, wo = -(-h // stride), -(-w // stride)
    rpb = ho if rows_per_band is None else max(1, min(rows_per_band, ho))
    cmap = _window_counts(counts, group_size, b, ho, wo)
    xp = F.pad(x.to(dt if counts is None else torch.int32),
               (0, 0, pad, pad, pad, pad))
    bands = []
    for r0 in range(0, ho, rpb):
        rows = min(rpb, ho - r0)
        band = xp[:, r0 * stride:r0 * stride + (rows - 1) * stride + kernel]
        bands.append(_conv_walk(band, w3, kernel, stride, rows, wo,
                                None if cmap is None else
                                cmap[:, r0:r0 + rows]))
    return _narrow(torch.cat(bands, dim=1))


def _window_counts(counts, group_size: int, b: int, ho: int, wo: int):
    """[B, G] group counts -> [B, Ho, Wo, 1] per-window counts (row-major
    windows, group p // group_size), or None."""
    if counts is None:
        return None
    cmap = torch.repeat_interleave(counts.to(torch.int32), group_size, dim=1)
    return cmap[:, :ho * wo].reshape(b, ho, wo, 1)


def bitserial_conv_ref(x: torch.Tensor, w_packed: torch.Tensor, *,
                       kernel: int, stride: int = 1,
                       w_bits: int) -> torch.Tensor:
    """Exact "same"-padded conv (pad = k//2, Ho = ceil(H/stride)).

    x: int [B, H, W, C] (NHWC); w_packed: uint8 [Pw, ceil(k*k*C/8), N].
    Returns int32 [B, Ho, Wo, N]: the k*k window walk, one [C, N] weight
    slab per window offset, summed exactly.
    """
    wq = bitpack.unpack_weights(w_packed, w_bits)
    return _conv_exact(x, wq, kernel=kernel, stride=stride)


def bitserial_conv_banded_ref(x: torch.Tensor, w_packed: torch.Tensor, *,
                              kernel: int, stride: int = 1, w_bits: int,
                              rows_per_band: int) -> torch.Tensor:
    """Band-by-band oracle of K2's decomposition: the conv of
    :func:`bitserial_conv_ref`, one band of ``rows_per_band`` output rows
    at a time, each band seeing only its own input row band (the halo).
    It pins that banding never changes the result: for every band size it
    equals :func:`bitserial_conv_ref` bit for bit."""
    return _conv_exact(x, bitpack.unpack_weights(w_packed, w_bits),
                       kernel=kernel, stride=stride,
                       rows_per_band=rows_per_band)


def bitserial_conv_wgroup_ref(x: torch.Tensor, w_packed: torch.Tensor,
                              counts, *, kernel: int, stride: int = 1,
                              w_bits: int, w_group: int = 16) -> torch.Tensor:
    """K4's plain version: filter group g (``w_group`` output channels, the
    last one may be ragged) uses only its first counts[g] weight planes,
    plane count-1 negated: its weights truncated at that width. For
    pack-time OR-tree counts this equals :func:`bitserial_conv_ref`."""
    wq = truncate_columns_grouped(bitpack.unpack_weights(w_packed, w_bits),
                                  counts, w_group)
    return _conv_exact(x, wq, kernel=kernel, stride=stride)


def conv_dynamic_dense_ref(x: torch.Tensor, wq: torch.Tensor, counts, *,
                           kernel: int, stride: int = 1,
                           group_size: int = 256) -> torch.Tensor:
    """K5's plain version: the "same" conv of int x [B, H, W, C] with dense
    int weights wq [K8, N] (K8 = k*k*C rounded up to 8; the pad rows are not
    read), window p of image b using only the first counts[b, p //
    group_size] activation planes, plane count-1 negated: its activations
    truncated at that width. counts: int [B, ceil(Ho*Wo/group_size)], each
    in [1, 8]. Returns int32 [B, Ho, Wo, N]."""
    return _conv_exact(x, wq, kernel=kernel, stride=stride, counts=counts,
                       group_size=group_size)


def bitserial_conv_dynamic_ref(x: torch.Tensor, w_packed: torch.Tensor,
                               counts, *, kernel: int, stride: int = 1,
                               w_bits: int,
                               group_size: int = 256) -> torch.Tensor:
    """:func:`conv_dynamic_dense_ref` over packed weights, the reference's
    signature. For the OR-tree's own counts it equals
    :func:`bitserial_conv_ref`."""
    return conv_dynamic_dense_ref(x, bitpack.unpack_weights(w_packed, w_bits),
                                  counts, kernel=kernel, stride=stride,
                                  group_size=group_size)


def bitserial_conv_dynamic_banded_ref(x: torch.Tensor, w_packed: torch.Tensor,
                                      counts, *, kernel: int, stride: int = 1,
                                      w_bits: int, group_size: int = 256,
                                      rows_per_band: int | None = None
                                      ) -> torch.Tensor:
    """Band-local oracle of K5's decomposition: each band of
    ``rows_per_band`` output rows (None = one band) is computed from only
    its own input row band, halo included, each window truncated at its
    group's count. K5 bands as K2 does, by output rows, where the
    reference's kernel bands by window group; both decompositions equal
    :func:`bitserial_conv_dynamic_ref` for any counts."""
    return _conv_exact(x, bitpack.unpack_weights(w_packed, w_bits),
                       kernel=kernel, stride=stride, counts=counts,
                       group_size=group_size, rows_per_band=rows_per_band)


def _flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """float32 values below ``tiny`` in magnitude read as zero: the
    reference runs on XLA:CPU, which flushes subnormal inputs and results
    to zero (torch on the CPU and this port's CUDA build do not)."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny,
                       torch.zeros_like(x), x)


def dynamic_quant_ref(x: torch.Tensor, group_size: int, bits: int = 8):
    """K6's plain version: per-group symmetric quantization and
    effective-precision detection.

    x: f32 [M, K] -> (xq int8 [M, K], scale f32 [M, K // group_size],
    eff_bits int32 [M, K // group_size]). Per group of ``group_size``
    along K: ``scale = max(absmax, tiny) / qmax`` and ``xq =
    clip(round_half_even(x / scale))``; eff_bits is the bit length of
    max|xq| plus the sign, floored at 1 (``ceil(log2(max|xq| + 1)) + 1``).

    The reference's subnormal flushing is written out: subnormal inputs
    read as zero, a scale below ``tiny`` is 0.0, and then ``0 / 0`` gives
    0 while ``±x / 0`` clips to qmax / qmin.
    """
    m, k = x.shape
    if k % group_size:
        raise ValueError(f"K={k} is not a multiple of group_size="
                         f"{group_size}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits={bits} outside [2, 8]")
    qmax, qmin = (1 << (bits - 1)) - 1, -(1 << (bits - 1))
    xg = _flush_subnormals(x.to(torch.float32)).reshape(m, k // group_size,
                                                        group_size)
    absmax = torch.clamp(xg.abs().amax(-1), min=torch.finfo(torch.float32).tiny)
    scale = _flush_subnormals(true_div(absmax, qmax))
    v = torch.round(xg / scale[..., None])
    v = torch.clamp(torch.where(torch.isnan(v), torch.zeros_like(v), v),
                    qmin, qmax)
    xq = v.to(torch.int8)
    mag = xq.to(torch.int32).abs().amax(-1)
    eff = torch.zeros_like(mag)
    for b in range(bits + 1):           # bit length of mag, mag <= 2^(bits-1)
        eff += (mag >= (1 << b)).to(torch.int32)
    return xq.reshape(m, k), scale, eff + 1


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """K7's plain version: exact softmax attention. q, k, v: [B, H, S, D]
    with one head count. The logits are the product in the inputs' dtype,
    then float32 times ``scale`` (default ``D ** -0.5``); keys outside
    ``(i - window, i]`` (``window``) or after ``i`` (``causal``) are masked
    with -inf. Returns [B, H, S, D] in q's dtype. Materializes the [B, H,
    S, S] float32 logits."""
    s, d = q.shape[2], q.shape[3]
    if scale is None:
        scale = d ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)
