"""Loom plane-serial matmul engine (the SIP array), exact on every device.

PyTorch-port counterpart of ``repro/core/engine.py``. ``loom_matmul``
computes Y = Xq @ Wq exactly by decomposing both operands into planes of
``a_plane_bits`` / ``w_plane_bits`` bits and accumulating shifted partial
products:

    Y = sum_i sum_j  s_i * t_j * 2^(ba*i + bw*j) * (X_i @ W_j)

where X_i, W_j are the i-th/j-th planes and the top planes carry the sign
(the paper's MSB negation block, at plane granularity). The number of
partial products is ceil(Pa/ba) * ceil(Pw/bw): work scales inversely with
precision as Loom's CVL law 256/(Pa*Pw) when ba = bw = 1 and the
baseline is 16x16 planes.

Plane widths map to the paper's variants:
    ba = bw = 1  -> LM_1b      (max speedup)
    2            -> LM_2b      (paper: most energy-efficient ASIC point)
    4            -> LM_4b
    8            -> LM_8b      (one int8 tensor-core pass per plane pair)

The FCL mode of the paper (weights serial, activations bit-parallel) is
``mode="serial_weights"`` (one activation plane): work scales 16/Pw.

The reference contracts int32 planes in one ``jnp.matmul(...,
preferred_element_type=int32)``; cuBLAS has no int32 product, so the
stacked planes go through one exact library product
(:func:`exact_product`): ``ops.int8_matmul`` (``torch._int_mm``) where
every plane fits int8, else a float64 product, exact below 2^53. No
Pallas kernel computes this engine, so no hand-written kernel stands in
for it. The result wraps to int32 as the reference's int32 sums do.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import quantize as q


@dataclasses.dataclass(frozen=True)
class LoomConfig:
    """Configuration of the plane-serial engine for one linear layer."""

    a_bits: int = 8            # Pa: activation precision
    w_bits: int = 8            # Pw: weight precision
    a_plane_bits: int = 8      # ba: activation bits processed per pass
    w_plane_bits: int = 8      # bw: weight bits processed per pass
    dynamic_a: bool = False    # runtime per-group activation precision trim
    group_size: int = 256      # paper: group of 256 concurrent activations
    mode: Literal["serial_both", "serial_weights"] = "serial_both"
    # serial_both  == CVL law  256/(Pa*Pw)
    # serial_weights == FCL law 16/Pw (activations consumed bit-parallel)

    @property
    def n_a_planes(self) -> int:
        if self.mode == "serial_weights":
            return 1
        return -(-self.a_bits // self.a_plane_bits)

    @property
    def n_w_planes(self) -> int:
        return -(-self.w_bits // self.w_plane_bits)

    def speedup_vs_base(self, base_bits: int = 16) -> float:
        """Ideal Loom speedup law for this config (paper Sec. 2)."""
        if self.mode == "serial_weights":
            return base_bits / (self.n_w_planes * self.w_plane_bits)
        return (base_bits * base_bits) / (
            (self.n_a_planes * self.a_plane_bits) * (self.n_w_planes * self.w_plane_bits))


def plane_range(bits: int, plane_width: int) -> tuple[int, int]:
    """(min, max) a plane of ``q.group_planes(xq, bits, plane_width)`` can
    hold: one plane is the signed value itself; with several, the low
    planes are unsigned at ``plane_width`` bits and the top one signed."""
    if -(-bits // plane_width) == 1:
        return q.qmin(bits), q.qmax(bits)
    return min(0, q.qmin(plane_width)), (1 << plane_width) - 1


def product_route(k: int, a_range: tuple[int, int],
                  w_range: tuple[int, int]) -> str:
    """The exact product of [M, K] and [K, N] integer operands with
    values in ``a_range`` and ``w_range``: ``"int8"`` (one
    ``torch._int_mm``, int32 sums that cannot wrap) where both operands
    fit int8, else ``"float64"`` (exact while every sum stays below
    2^53). A product that neither keeps exact raises."""
    amax = max(abs(v) for v in a_range)
    wmax = max(abs(v) for v in w_range)
    fits8 = all(-128 <= v <= 127 for v in a_range + w_range)
    if fits8 and k * amax * wmax < 1 << 31:
        return "int8"
    if k * amax * wmax < 1 << 53:
        return "float64"
    raise ValueError(f"no exact product for K={k}, |a| <= {amax}, "
                     f"|w| <= {wmax}: a float64 sum could pass 2^53")


def exact_product(a: torch.Tensor, w: torch.Tensor, route: str) -> torch.Tensor:
    """``a [M, K] @ w [K, N]`` of integer tensors, exact, as int64."""
    if route == "int8":
        from repro_torch.kernels import ops
        return ops.int8_matmul(a.to(torch.int8), w.to(torch.int8)).to(torch.int64)
    if route == "float64":
        return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(torch.int64)
    raise ValueError(f"unknown product route {route!r}")


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits, as an int32 sum wraps."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def plane_matmul(xq: torch.Tensor, wq: torch.Tensor,
                 cfg: LoomConfig) -> torch.Tensor:
    """Integer-exact plane-serial matmul of quantized operands.

    xq: int [..., K] in the signed a_bits range; wq: int [K, N] in the
    w_bits range. Returns int32 [..., N] == xq @ wq, wrapped to 32 bits
    as the reference's int32 product wraps.
    """
    if cfg.mode == "serial_weights":
        a_planes = xq[None].to(torch.int32)
        a_scales = torch.ones((1,), dtype=torch.int32, device=xq.device)
        a_range = (q.qmin(cfg.a_bits), q.qmax(cfg.a_bits))
    else:
        a_planes, a_scales = q.group_planes(xq, cfg.a_bits, cfg.a_plane_bits)
        a_range = plane_range(cfg.a_bits, cfg.a_plane_bits)
    w_planes, w_scales = q.group_planes(wq, cfg.w_bits, cfg.w_plane_bits)
    w_range = plane_range(cfg.w_bits, cfg.w_plane_bits)

    # All na*nw plane passes as ONE product of the stacked planes,
    # [na*M, K] @ [K, nw*N]; the 2^(ba*i + bw*j) shift weights (with the
    # MSB signs) are folded in afterwards, in int64.
    na, nw = a_planes.shape[0], w_planes.shape[0]
    out_shape = xq.shape[:-1] + (wq.shape[-1],)
    k, n = xq.shape[-1], wq.shape[-1]
    a2 = a_planes.reshape(-1, k)                               # [na*M, K]
    w2 = w_planes.permute(1, 0, 2).reshape(k, nw * n)          # [K, nw*N]
    parts = exact_product(a2, w2, product_route(k, a_range, w_range))
    if na == 1 and nw == 1:     # LM_8b @ P<=8: one pass, shift == 2^0
        return wrap_int32(parts).reshape(out_shape)
    parts = parts.reshape(na, -1, nw, n)                       # [na, M, nw, N]
    shift = a_scales[:, None].to(torch.int64) * w_scales[None, :].to(torch.int64)
    out = torch.sum(parts * shift[:, None, :, None], dim=(0, 2))
    return wrap_int32(out).reshape(out_shape)


def loom_matmul(x: torch.Tensor, w: torch.Tensor, cfg: LoomConfig,
                w_scale: torch.Tensor | None = None,
                wq: torch.Tensor | None = None) -> torch.Tensor:
    """Quantize -> plane-serial matmul -> dequantize, in x's dtype.

    If (wq, w_scale) are provided the weights are already on the integer
    grid (serving: quantized once, stored bit-packed). Otherwise both
    operands are quantized on the fly (QAT-style forward).
    """
    xq, x_scale = q.quantize(x, cfg.a_bits)
    if wq is None:
        wq, w_scale = q.quantize(w, cfg.w_bits)
    yq = plane_matmul(xq, wq, cfg)
    return (yq.to(torch.float32) * (x_scale * w_scale)).to(x.dtype)


def reference_int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Oracle: the direct integer product of the quantized operands,
    wrapped to int32. Elementwise int64 products summed over K, a block
    of rows at a time (about 256 MiB of products live), on any device: no
    library product, so nothing it shares with :func:`exact_product`."""
    k, n = wq.shape
    x2 = xq.reshape(-1, k).to(torch.int64)
    w = wq.to(torch.int64)
    rows = max(1, (1 << 25) // max(1, k * n))
    out = torch.cat([torch.sum(x2[i:i + rows, :, None] * w, dim=1)
                     for i in range(0, x2.shape[0], rows)])
    return wrap_int32(out).reshape(xq.shape[:-1] + (n,))


def split_k_matmul(xq: torch.Tensor, wq: torch.Tensor, cfg: LoomConfig,
                   n_slices: int) -> torch.Tensor:
    """SIP cascading: slice the reduction dim into ``n_slices`` partial
    inner products computed independently, then reduced -- the paper's
    answer to layers with fewer outputs than SIP lanes (split-K). The
    plane decomposition is elementwise and the partials' reduction is
    K's own order, so it is exactly :func:`plane_matmul`'s product."""
    k = xq.shape[-1]
    if k % n_slices:
        raise ValueError(f"K={k} does not split into {n_slices} slices")
    return plane_matmul(xq, wq, cfg)
