"""Backend registry: one object per kernel substrate, one uniform op surface.

PyTorch-port counterpart of ``repro/api/backend.py``. Model code asks its
:class:`~repro_torch.api.plan.LayerPlan` for the backend and calls one of
six ops:

    matmul_planes          static bit-serial matmul over packed planes
    matmul_planes_dynamic  plane-count-gated variant (runtime trimming)
    conv_planes            fused bit-serial convolution
    conv_planes_dynamic    conv with runtime activation-plane trimming
    dynamic_quant          per-group activation quantization
    attention              full-sequence attention

Built-ins:

    torch_ref   the plain PyTorch oracles, on any device
    cuda        the hand-written Hopper kernels (K1-K7); on CPU tensors
                their wrappers take the plain versions. The default.

Pack-time weight-group counts (``w_counts``, Python ints from the plan)
that are all full keep the static kernels (K1, K2); a count below Pw
routes ``matmul_planes`` to K3 with bn = the filter group and
``conv_planes`` to K4. ``dynamic_quant`` runs K6 and ``attention`` K7.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import bitpack, quantize as q
from repro_torch.core.weightgroups import truncate_columns_grouped
from repro_torch.kernels import ref
from repro_torch.kernels.bitserial_conv import (bitserial_conv,
                                                bitserial_conv_dynamic,
                                                bitserial_conv_wgroup)
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                  bitserial_matmul_dynamic)
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.flash_attention import flash_attention


def _trims(w_counts, w_bits: int) -> bool:
    """The all-full-counts guard: only a count below Pw trims anything;
    otherwise the static kernels run."""
    return w_counts is not None and any(c < w_bits for c in w_counts)


@functools.cache
def _counts_tensor(counts: tuple, device: torch.device) -> torch.Tensor:
    """Plan-constant plane counts as int32 on ``device``, made once."""
    return torch.tensor(counts, dtype=torch.int32, device=device)


def dense_weights(w_packed, w_bits: int, w_counts=None, w_group: int = 16):
    """The dense operand of the dynamic ops: the packed weights unpacked to
    int32 [K8, N] and, where a pack-time count lies below Pw, truncated per
    filter group at its count (value-preserving for OR-tree counts; full
    counts truncate nothing)."""
    wq = bitpack.unpack_weights(w_packed, w_bits)
    if _trims(w_counts, w_bits):
        wq = truncate_columns_grouped(
            wq, _counts_tensor(tuple(w_counts), wq.device), w_group)
    return wq


def sum_int8_subplanes(wq, w_bits: int, run):
    """``run`` over Pw-bit weights ``wq`` as an int8 kernel operand:
    ``run(wq)`` for Pw <= 8, else the sum of ``2^(7p) * run(plane_p)``
    over ceil(Pw/7) 7-bit subplanes (an unsigned 8-bit low plane would not
    fit int8). Exact for a ``run`` linear in its weights, in wrap-around
    int32 as the reference accumulates."""
    if w_bits <= 8:
        return run(wq.to(torch.int8))
    planes, _ = q.group_planes(wq, w_bits, 7)
    y = run(planes[0].to(torch.int8))
    for p in range(1, planes.shape[0]):
        y = y + run(planes[p].to(torch.int8)) * (1 << (7 * p))
    return y


class Backend:
    """The ``torch_ref`` backend: plain PyTorch, any device. Also the base
    class of the kernel backends."""

    name = "torch_ref"

    def matmul_planes(self, xq, w_packed, *, w_bits: int, w_counts=None,
                      w_group: int = 16):
        """int8 [M, K] @ packed uint8 [Pw, K//8, N] -> exact int32 [M, N].
        ``w_counts``: pack-time plane counts per group of ``w_group``
        columns."""
        if not _trims(w_counts, w_bits):
            return ref.bitserial_matmul_ref(xq, w_packed, w_bits)
        return ref.bitserial_matmul_wgroup_ref(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device), w_bits,
            w_group)

    def matmul_planes_dynamic(self, xq, w_packed, plane_counts, *,
                              w_bits: int, bn: int):
        """Like matmul_planes, but column group j (``bn`` columns) uses only
        plane_counts[j] planes (int32 tensor on xq's device)."""
        return ref.bitserial_matmul_dynamic_ref(xq, w_packed, plane_counts,
                                                w_bits, bn)

    def conv_planes(self, xq, w_packed, *, kernel: int, stride: int,
                    w_bits: int, conv_tile: int | None = None,
                    w_counts=None, w_group: int = 16):
        """Fused bit-serial "same" conv: int8 [B,H,W,C] x packed planes ->
        exact int32 [B, Ho, Wo, N]. ``conv_tile`` (rows per band) only
        matters to the kernels."""
        if not _trims(w_counts, w_bits):
            return ref.bitserial_conv_ref(xq, w_packed, kernel=kernel,
                                          stride=stride, w_bits=w_bits)
        return ref.bitserial_conv_wgroup_ref(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device),
            kernel=kernel, stride=stride, w_bits=w_bits, w_group=w_group)

    def conv_planes_dynamic(self, xq, w_packed, counts, *, kernel: int,
                            stride: int, w_bits: int, group_size: int,
                            conv_tile: int | None = None, w_counts=None,
                            w_group: int = 16):
        """Like conv_planes, but window group g of image b (``group_size``
        row-major output windows) uses only counts[b, g] activation planes
        (int32 [B, G] on xq's device). ``w_counts`` composes static
        weight-group trimming in by truncating the dense weights."""
        return ref.conv_dynamic_dense_ref(
            xq, dense_weights(w_packed, w_bits, w_counts, w_group), counts,
            kernel=kernel, stride=stride, group_size=group_size)

    def dynamic_quant(self, x2, *, group_size: int, bits: int):
        """f32 [M, K] -> (xq int8 [M, K], scale f32 [M, G], eff_bits int32
        [M, G]) per group of ``group_size`` along K."""
        return ref.dynamic_quant_ref(x2, group_size, bits)

    def attention(self, q_, k_, v_, *, causal: bool = True,
                  window: int | None = None):
        """Full-sequence attention over [B, H, S, D] (KV head-repeated)."""
        return ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                       window=window)


class CudaBackend(Backend):
    """The hand-written Hopper kernels: K1 ``bitserial_matmul``, K2
    ``bitserial_conv``, K3 ``bitserial_matmul_dynamic``, K4
    ``bitserial_conv_wgroup``, K5 ``bitserial_conv_dynamic``, K6
    ``dynamic_quant`` and K7 ``flash_attention``."""

    name = "cuda"

    def matmul_planes(self, xq, w_packed, *, w_bits, w_counts=None,
                      w_group=16):
        if not _trims(w_counts, w_bits):
            return bitserial_matmul(xq, w_packed, w_bits=w_bits)
        return bitserial_matmul_dynamic(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device),
            w_bits=w_bits, bn=w_group)

    def matmul_planes_dynamic(self, xq, w_packed, plane_counts, *, w_bits,
                              bn):
        return bitserial_matmul_dynamic(xq, w_packed, plane_counts,
                                        w_bits=w_bits, bn=bn)

    def conv_planes(self, xq, w_packed, *, kernel, stride, w_bits,
                    conv_tile=None, w_counts=None, w_group=16):
        if not _trims(w_counts, w_bits):
            return bitserial_conv(xq, w_packed, kernel=kernel, stride=stride,
                                  w_bits=w_bits, rows_per_band=conv_tile)
        return bitserial_conv_wgroup(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device),
            kernel=kernel, stride=stride, w_bits=w_bits, w_group=w_group,
            rows_per_band=conv_tile)

    def conv_planes_dynamic(self, xq, w_packed, counts, *, kernel, stride,
                            w_bits, group_size, conv_tile=None, w_counts=None,
                            w_group=16):
        # K5 takes int8 weights: Pw > 8 runs once per 7-bit subplane.
        return sum_int8_subplanes(
            dense_weights(w_packed, w_bits, w_counts, w_group), w_bits,
            lambda plane: bitserial_conv_dynamic(
                xq, plane, counts, kernel=kernel, stride=stride,
                group_size=group_size, rows_per_band=conv_tile))

    def dynamic_quant(self, x2, *, group_size, bits):
        return dynamic_quant(x2, group_size=group_size, bits=bits)

    def attention(self, q_, k_, v_, *, causal=True, window=None):
        return flash_attention(q_, k_, v_, causal=causal, window=window)


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, backend: Backend) -> Backend:
    """Register (or replace) a backend under ``name``."""
    _REGISTRY[name] = backend
    return backend


def resolve_backend(backend=None) -> Backend:
    """A Backend object from a Backend, a registered name, or None (the
    ``cuda`` built-in)."""
    if isinstance(backend, Backend):
        return backend
    if backend is None:
        backend = "cuda"
    if not isinstance(backend, str):
        raise TypeError(f"backend must be a Backend or name, got {backend!r}")
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


register_backend("torch_ref", Backend())
register_backend("cuda", CudaBackend())
