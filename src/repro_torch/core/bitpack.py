"""Bit-interleaved packed weight storage.

PyTorch-port counterpart of ``repro/core/bitpack.py``; the layout is kept
byte for byte, so a tensor packed by either package loads in the other:
uint8 ``[Pw, ceil(K/8), N]``, plane-major, bit i of byte j holds reduction
row 8j+i, K zero-padded to a multiple of 8.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import quantize as q
from repro_torch.core import weightgroups as wg


def pack_bits_along_axis(bits01: torch.Tensor, axis: int) -> torch.Tensor:
    """Pack a {0,1}-valued tensor 8-per-uint8 along ``axis``.

    The axis length must be a multiple of 8. Bit i of byte j holds element
    8*j + i (little-endian within the byte).
    """
    axis = axis % bits01.ndim
    n = bits01.shape[axis]
    if n % 8:
        raise ValueError(f"pack axis length {n} not a multiple of 8")
    shape = list(bits01.shape)
    shape[axis:axis + 1] = [n // 8, 8]
    grouped = bits01.to(torch.int32).reshape(shape)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits01.device)
    bshape = [1] * grouped.ndim
    bshape[axis + 1] = 8
    return torch.sum(grouped * weights.reshape(bshape),
                     dim=axis + 1).to(torch.uint8)


def unpack_bits_along_axis(packed: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of pack_bits_along_axis: uint8 -> {0,1} with 8x axis length."""
    axis = axis % packed.ndim
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bshape = [1] * (packed.ndim + 1)
    bshape[axis + 1] = 8
    bits = torch.bitwise_and(
        packed.unsqueeze(axis + 1) >> shifts.reshape(bshape), 1)
    shape = list(packed.shape)
    shape[axis] = shape[axis] * 8
    return bits.reshape(shape).to(torch.uint8)


# Transient int32 bytes that pack/unpack may hold at a time.
_CHUNK_BYTES = 1 << 28


def by_columns(fn, t: torch.Tensor, bytes_per_column: int,
               multiple: int = 1) -> torch.Tensor:
    """``fn`` over blocks of ``t``'s columns (last axis), concatenated;
    each block sized so that about 256 MiB of intermediates are live, a
    multiple of ``multiple`` columns (a column group never splits). One
    block (one call) for every CNN layer; dozens for an LM head, whose
    planes at once would take tens of GiB."""
    n = t.shape[-1]
    step = max(1, _CHUNK_BYTES // bytes_per_column // multiple) * multiple
    if step >= n:
        return fn(t)
    return torch.cat([fn(t[..., i:i + step]) for i in range(0, n, step)],
                     dim=-1)


def pack_weights(wq: torch.Tensor, bits: int) -> torch.Tensor:
    """Bit-interleave a quantized weight matrix.

    wq: int [K, N] signed 2's-complement values of ``bits`` precision.
    Returns uint8 [bits, ceil(K/8), N]; K not a multiple of 8 is zero-padded
    (zero reduction rows contribute nothing to the product).
    """
    k = wq.shape[0]
    if k % 8:
        wq = F.pad(wq, (0, 0, 0, (-k) % 8))
    # bit_planes: int32 [bits, K8, n] in {0,1}, packed to [bits, K8//8, n].
    return by_columns(
        lambda w: pack_bits_along_axis(q.bit_planes(w, bits), axis=1),
        wq, 8 * bits * wq.shape[0])


@dataclasses.dataclass(frozen=True)
class GroupedWeights:
    """Packed planes + the pack-time per-filter-group precision metadata.

    ``planes`` is exactly :func:`pack_weights`' layout; ``counts`` is the
    OR-tree effective plane count per group of ``group_size`` output
    columns (``weightgroups.weight_group_counts``, the function that
    ``ExecutionPlan.record_weight_groups`` reads back off packed trees, so
    the two cannot drift) and ``plane_weights`` the per-group shift/negate
    table (``weightgroups.group_plane_weights``).
    """

    planes: torch.Tensor         # uint8 [bits, ceil(K/8), N]
    counts: torch.Tensor         # int32 [ceil(N/group_size)]
    plane_weights: torch.Tensor  # int32 [ceil(N/group_size), bits]
    group_size: int
    bits: int


def pack_weights_grouped(wq: torch.Tensor, bits: int,
                         group_size: int = 16) -> GroupedWeights:
    """:func:`pack_weights` plus the per-filter-group plane metadata."""
    counts = wg.weight_group_counts(wq, bits, group_size)
    return GroupedWeights(
        planes=pack_weights(wq, bits), counts=counts,
        plane_weights=wg.group_plane_weights(counts, bits),
        group_size=group_size, bits=bits)


def unpack_weights(packed: torch.Tensor, bits: int,
                   k: int | None = None) -> torch.Tensor:
    """Reconstruct signed int32 [K, N] from the packed plane representation.

    ``k`` trims the zero rows added by pack_weights for K % 8 != 0.
    """
    w = q.plane_weights(bits, packed.device).reshape(bits, 1, 1)

    def unpack(p):
        planes = unpack_bits_along_axis(p, axis=1).to(torch.int32)
        return torch.sum(planes * w, dim=0, dtype=torch.int32)
    out = by_columns(unpack, packed, 64 * bits * packed.shape[1])
    return out if k is None else out[:k]


def packed_nbytes(shape_kn: tuple[int, int], bits: int) -> int:
    """Bytes used by the packed representation, including the zero rows
    pack_weights adds for K % 8 != 0."""
    k, n = shape_kn
    return bits * -(-k // 8) * n


def baseline_nbytes(shape_kn: tuple[int, int], base_bits: int = 16) -> int:
    """Bytes of the bit-parallel baseline store (16-bit by default)."""
    k, n = shape_kn
    return k * n * (base_bits // 8)
