"""K2, K4 and K5: fused bit-serial "same" convolutions, as Hopper kernels.

Ports of ``repro/kernels/bitserial_conv.py``: ``bitserial_conv`` (K2,
packed weight planes), ``bitserial_conv_wgroup`` (K4, a weight plane count
per filter group) and ``bitserial_conv_dynamic`` (K5, dense int8 weights
and an activation plane count per window group). The three kernels are
one template in ``csrc/bitserial_conv.cu``; their plain PyTorch versions
are the oracles :func:`repro_torch.kernels.ref.bitserial_conv_ref`,
:func:`~repro_torch.kernels.ref.bitserial_conv_wgroup_ref` and
:func:`~repro_torch.kernels.ref.conv_dynamic_dense_ref`.

Each block stages one band of input rows (the halo included) in shared
memory and gathers its patches from there, so no patch tensor reaches
device memory. :func:`conv_smem_bytes` is the block's shared-memory
footprint, the counterpart of the TPU kernel's ``conv_vmem_bytes``; the
plan sizes ``rows_per_band`` so that it fits :data:`SMEM_BUDGET`. K5 bands
the same way (the reference's K5 aligns its bands to the window groups;
here each pixel looks its group up, so any band is exact).

``bitserial_conv.launches``, ``bitserial_conv_wgroup.launches`` and
``bitserial_conv_dynamic.launches`` count each kernel's launches (the
plain route on CPU tensors does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitserial_conv_ref as bitserial_conv_plain
from repro_torch.kernels.ref import (
    bitserial_conv_wgroup_ref as bitserial_conv_wgroup_plain)
from repro_torch.kernels.ref import (
    conv_dynamic_dense_ref as bitserial_conv_dynamic_plain)

# Shared memory one H100 thread block can use (bytes, static + dynamic).
SMEM_BUDGET = 232_448

# The kernels' static shared memory, K5's (the largest): the int8 [64][36]
# activation tile, the int32 [32][32] weight tile, the 64 + 32 int offsets
# and K5's 64 window counts (csrc/bitserial_tile.cuh, csrc/bitserial_conv.cu).
_STATIC_SMEM = 64 * 36 + 32 * 32 * 4 + (64 + 32 + 64) * 4


def band_geometry(ho: int, wo: int, rows_per_band: int | None, kernel: int,
                  stride: int) -> tuple[int, int, int]:
    """(rows_per_band, n_bands, band_input_rows) of the banded grid.

    ``rows_per_band=None`` means one band covering the whole map; values
    are clamped to [1, Ho]."""
    rpb = ho if rows_per_band is None else max(1, min(rows_per_band, ho))
    return rpb, -(-ho // rpb), (rpb - 1) * stride + kernel


def conv_smem_bytes(h: int, w: int, c: int, *, kernel: int, stride: int = 1,
                    rows_per_band: int | None = None) -> int:
    """Shared memory (bytes) of one block of the banded kernels: the staged
    int8 input band, ((rpb-1)*stride + k) rows of (W + 2*(k//2)) * C, plus
    the fixed tiles. The output channels, Pw and the plane counts do not
    change it: the weights pass chunk by chunk through the fixed tile."""
    ho, wo = -(-h // stride), -(-w // stride)
    _, _, band_rows = band_geometry(ho, wo, rows_per_band, kernel, stride)
    return band_rows * (w + 2 * (kernel // 2)) * c + _STATIC_SMEM


@functools.cache
def _launcher(entry: str, n_pointers: int, n_ints: int):
    fn = getattr(_build.load("bitserial_conv"), entry)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, kernel: int, stride: int) -> None:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"x must be int8 NHWC [B, H, W, C], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if kernel % 2 != 1 or stride < 1:
        raise ValueError(f"odd kernels and stride >= 1 only, got k={kernel}, "
                         f"stride={stride}")


def _check_packed(x: torch.Tensor, w_packed: torch.Tensor, kernel: int,
                  stride: int, w_bits: int) -> None:
    _check(x, kernel, stride)
    if w_packed.dtype != torch.uint8 or w_packed.ndim != 3:
        raise TypeError(f"w_packed must be uint8 [Pw, ceil(k*k*C/8), N], got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    pw, k8, _ = w_packed.shape
    kkc = kernel * kernel * x.shape[3]
    if pw != w_bits or not 1 <= w_bits <= 16 or k8 != -(-kkc // 8):
        raise ValueError(f"x {tuple(x.shape)} and w_packed "
                         f"{tuple(w_packed.shape)} at k={kernel}, "
                         f"w_bits={w_bits} do not match")
    if x.device != w_packed.device:
        raise ValueError(f"x on {x.device}, w_packed on {w_packed.device}")


def _check_counts(counts: torch.Tensor, shape: tuple, x: torch.Tensor) -> None:
    if counts.dtype != torch.int32 or tuple(counts.shape) != shape:
        raise ValueError(f"counts must be int32 {list(shape)}, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if counts.device != x.device:
        raise ValueError(f"x on {x.device}, counts on {counts.device}")


def _launch(entry: str, kernel_fn, x: torch.Tensor, pointers: tuple, n: int,
            ints: tuple, *, kernel: int, stride: int,
            rows_per_band: int | None) -> torch.Tensor:
    """Check the CUDA operands, allocate the output and launch ``entry`` on
    the current stream. ``ints`` is (head, tail) of the C signature
    (x, *pointers, out, B, H, W, C, N, k, stride, *head, rows_per_band,
    *tail, stream)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, *pointers)):
        raise ValueError(f"{kernel_fn.__name__} needs contiguous operands")
    b, h, w, c = x.shape
    ho, wo = -(-h // stride), -(-w // stride)
    rpb, nb, _ = band_geometry(ho, wo, rows_per_band, kernel, stride)
    smem = conv_smem_bytes(h, w, c, kernel=kernel, stride=stride,
                           rows_per_band=rpb)
    if smem > SMEM_BUDGET:
        raise ValueError(f"a band of {rpb} output rows needs {smem} bytes of "
                         f"shared memory > {SMEM_BUDGET}")
    if nb > 65535 or b > 65535:
        raise ValueError(f"{nb} bands x {b} images exceed the kernel's grid")
    out = torch.empty((b, ho, wo, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    head, tail = ints
    with torch.cuda.device(x.device):
        err = _launcher(entry, 2 + len(pointers), 8 + len(head) + len(tail))(
            x.data_ptr(), *(t.data_ptr() for t in pointers), out.data_ptr(),
            b, h, w, c, n, kernel, stride, *head, rpb, *tail,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel_fn.__name__} launch failed: CUDA error "
                           f"{err}")
    kernel_fn.launches += 1
    return out


def bitserial_conv(x: torch.Tensor, w_packed: torch.Tensor, *, kernel: int,
                   stride: int = 1, w_bits: int,
                   rows_per_band: int | None = None) -> torch.Tensor:
    """x: int8 [B, H, W, C]; w_packed: uint8 [Pw, ceil(k*k*C/8), N] ->
    int32 [B, ceil(H/stride), ceil(W/stride), N], integer-exact.

    ``rows_per_band`` (None = the whole map) cuts the output rows into
    bands, one block row per band; it never changes the result. A CUDA
    tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor takes the plain version.
    """
    _check_packed(x, w_packed, kernel, stride, w_bits)
    if x.device.type == "cpu":
        return bitserial_conv_plain(x, w_packed, kernel=kernel, stride=stride,
                                    w_bits=w_bits)
    return _launch("bitserial_conv_launch", bitserial_conv, x, (w_packed,),
                   w_packed.shape[2], ((w_bits,), ()), kernel=kernel,
                   stride=stride, rows_per_band=rows_per_band)


def bitserial_conv_wgroup(x: torch.Tensor, w_packed: torch.Tensor,
                          counts: torch.Tensor, *, kernel: int,
                          stride: int = 1, w_bits: int, w_group: int = 16,
                          rows_per_band: int | None = None) -> torch.Tensor:
    """:func:`bitserial_conv` with static weight-group trimming: filter
    group g (output channels [g*w_group, (g+1)*w_group), the last one may
    be ragged) uses only its first counts[g] weight planes, plane
    counts[g]-1 negated. counts: int32 [ceil(N/w_group)], each in [1, Pw]
    (the pack-time OR-tree counts keep the result equal to the untrimmed
    conv). Same devices and banding as :func:`bitserial_conv`.
    """
    _check_packed(x, w_packed, kernel, stride, w_bits)
    n = w_packed.shape[2]
    if w_group < 1:
        raise ValueError(f"w_group must be >= 1, got {w_group}")
    _check_counts(counts, (-(-n // w_group),), x)
    if x.device.type == "cpu":
        return bitserial_conv_wgroup_plain(x, w_packed, counts, kernel=kernel,
                                           stride=stride, w_bits=w_bits,
                                           w_group=w_group)
    return _launch("bitserial_conv_wgroup_launch", bitserial_conv_wgroup, x,
                   (w_packed, counts), n, ((w_bits,), (w_group,)),
                   kernel=kernel, stride=stride, rows_per_band=rows_per_band)


def bitserial_conv_dynamic(x: torch.Tensor, wq: torch.Tensor,
                           counts: torch.Tensor, *, kernel: int,
                           stride: int = 1, group_size: int = 256,
                           rows_per_band: int | None = None) -> torch.Tensor:
    """"Same" conv with runtime activation-plane trimming.

    x: int8 [B, H, W, C]; wq: int8 [K8, N], the dense weights (or one int8
    subplane of them) zero-padded to K8 = ceil(k*k*C/8)*8 rows; counts:
    int32 [B, ceil(Ho*Wo/group_size)], each in [1, 8]. Window p (row-major
    over Ho x Wo) of image b uses only the first counts[b, p // group_size]
    activation planes, plane count-1 negated. Returns int32 [B, Ho, Wo, N].
    Same devices and banding as :func:`bitserial_conv`.
    """
    _check(x, kernel, stride)
    kkc = kernel * kernel * x.shape[3]
    if wq.dtype != torch.int8 or wq.ndim != 2 or \
            wq.shape[0] != -(-kkc // 8) * 8:
        raise TypeError(f"wq must be int8 [{-(-kkc // 8) * 8}, N] at "
                        f"k={kernel}, C={x.shape[3]}, got {wq.dtype} "
                        f"{tuple(wq.shape)}")
    if x.device != wq.device:
        raise ValueError(f"x on {x.device}, wq on {wq.device}")
    b, h, w, _ = x.shape
    nwin = -(-h // stride) * -(-w // stride)
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    ngroups = -(-nwin // group_size)
    _check_counts(counts, (b, ngroups), x)
    if x.device.type == "cpu":
        return bitserial_conv_dynamic_plain(x, wq, counts, kernel=kernel,
                                            stride=stride,
                                            group_size=group_size)
    return _launch("bitserial_conv_dynamic_launch", bitserial_conv_dynamic, x,
                   (wq, counts), wq.shape[1], ((), (group_size, ngroups)),
                   kernel=kernel, stride=stride, rows_per_band=rows_per_band)


bitserial_conv.launches = 0
bitserial_conv_wgroup.launches = 0
bitserial_conv_dynamic.launches = 0
