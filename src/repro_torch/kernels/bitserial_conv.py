"""K2: fused bit-serial "same" convolution over packed weight planes, as a
Hopper kernel.

Port of ``repro/kernels/bitserial_conv.py::bitserial_conv``. The kernel is
``csrc/bitserial_conv.cu``; its plain PyTorch version is the oracle
:func:`repro_torch.kernels.ref.bitserial_conv_ref`.

Each block stages one band of input rows (the halo included) in shared
memory and gathers its patches from there, so no patch tensor reaches
device memory. :func:`conv_smem_bytes` is the block's shared-memory
footprint, the counterpart of the TPU kernel's ``conv_vmem_bytes``; the
plan sizes ``rows_per_band`` so that it fits :data:`SMEM_BUDGET`.

``bitserial_conv.launches`` counts the kernel's launches (the plain route
on CPU tensors does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitserial_conv_ref as bitserial_conv_plain

# Shared memory one H100 thread block can use (bytes, static + dynamic).
SMEM_BUDGET = 232_448

# The kernel's static shared memory: the int8 [64][36] activation tile,
# the int32 [32][32] folded weight tile and the 64 + 32 int offsets
# (csrc/bitserial_tile.cuh, csrc/bitserial_conv.cu).
_STATIC_SMEM = 64 * 36 + 32 * 32 * 4 + (64 + 32) * 4


def band_geometry(ho: int, wo: int, rows_per_band: int | None, kernel: int,
                  stride: int) -> tuple[int, int, int]:
    """(rows_per_band, n_bands, band_input_rows) of the banded grid.

    ``rows_per_band=None`` means one band covering the whole map; values
    are clamped to [1, Ho]."""
    rpb = ho if rows_per_band is None else max(1, min(rows_per_band, ho))
    return rpb, -(-ho // rpb), (rpb - 1) * stride + kernel


def conv_smem_bytes(h: int, w: int, c: int, *, kernel: int, stride: int = 1,
                    rows_per_band: int | None = None) -> int:
    """Shared memory (bytes) of one block of the banded kernel: the staged
    int8 input band, ((rpb-1)*stride + k) rows of (W + 2*(k//2)) * C, plus
    the fixed tiles. The output channels and Pw do not change it: the
    weights are folded chunk by chunk into the fixed weight tile."""
    ho, wo = -(-h // stride), -(-w // stride)
    _, _, band_rows = band_geometry(ho, wo, rows_per_band, kernel, stride)
    return band_rows * (w + 2 * (kernel // 2)) * c + _STATIC_SMEM


@functools.cache
def _launcher():
    fn = _build.load("bitserial_conv").bitserial_conv_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w_packed: torch.Tensor, kernel: int, stride: int,
           w_bits: int) -> None:
    if x.dtype != torch.int8 or x.ndim != 4:
        raise TypeError(f"x must be int8 NHWC [B, H, W, C], got {x.dtype} "
                        f"{tuple(x.shape)}")
    if w_packed.dtype != torch.uint8 or w_packed.ndim != 3:
        raise TypeError(f"w_packed must be uint8 [Pw, ceil(k*k*C/8), N], got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    if kernel % 2 != 1 or stride < 1:
        raise ValueError(f"odd kernels and stride >= 1 only, got k={kernel}, "
                         f"stride={stride}")
    pw, k8, _ = w_packed.shape
    kkc = kernel * kernel * x.shape[3]
    if pw != w_bits or not 1 <= w_bits <= 16 or k8 != -(-kkc // 8):
        raise ValueError(f"x {tuple(x.shape)} and w_packed "
                         f"{tuple(w_packed.shape)} at k={kernel}, "
                         f"w_bits={w_bits} do not match")
    if x.device != w_packed.device:
        raise ValueError(f"x on {x.device}, w_packed on {w_packed.device}")


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
    _check(x, w_packed, kernel, stride, w_bits)
    if x.device.type == "cpu":
        return bitserial_conv_plain(x, w_packed, kernel=kernel, stride=stride,
                                    w_bits=w_bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("bitserial_conv needs contiguous operands")
    b, h, w, c = x.shape
    n = w_packed.shape[2]
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
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), w_packed.data_ptr(), out.data_ptr(),
                          b, h, w, c, n, kernel, stride, w_bits, rpb,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bitserial_conv launch failed: CUDA error {err}")
    bitserial_conv.launches += 1
    return out


bitserial_conv.launches = 0
