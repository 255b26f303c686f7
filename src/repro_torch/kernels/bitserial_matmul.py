"""K1: bit-serial matmul over packed weight planes, as a Hopper kernel.

Port of ``repro/kernels/bitserial_matmul.py::bitserial_matmul``. The
kernel is ``csrc/bitserial_matmul.cu``; its plain PyTorch version is the
oracle :func:`repro_torch.kernels.ref.bitserial_matmul_ref`.

``bitserial_matmul.launches`` counts the kernel's launches (the plain
route on CPU tensors does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitserial_matmul_ref as bitserial_matmul_plain


@functools.cache
def _launcher():
    fn = _build.load("bitserial_matmul").bitserial_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w_packed: torch.Tensor, w_bits: int) -> None:
    if x.dtype != torch.int8 or x.ndim != 2:
        raise TypeError(f"x must be int8 [M, K], got {x.dtype} {tuple(x.shape)}")
    if w_packed.dtype != torch.uint8 or w_packed.ndim != 3:
        raise TypeError(f"w_packed must be uint8 [Pw, K/8, N], got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    pw, k8, _ = w_packed.shape
    if pw != w_bits or not 1 <= w_bits <= 16 or k8 * 8 != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w_packed "
                         f"{tuple(w_packed.shape)} at w_bits={w_bits} "
                         f"do not match")
    if x.device != w_packed.device:
        raise ValueError(f"x on {x.device}, w_packed on {w_packed.device}")


def bitserial_matmul(x: torch.Tensor, w_packed: torch.Tensor, *,
                     w_bits: int) -> torch.Tensor:
    """x: int8 [M, K]; w_packed: uint8 [Pw, K/8, N] -> int32 [M, N].

    Integer-exact: ``x @ unpack(w_packed)``. A CUDA tensor launches the
    kernel on the current stream (no synchronisation); a CPU tensor takes
    the plain version.
    """
    _check(x, w_packed, w_bits)
    if x.device.type == "cpu":
        return bitserial_matmul_plain(x, w_packed, w_bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("bitserial_matmul needs contiguous operands")
    m, k = x.shape
    n = w_packed.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    if -(-m // 64) > 65535:   # one block row per 64 rows (BM)
        raise ValueError(f"M={m} exceeds the kernel's grid")
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), w_packed.data_ptr(), out.data_ptr(),
                          m, k, n, w_bits,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bitserial_matmul launch failed: CUDA error {err}")
    bitserial_matmul.launches += 1
    return out


bitserial_matmul.launches = 0
