"""K1 and K3: bit-serial matmul over packed planes, as Hopper kernels.

Ports of ``repro/kernels/bitserial_matmul.py::bitserial_matmul`` (K1) and
``::bitserial_matmul_dynamic`` (K3, the same with a plane count per group
of ``bn`` columns). Both kernels are in ``csrc/bitserial_matmul.cu``;
their plain PyTorch versions are the oracles
:func:`repro_torch.kernels.ref.bitserial_matmul_ref` and
:func:`~repro_torch.kernels.ref.bitserial_matmul_dynamic_ref`.

Both run on the int8 tensor cores, one kernel body in one of two shapes,
chosen here by :func:`_route` from M: ``tile`` (128 x 128 output tiles)
above ``SKINNY_MAX_M`` rows, ``skinny`` (16 x 64 tiles, M padded to 16)
at or below it, either one splitting K when its output tiles alone would
leave SMs idle. Neither falls back to the other. K3's kernel loads only
the planes below each tile's largest count and folds every column at its
own count.

``bitserial_matmul.launches`` and ``bitserial_matmul_dynamic.launches``
count each kernel's launches (the plain route on CPU tensors does not
count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    bitserial_matmul_dynamic_ref as bitserial_matmul_dynamic_plain)
from repro_torch.kernels.ref import bitserial_matmul_ref as bitserial_matmul_plain

SKINNY_MAX_M = 16    # rows up to which the skinny route runs
_SMS = 132           # streaming multiprocessors of an H100 SXM


def _route(m: int, k: int, n: int, pw: int) -> tuple[str, int]:
    """K1's and K3's route and K split for an [M, K] x [K, N] call at Pw
    planes (K3's counts change neither): ``("skinny", s)`` for M <=
    SKINNY_MAX_M (16 x 64 output tiles), else ``("tile", s)`` (128 x 128
    by K/128, or 64 x 128 by K/64 at Pw > 8).
    ``s`` splits the reduction tiles over blocks until about two blocks
    per SM are in flight (or every tile has its own block), never leaving
    a split without a tile."""
    route = "skinny" if m <= SKINNY_MAX_M else "tile"
    # bitserial_matmul.cu's Skinny, TileWide and Tile configurations
    bm, bn, bk = ((16, 64, 64) if route == "skinny" else
                  (64, 128, 64) if pw > 8 else (128, 128, 128))
    blocks = -(-m // bm) * -(-n // bn)
    tiles = max(1, -(-k // bk))
    per = max(1, tiles // -(-2 * _SMS // blocks))   # tiles per split
    return route, -(-tiles // per)


@functools.cache
def _launcher(entry: str, n_pointers: int, n_ints: int):
    fn = getattr(_build.load("bitserial_matmul"), entry)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
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


def _launch(entry: str, kernel_fn, x: torch.Tensor, w_packed: torch.Tensor,
            extra: tuple, ints: tuple) -> torch.Tensor:
    """Check the CUDA operands, allocate the output and launch ``entry`` on
    the current stream: (x, w_packed, *extra, out, M, K, N, *ints,
    stream) is the C signature."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, w_packed, *extra)):
        raise ValueError(f"{kernel_fn.__name__} needs contiguous operands")
    m, k = x.shape
    n = w_packed.shape[2]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    if -(-m // 64) > 65535:   # a block row per 64 rows or more
        raise ValueError(f"M={m} exceeds the kernel's grid")
    with torch.cuda.device(x.device):
        err = _launcher(entry, 3 + len(extra), 3 + len(ints))(
            x.data_ptr(), w_packed.data_ptr(), *(t.data_ptr() for t in extra),
            out.data_ptr(), m, k, n, *ints,
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kernel_fn.__name__} launch failed: CUDA error "
                           f"{err}")
    kernel_fn.launches += 1
    return out


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
    route, splits = _route(x.shape[0], x.shape[1], w_packed.shape[2], w_bits)
    return _launch("bitserial_matmul_launch", bitserial_matmul, x, w_packed,
                   (), (w_bits, int(route == "skinny"), splits))


bitserial_matmul.launches = 0


def bitserial_matmul_dynamic(x: torch.Tensor, w_packed: torch.Tensor,
                             counts: torch.Tensor, *, w_bits: int,
                             bn: int) -> torch.Tensor:
    """x: int8 [M, K]; w_packed: uint8 [Pw, K/8, N]; counts: int32
    [ceil(N/bn)], each in [1, Pw] -> int32 [M, N].

    Column group j (columns [j*bn, (j+1)*bn), the last one may be ragged)
    uses only its first counts[j] planes, plane counts[j]-1 negated. A
    CUDA tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor takes the plain version.
    """
    _check(x, w_packed, w_bits)
    n = w_packed.shape[2]
    if bn < 1 or counts.dtype != torch.int32 or \
            tuple(counts.shape) != (-(-n // bn),):
        raise ValueError(f"counts must be int32 [ceil(N/bn)] = "
                         f"[{-(-n // max(bn, 1))}] at bn={bn}, got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if counts.device != x.device:
        raise ValueError(f"x on {x.device}, counts on {counts.device}")
    if x.device.type == "cpu":
        return bitserial_matmul_dynamic_plain(x, w_packed, counts, w_bits, bn)
    route, splits = _route(x.shape[0], x.shape[1], n, w_bits)
    return _launch("bitserial_matmul_dynamic_launch", bitserial_matmul_dynamic,
                   x, w_packed, (counts,),
                   (w_bits, bn, int(route == "skinny"), splits))


bitserial_matmul_dynamic.launches = 0
