"""K6: per-group dynamic activation quantization, as a Hopper kernel.

Port of ``repro/kernels/dynamic_quant.py::dynamic_quant``: per group of
``group_size`` values along K, the absmax (the OR-tree), the scale, the
int8 values and the effective bits (the leading-one detector). The kernel
is ``csrc/dynamic_quant.cu``; its plain PyTorch version is the oracle
:func:`repro_torch.kernels.ref.dynamic_quant_ref`, which it equals bit for
bit, subnormal flushing included.

``dynamic_quant.launches`` counts the kernel's launches (the plain route
on CPU tensors does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dynamic_quant_ref as dynamic_quant_plain


@functools.cache
def _launcher():
    fn = _build.load("dynamic_quant").dynamic_quant_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dynamic_quant(x: torch.Tensor, *, group_size: int = 256, bits: int = 8):
    """x: f32 [M, K] -> (xq int8 [M, K], scale f32 [M, G], eff_bits int32
    [M, G]), G = K // group_size; any M.

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor takes the plain version.
    """
    if x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError(f"x must be float32 [M, K], got {x.dtype} "
                        f"{tuple(x.shape)}")
    m, k = x.shape
    if group_size < 1 or k % group_size:
        raise ValueError(f"K={k} is not a multiple of group_size={group_size}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits={bits} outside [2, 8]")
    if x.device.type == "cpu":
        return dynamic_quant_plain(x, group_size, bits)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("dynamic_quant needs a contiguous x")
    g = k // group_size
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    scale = torch.empty((m, g), dtype=torch.float32, device=x.device)
    eff = torch.empty((m, g), dtype=torch.int32, device=x.device)
    if xq.numel() == 0:
        return xq, scale, eff
    with torch.cuda.device(x.device):
        err = _launcher()(x.data_ptr(), xq.data_ptr(), scale.data_ptr(),
                          eff.data_ptr(), m, k, group_size, bits,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"dynamic_quant launch failed: CUDA error {err}")
    dynamic_quant.launches += 1
    return xq, scale, eff


dynamic_quant.launches = 0
