"""K7: online-softmax (flash) attention, as a Hopper kernel.

Port of ``repro/kernels/flash_attention.py::flash_attention``: causal
attention over [B, H, S, D] with an optional sliding window, the KV tiles
outside the causal and window bounds never visited. The kernel is
``csrc/flash_attention.cu``; its plain PyTorch version is the oracle
:func:`repro_torch.kernels.ref.flash_attention_ref`, which materializes the
[B, H, S, S] logits. The two are held to a tolerance, not bit for bit: the
kernel sums in another order, scales the scores by ``scale * log2(e)`` and
exponentiates base 2, and for bf16 inputs keeps the logits in float32
where the oracle rounds its bf16 product first.

``flash_attention.launches`` counts the kernel's launches (the plain route
on CPU tensors does not count).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

MAX_HEAD_DIM = 256


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q, k, v: [B, H, S, D], one head count (repeat KV upstream for GQA),
    float32 or bf16, D <= 256 -> [B, H, S, D] in q's dtype. ``window``:
    keys in (i - window, i]. ``scale`` defaults to ``D ** -0.5``.

    A CUDA tensor launches the kernel on the current stream (no
    synchronisation); a CPU tensor takes the plain version.
    """
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must be one of float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window={window} must be >= 1 or None")
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention needs contiguous q, k, v")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b * h, s, d, float(scale),
                          int(causal), window or 0,
                          int(q.dtype == torch.bfloat16),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
