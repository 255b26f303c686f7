"""The work of one kernel call: the bytes it must move and the operations
it must do, and the least time an H100 could take for them.

One formula per kernel (K1-K7), by the kernel's name and its wrapper's
arguments. ``chip_smoke.py``'s bound column and the op analyzer
(:mod:`repro_torch.launch.opanalysis`) both read it, so a kernel counted
by the analyzer has the work its card check is bounded by.

Bytes: each input read once (packed planes only up to the plane counts
that the call's counts need), each output written once. Operations: the
integer kernels one multiply-add (2 operations) per term at the int8
peak; K6 four float32 operations per value (abs, max, divide, round); K7
two multiply-adds per (query, key) pair and dimension, over the pairs
the mask keeps, at the peak of the inputs' type.

The constants are the H100 SXM datasheet's (H100 80GB HBM3 at 700 W),
not measurements: dense tensor-core peaks, HBM3 bandwidth, NVLink within
a node of 8 and 400 Gb/s InfiniBand per card across nodes.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 bandwidth (datasheet)
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
NVLINK_BYTES_PER_S = 450e9    # NVLink 4, per direction, within a node
IB_BYTES_PER_S = 400e9 / 8    # 400 Gb/s InfiniBand per card, across nodes
NODE_CARDS = 8                # cards joined by NVLink in one node

KERNEL_NAMES = {
    "bitserial_matmul": "K1", "bitserial_conv": "K2",
    "bitserial_matmul_dynamic": "K3", "bitserial_conv_wgroup": "K4",
    "bitserial_conv_dynamic": "K5", "dynamic_quant": "K6",
    "flash_attention": "K7"}


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def packed_bytes(wp: torch.Tensor, counts, bn: int) -> int:
    """Bytes of the packed operand that the counts need: column j reads
    min(count, Pw) planes of K/8 bytes. ``counts``: a tensor, or the
    plan's pack-time counts as ints; counts that cannot be read (a fake
    tensor: a traced run holds no data) count every plane."""
    pw, k8, n = wp.shape[-3:]
    if counts is None or (isinstance(counts, torch.Tensor)
                          and _is_fake(counts)):
        return wp.numel()
    if not isinstance(counts, torch.Tensor):
        return sum(min(max(int(c), 1), pw) * min(bn, n - j * bn)
                   for j, c in enumerate(counts) if j * bn < n) * k8
    per_col = torch.repeat_interleave(counts.to(torch.int64).clamp(1, pw),
                                      bn)[:n]
    return int(per_col.sum().item()) * k8


def attention_pairs(s_: int, causal: bool, window) -> int:
    """(query, key) pairs that the mask keeps: row i sees keys
    [max(0, i - w + 1), i] causal, [max(0, i - w + 1), S) otherwise."""
    i = torch.arange(s_, dtype=torch.int64)
    hi = i + 1 if causal else torch.full_like(i, s_)
    lo = (i - window + 1).clamp(min=0) if window is not None else 0 * i
    return int((hi - lo).sum())


def _numel_bytes(out) -> int:
    outs = out if isinstance(out, tuple) else (out,)
    return sum(t.numel() * t.element_size() for t in outs)


def work(name: str, args: tuple, kw: dict, out) -> tuple:
    """(bytes, operations, peak operations/s) of one call of kernel
    ``name`` (its wrapper's name, e.g. ``bitserial_matmul``) on the
    wrapper's ``args`` and ``kw``, with its result ``out``."""
    x = args[0]
    if name == "dynamic_quant":
        return x.numel() * 4 + _numel_bytes(out), 4 * x.numel(), F32_FLOPS
    if name == "flash_attention":
        b, h, s_, d = x.shape
        nbytes = 4 * x.numel() * x.element_size()
        pairs = attention_pairs(s_, kw.get("causal", True), kw.get("window"))
        peak = BF16_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
        return nbytes, 4 * d * pairs * b * h, peak
    if name.startswith("bitserial_matmul"):
        counts = args[2] if name.endswith("dynamic") else None
        nbytes = x.numel() + packed_bytes(args[1], counts, kw.get("bn", 1))
        depth = x.shape[1]
    else:
        depth = kw["kernel"] ** 2 * x.shape[3]
        if name == "bitserial_conv_dynamic":
            nbytes = x.numel() + args[1].numel()
        else:
            counts = args[2] if name == "bitserial_conv_wgroup" else None
            nbytes = x.numel() + packed_bytes(args[1], counts,
                                              kw.get("w_group", 16))
    if len(args) > 2:                                  # the counts
        c = args[2]
        nbytes += (c.numel() if isinstance(c, torch.Tensor) else len(c)) * 4
    return nbytes + out.numel() * 4, 2 * out.numel() * depth, INT8_OPS_PER_S


def bound_s(nbytes: float, ops: float, peak: float) -> tuple:
    """(seconds, "bytes" or "operations"): the larger of the bytes over
    HBM3's rate and the operations over their peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / peak
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
