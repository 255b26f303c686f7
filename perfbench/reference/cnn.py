"""The plain reference of a CNN of convs and fcs (VGG-19,
``configs/vgg19.json``) as it is served at (Pa, Pw): the published layer
order ("same" convs, each with ReLU and, where the file says, a max-pool;
then the fcs, ReLU between them), every conv and fc an integer product of
quantized operands.

Each conv's input is quantized under one scale for the whole request,
each fc's under one scale per image; every weight under one scale per
tensor. Activations are NHWC and the last map is flattened in (h, w, c)
order; a conv weight [k*k*C, N] holds its rows in (di, dj, c) order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import quant


def conv_counts(xq: torch.Tensor, kernel: int, stride: int, group: int,
                bits: int) -> torch.Tensor:
    """The activation planes each group of ``group`` output windows of
    one image needs (row-major windows; the last group may be short):
    the signed bits of the largest magnitude any of its windows reads,
    at most ``bits``. xq [B, H, W, C] integer-valued -> int [B, G]."""
    mag = xq.abs().amax(dim=3)[:, None]
    win = F.max_pool2d(mag, kernel, stride, padding=kernel // 2)
    flat = win.reshape(win.shape[0], -1)
    pad = (-flat.shape[1]) % group
    flat = F.pad(flat, (0, pad)).reshape(flat.shape[0], -1, group)
    return needed_bits(flat.amax(-1), bits)


def row_counts(xq: torch.Tensor, group: int, bits: int) -> torch.Tensor:
    """The activation planes each group of ``group`` rows of xq [M, K]
    needs (a batch below ``group`` rows is one group)."""
    m = xq.shape[0]
    g = min(group, -(-m // 8) * 8)
    pad = (-m) % g
    rows = F.pad(xq.abs().amax(-1), (0, pad)).reshape(-1, g)
    return needed_bits(rows.amax(-1), bits)


def needed_bits(mag: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed bits that hold magnitude ``mag``: ceil(log2(mag + 1)) + 1,
    at most ``bits``."""
    nb = torch.ceil(torch.log2(mag.to(torch.float32) + 1.0)) + 1
    return torch.clamp(nb, max=bits).to(torch.int64)


def forward(params: dict, cfg: dict, x: torch.Tensor, a_bits: int,
            w_bits: int, stats: dict | None = None) -> torch.Tensor:
    """x [B, H, W, C] float32 -> logits float32 [B, n_classes]. With
    ``stats`` (a dict), adds the activation planes that dynamic trimming
    runs in groups of ``cfg["trim_group"]`` (``"planes"``) beside the
    static planes of the same groups (``"static_planes"``)."""
    for conv in cfg["convs"]:
        k, stride = conv["kernel"], conv["stride"]
        xq, xs = quant.quantize(x, a_bits, per_row=False)
        w = params[conv["name"]]["w"]
        wq, ws = quant.quantize_weight(w, w_bits)
        if stats is not None:
            c = conv_counts(xq, k, stride, cfg["trim_group"], a_bits)
            _add(stats, c, a_bits)
        w4 = wq.reshape(k, k, x.shape[-1], -1).permute(3, 2, 0, 1)
        y = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64),
                     w4.to(torch.float64), stride=stride, padding=k // 2)
        y = y.permute(0, 2, 3, 1).to(torch.float32) * (xs * ws)
        y = torch.relu(y)
        p = conv["pool"]
        if p > 1:
            b, h, w_, ch = y.shape
            y = y.reshape(b, h // p, p, w_ // p, p, ch).amax(dim=(2, 4))
        x = y
    x = x.reshape(x.shape[0], -1)
    names = [f"fc{i}" for i in range(len(cfg["fcs"]))]
    for i, name in enumerate(names):
        if stats is not None:
            xq, _ = quant.quantize(x, a_bits, per_row=True)
            _add(stats, row_counts(xq, cfg["trim_group"], a_bits), a_bits)
        x = quant.loom_linear(x, params[name]["w"], a_bits, w_bits)
        if i < len(names) - 1:
            x = torch.relu(x)
    return x


def _add(stats: dict, counts: torch.Tensor, bits: int) -> None:
    stats["planes"] = stats.get("planes", 0) + int(counts.sum())
    stats["static_planes"] = stats.get("static_planes", 0) \
        + counts.numel() * bits
