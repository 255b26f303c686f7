"""Batch classification requests: each request holds ``images`` images of
``image_size`` x ``image_size`` x ``in_channels`` (NHWC float32).

An image is a smooth random field: a ``field`` x ``field`` x C Gaussian
grid upsampled bilinearly to the image size, scaled by the image's own
brightness. Every request holds the same set of brightnesses, log-uniform
over ``brightness`` at evenly spaced quantiles, in an order of its own, so
every seed asks for the same work in another arrangement. ``bank``
distinct requests are made in set-up, on the device, and sent in turn.

Parameters (the workload file's ``traffic``): ``images``, ``field``,
``brightness`` [low, high], ``bank``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench import weights


def stratified_log_uniform(n: int, low: float, high: float) -> torch.Tensor:
    """``n`` values of a log-uniform law over [low, high] at the quantiles
    (i + 0.5) / n."""
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    return torch.exp(math.log(low) + q * (math.log(high) - math.log(low)))


def make(params: dict, cfg: dict, seed: int, device) -> list:
    """The bank of requests: a list of float32 [images, H, W, C] tensors
    on ``device``."""
    n, side, ch = params["images"], cfg["image_size"], cfg["in_channels"]
    g = weights.generator(seed, "images", device)
    levels = stratified_log_uniform(n, *params["brightness"]).to(
        torch.float32).to(device)
    bank = []
    for _ in range(params["bank"]):
        grid = torch.randn((n, ch, params["field"], params["field"]),
                           generator=g, device=device)
        img = F.interpolate(grid, size=(side, side), mode="bilinear",
                            align_corners=False)
        order = torch.randperm(n, generator=g, device=device)
        img = img * levels[order][:, None, None, None]
        bank.append(img.permute(0, 2, 3, 1).contiguous())
    return bank
