"""The paper's own model family: a CNN with CVLs + FCLs via Loom.

PyTorch-port counterpart of ``repro/models/cnn.py``. Activations are NHWC
throughout: the last conv's map is flattened in (h, w, c) order into
fc0's inputs, exactly as the reference flattens it, so the two packages
read the same fc0 weights the same way. A plan built with
``conv_route="im2col"`` runs each conv as a linear on its patch tensor
(the reference's A/B route, through the conv's linear twin), bit for bit
the fused conv's result on the serving routes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.api.plan import ExecutionPlan
from repro_torch.models import layers as L
from repro_torch.runtime import tracing


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    out_ch: int
    kernel: int
    stride: int = 1
    pool: int = 1          # max-pool window after the conv (1 = none)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    in_ch: int = 3
    img: int = 32
    convs: tuple = (
        ConvSpec("conv1", 32, 3, pool=2),
        ConvSpec("conv2", 64, 3, pool=2),
        ConvSpec("conv3", 128, 3, pool=2),
    )
    fcs: tuple = (256, 10)

    @property
    def layer_names(self):
        return tuple(c.name for c in self.convs) + tuple(
            f"fc{i}" for i in range(len(self.fcs)))


def init_params(cfg: CNNConfig, generator: torch.Generator | None = None,
                device="cpu", dtype=torch.float32) -> dict:
    """Dense params ``{layer: {"w": [d_in, d_out]}}`` drawn on the CPU
    from ``generator`` (seed 0 when None), then moved to ``device``, so a
    seed gives the same weights on every device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {}
    ch, side = cfg.in_ch, cfg.img
    for c in cfg.convs:
        params[c.name] = L.linear_init(c.kernel * c.kernel * ch, c.out_ch,
                                       generator, dtype)
        ch = c.out_ch
        side = side // c.stride // c.pool
    d_in = ch * side * side
    for i, width in enumerate(cfg.fcs):
        params[f"fc{i}"] = L.linear_init(d_in, width, generator, dtype)
        d_in = width
    return {name: {k: v.to(device) for k, v in p.items()}
            for name, p in params.items()}


def param_specs(cfg: CNNConfig) -> dict:
    """Logical specs of :func:`init_params`'s tree: every layer
    replicated (the reference serves no CNN on a mesh)."""
    names = [c.name for c in cfg.convs] + [f"fc{i}"
                                           for i in range(len(cfg.fcs))]
    return {name: L.linear_specs() for name in names}


def _im2col(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """x: [B, H, W, C] -> "same"-padded patches [B, Ho, Wo, k*k*C], features
    in the (di, dj, c) order of the weight rows."""
    _, h, w, _ = x.shape
    pad = kernel // 2
    x = F.pad(x, (0, 0, pad, pad, pad, pad))
    return torch.cat([x[:, di:di + h:stride, dj:dj + w:stride, :]
                      for di in range(kernel) for dj in range(kernel)],
                     dim=-1)


def forward(params: dict, cfg: CNNConfig, x: torch.Tensor,
            plan: ExecutionPlan, collect_activations: bool = False):
    """x: [B, H, W, C] float -> logits [B, n_classes]; with
    ``collect_activations``, (logits, {layer: its input}) -- the live
    activations the profiler measures (no extra operator either way)."""
    acts = {}
    for c in cfg.convs:
        if collect_activations:
            acts[c.name] = x
        lp = plan.layer(c.name, kind="conv", kernel=c.kernel,
                        stride=c.stride)
        if lp.conv_route == "fused":
            y = L.conv_apply(params[c.name], x, c.kernel, c.stride, plan,
                             c.name)
        else:    # the im2col A/B route: the conv as a linear on patches
            y = L.linear_apply(params[c.name], _im2col(x, c.kernel,
                                                       c.stride),
                               plan, c.name)
        with tracing.span("cnn.relu_pool"):
            y = torch.relu(y)
            if c.pool > 1:
                b, h, w, ch = y.shape
                y = y.reshape(b, h // c.pool, c.pool, w // c.pool, c.pool,
                              ch)
                y = torch.amax(y, dim=(2, 4))   # the SIP max comparator
        x = y
    x = x.reshape(x.shape[0], -1)
    for i in range(len(cfg.fcs)):
        if collect_activations:
            acts[f"fc{i}"] = x
        x = L.linear_apply(params[f"fc{i}"], x, plan, f"fc{i}")
        if i < len(cfg.fcs) - 1:
            x = torch.relu(x)
    if collect_activations:
        return x, acts
    return x
