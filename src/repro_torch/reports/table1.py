"""Paper Table 1 methodology, run LIVE: Judd-style per-layer precision
profiling on the paper_cnn example (the paper's networks are ImageNet-scale;
the method -- not the exact numbers -- is what reproduces here), plus the
dynamic per-group activation-precision statistics of Lascorz et al. that
drive Loom's runtime trimming.

PyTorch-port counterpart of ``benchmarks/table1.py``: the same smoke
config, images, metric, tolerance and group, on ``device`` (the card
unless the caller asks for the CPU). Run:
``python -m repro_torch.reports table1 [--device cpu]``.

The forwards run in float64 (the script's in float32). At the 16-bit
ceiling of random weights the metric is a relative distortion of about
1e-4, and in float32 the order a device sums its products in moves it by
up to a few percent (a sum that lands on the other side of a 16-bit grid
step): the card and the CPU then keep different widths from the same
weights (the smoke CNN's conv1 activations: 16 bits against 15). In
float64 that order moves the sums by about 1e-16 of their size, orders
of magnitude inside every decision's margin, so the profile is the
weights' and the method's on every device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api.plan import build_plan
from repro_torch.core import dynamic, profiler, quantize as q
from repro_torch.examples import resolve_device
from repro_torch.interop import params_from_numpy
from repro_torch.models import cnn

BATCH = 8            # images, from numpy seed 0
TOLERANCE = 0.02     # of the 16-bit metric
MIN_BITS = 2
GROUP = 256          # values per dynamic-precision group
DTYPE = torch.float64  # the forwards' dtype (module docstring)


def images(cfg, device) -> torch.Tensor:
    """The script's BATCH images: float64 normals from numpy seed 0, as
    float32."""
    x = np.random.default_rng(0).normal(size=(BATCH, cfg.img, cfg.img, 3))
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def operands(params=None, x=None, device="cuda") -> tuple:
    """(params, config, images) on ``device`` in DTYPE, as ``cnn.forward``
    and :func:`metric` take them. ``params`` (a dense tree, numpy or
    torch) defaults to ``cnn.init_params`` from torch seed 0; ``x`` to
    :func:`images`."""
    device = resolve_device(device)
    cfg = configs.get("paper_cnn", smoke=True)
    if params is None:
        params = cnn.init_params(cfg, torch.Generator().manual_seed(0),
                                 device)
    params = {layer: {k: t.to(DTYPE) for k, t in leaves.items()}
              for layer, leaves in params_from_numpy(params, device).items()}
    x = images(cfg, device) if x is None else torch.as_tensor(
        x, dtype=torch.float32, device=device)
    return params, cfg, x.to(DTYPE)


def metric(params, cfg, x):
    """The search's ``eval_fn``: the negative relative distortion of a
    ``fake_quant`` forward's logits against the ``dense`` ones."""
    base = cnn.forward(params, cfg, x, build_plan(cfg, mode="dense"))

    def eval_fn(pol) -> float:
        lg = cnn.forward(params, cfg, x,
                         build_plan(cfg, pol, mode="fake_quant"))
        return float(-(torch.linalg.norm(lg - base)
                       / torch.linalg.norm(base)))
    return eval_fn


@torch.inference_mode()
def rows(params=None, x=None, device="cuda") -> dict:
    """The profiles and the dynamic statistics on ``device``: {"layers",
    "a_bits", "w_bits": {layer: bits}, "dynamic": {layer: {"static_bits",
    "mean_effective_bits", "plane_fraction_executed"}}, "device"}, from
    :func:`operands`."""
    params, cfg, x = operands(params, x, device)
    eval_fn = metric(params, cfg, x)
    names = cfg.layer_names
    prof_a = profiler.profile_layer_precisions(
        eval_fn, names, tolerance=TOLERANCE, what="a_bits", min_bits=MIN_BITS)
    prof_w = profiler.profile_layer_precisions(
        eval_fn, names, tolerance=TOLERANCE, what="w_bits", min_bits=MIN_BITS)

    # dynamic per-group trimming stats (Lascorz et al.) on live activations
    _, acts = cnn.forward(params, cfg, x, build_plan(cfg, mode="dense"),
                          collect_activations=True)
    dyn = {}
    for name in names:
        a = acts[name].reshape(-1)
        n = (a.shape[0] // GROUP) * GROUP
        if n == 0:
            continue
        xq, _ = q.quantize(a[:n].to(torch.float32), prof_a[name])
        stats = dynamic.dynamic_stats(xq.reshape(-1, GROUP), prof_a[name],
                                      GROUP)
        dyn[name] = {"static_bits": prof_a[name],
                     "mean_effective_bits": float(
                         stats["mean_effective_bits"]),
                     "plane_fraction_executed": float(
                         stats["plane_fraction_executed"])}
    return {"layers": list(names), "a_bits": prof_a, "w_bits": prof_w,
            "dynamic": dyn, "device": str(x.device)}


def dynamic_line(name: str, d: dict) -> str:
    return (f"    {name:8s} static {d['static_bits']:2d}b -> dynamic mean "
            f"{d['mean_effective_bits']:4.2f}b "
            f"(x{d['plane_fraction_executed']:.2f} planes run)")


def lines(r: dict) -> list:
    """The script's printed lines for :func:`rows`' result."""
    names = r["layers"]
    out = ["== Table 1 (methodology, live on paper_cnn) ==",
           "  per-layer activation precisions: "
           + "-".join(str(r["a_bits"][n]) for n in names),
           "  per-layer weight precisions:     "
           + "-".join(str(r["w_bits"][n]) for n in names),
           "  dynamic activation trimming (group=256):"]
    out += [dynamic_line(n, r["dynamic"][n]) for n in names
            if n in r["dynamic"]]
    return out


def main(device="cuda") -> dict:
    r = rows(device=device)
    for line in lines(r):
        print(line)
    return r
