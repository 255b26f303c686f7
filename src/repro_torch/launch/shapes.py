"""The input-shape grid of the launch analysis, and fake-tensor stand-ins
for every input of a cell.

PyTorch-port counterpart of ``repro/launch/shapes.py``. Every (arch x
shape) cell is defined here; the builders return the inputs of a step
(params, optimizer state, caches, token batches) as fake tensors on a
fake ``cuda`` device (``FakeTensorMode``: shapes, dtypes and strides, no
storage), each beside the port's logical spec tree, as the reference's
return ``ShapeDtypeStruct`` trees for ``jit(...).lower()``. Nothing is
allocated and no value is read, the serving conversion included. Every
builder runs in :func:`fake_mode`, one mode for the process, so its
tensors mix with a dry run's.

Where PyTorch has no CUDA (a CPU-only build), the fake device is the
CPU: such a build refuses to index even a fake CUDA tensor (its Python
indexing takes a CUDA device guard). Shapes, dtypes and every count of
the analysis are the same on either.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs, interop
from repro_torch.api import backend as backendlib
from repro_torch.dist.sharding import Spec
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init, opt_state_specs


def fake_device() -> str:
    """The fake tensors' device: ``cuda``, or ``cpu`` on a CPU-only
    build (module docstring)."""
    return "cuda" if torch.backends.cuda.is_built() else "cpu"


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES = {
    "train_4k":    ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeCell("long_500k", "decode", 524288, 1),
}

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell_is_applicable(arch: str, shape: str) -> bool:
    """long_500k needs sub-quadratic attention (SSM / hybrid / windowed)."""
    if shape != "long_500k":
        return True
    return configs.get(arch).sub_quadratic


class _FakeMode(FakeTensorMode):
    """A fake-tensor mode in which the backend makes its plan-constant
    plane counts afresh: its cache (``backend._counts_tensor``) would keep
    a fake tensor for the real calls that follow."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
        self._counts_fns = []

    def __enter__(self):
        self._counts_fns.append(backendlib._counts_tensor)
        backendlib._counts_tensor = _fresh_counts
        return super().__enter__()

    def __exit__(self, *exc):
        backendlib._counts_tensor = self._counts_fns.pop()
        return super().__exit__(*exc)


_fresh_counts = backendlib._counts_tensor.__wrapped__


@functools.cache
def fake_mode() -> FakeTensorMode:
    """The process's fake-tensor mode (real tensors entering it, e.g. a
    constant made on the host, are taken as fake)."""
    return _FakeMode()


def _empty(shape, dtype) -> torch.Tensor:
    with fake_mode():
        return torch.empty(shape, dtype=dtype, device=fake_device())


def batch_structs(cfg, cell: ShapeCell):
    """Token-batch stand-ins + logical specs."""
    b, s = cell.batch, cell.seq
    if cell.kind in ("train", "prefill"):
        shapes = {"tokens": _empty((b, s), torch.int32)}
        specs = {"tokens": Spec("dp", None)}
        if cell.kind == "train":
            shapes["labels"] = _empty((b, s), torch.int32)
            specs["labels"] = Spec("dp", None)
        if cfg.n_img_tokens:
            shapes["img_embeds"] = _empty((b, cfg.n_img_tokens, cfg.d_model),
                                          torch.bfloat16)
            specs["img_embeds"] = Spec("dp", None, None)
        return shapes, specs
    shapes = {"token": _empty((b,), torch.int32),
              "pos": _empty((), torch.int32)}
    return shapes, {"token": Spec("dp"), "pos": Spec()}


def _dense_params(cfg) -> dict:
    """The seed-0 param tree's shapes and dtypes, on the fake device: one
    layer group drawn, its block leaves stacked over every group."""
    one = dataclasses.replace(cfg, n_layers=cfg.period)
    with fake_mode():
        params = M.init_params(one, torch.Generator(), "cpu")
        return interop.map_with_paths(lambda path, t: torch.empty(
            ((cfg.n_groups,) + tuple(t.shape[1:])
             if path.startswith("blocks/") else t.shape), dtype=t.dtype,
            device=fake_device()), params)


def param_structs(cfg, *, serving_mode: str | None = None, policy=None):
    """(stand-in tree, logical spec tree) for the parameters; optionally
    the serving representation (the paper's bit-interleaved storage for
    ``serve_packed``), converted on the fake tensors."""
    params, specs = _dense_params(cfg), M.param_spec_tree(cfg)
    if serving_mode and serving_mode != "dense":
        from repro_torch.core.policy import uniform_policy
        pol = policy or uniform_policy(8, 8)
        with fake_mode():
            conv = M.convert_structs_for_serving(params, pol, serving_mode)
        return conv, M.convert_specs_for_serving(params, specs, serving_mode)
    return params, specs


def train_state_structs(cfg, opt_cfg: AdamWConfig):
    """(state stand-in tree, state logical-spec tree) for the trainer."""
    params, specs = _dense_params(cfg), M.param_spec_tree(cfg)
    with fake_mode():
        opt = adamw_init(params, opt_cfg)
    return ({"params": params, "opt": opt},
            {"params": specs, "opt": opt_state_specs(specs)})


def cache_structs(cfg, cell: ShapeCell):
    """(cache stand-ins, the reference's logical cache specs)."""
    with fake_mode():
        cache = M.init_cache(cfg, cell.batch, cell.seq, fake_device())
    return cache, M.cache_spec_tree(cfg)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in interop.flatten_with_paths(tree).values())


def n_params(param_tree) -> int:
    return sum(math.prod(t.shape)
               for t in interop.flatten_with_paths(param_tree).values())


@functools.cache
def active_param_count(cfg) -> tuple[int, int]:
    """(total, active) parameter counts -- MoE active = shared + top_k
    routed + non-expert. Used for the MODEL_FLOPS roofline row (once per
    config)."""
    params = _dense_params(cfg)
    total = n_params(params)
    if cfg.moe is None:
        return total, total
    inactive = 0
    for path, leaf in interop.flatten_with_paths(params).items():
        if any(k in ("w_gate", "w_up", "w_down") for k in path.split("/")) \
                and leaf.ndim == 4:
            # stacked expert tensor [G, E, din, dout]
            inactive += math.prod(leaf.shape) * (1 - cfg.moe.top_k
                                                 / leaf.shape[1])
    return total, int(total - inactive)
