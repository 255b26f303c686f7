"""AdamW with precision-scaled moments.

PyTorch-port counterpart of ``repro/optim/adamw.py``. Trees are nested
dicts of tensors (the port's param layout); the moments mirror the
params. ``moment_dtype="bfloat16"`` stores both moments in bf16, halving
the optimizer's memory (the paper's storage-precision lever applied to
training state); the update itself runs in float32 either way, in the
reference's order of operations, so the two packages agree to float32
rounding.

On a mesh the optimizer runs on each rank's shards: the moments shard
like their parameters (:func:`opt_state_specs`, ZeRO-style), the update is
elementwise, and the global norm of the clip reduces each leaf's sum of
squares over exactly the axes that split it (a replicated leaf counts
once), so every rank clips by the unsharded norm.
"""
from __future__ import annotations

import dataclasses

import collections

import torch

from repro_torch import interop
from repro_torch.dist.sharding import Spec, sharded_axes


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "bfloat16"

    @property
    def _mdt(self) -> torch.dtype:
        return torch.bfloat16 if self.moment_dtype == "bfloat16" \
            else torch.float32


def adamw_init(params: dict, cfg: AdamWConfig) -> dict:
    """``{"mu", "nu"}``: zeros like the params in the moment dtype, on
    their devices; ``"step"``: an int32 0-d counter."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg._mdt, device=p.device)
    device = next(iter(interop.flatten_with_paths(params).values())).device
    return {"mu": interop.tree_map(zeros, params),
            "nu": interop.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_specs(param_specs) -> dict:
    """The optimizer state's spec tree: the moments shard like the
    params, the step counter is replicated."""
    return {"mu": param_specs, "nu": param_specs, "step": Spec()}


def _reduce_over_axes(sums: list, axes: list, shard) -> list:
    """Each leaf's local sum SUM-reduced over the mesh axes that split the
    leaf (one all-reduce per set of axes)."""
    by_axes = collections.defaultdict(list)
    for i, a in enumerate(axes):
        a = frozenset(x for x in a if shard.size(x) > 1)
        if a:
            by_axes[a].append(i)
    sums = list(sums)
    for a, idx in by_axes.items():     # the same order on every rank
        v = shard.comm.all_reduce(torch.stack([sums[i] for i in idx]), "sum",
                                  shard.group_over(a))
        for j, i in enumerate(idx):
            sums[i] = v[j]
    return sums


def global_norm(tree, shard=None, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves (path order) of each leaf's float32 sum
    of squares. On a mesh (``shard``, the tree this rank's shards placed
    by ``specs``) each leaf's sum is SUM-reduced over the axes that split
    it first, so every rank gets the unsharded norm."""
    flat = interop.flatten_with_paths(tree)
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in flat.values()]
    if shard is not None:
        spec_of = interop.flatten_with_paths(specs)
        sums = _reduce_over_axes(
            sums, [sharded_axes(spec_of[k], shard.mesh) for k in flat], shard)
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float, shard=None,
                        specs=None) -> tuple:
    """Every leaf scaled by ``min(1, max_norm / max(norm, 1e-12))`` in
    float32, kept in its dtype. Returns (tree, norm). ``shard`` /
    ``specs``: see :func:`global_norm`."""
    norm = global_norm(tree, shard, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return interop.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: AdamWConfig, lr: torch.Tensor, shard=None,
                 specs=None) -> tuple:
    """One AdamW step: gradients clipped to ``grad_clip`` by global norm,
    bias-corrected moments, decoupled weight decay on matrices (ndim >=
    2) only. Returns (new params, new opt state, {"grad_norm", "lr"});
    the inputs are left unchanged. On a mesh (``shard``) every tree holds
    this rank's shards, placed by ``specs`` (the params'), and the
    gradients are already reduced over "data"."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shard, specs)
    step = opt_state["step"] + 1
    c1 = 1.0 - cfg.b1 ** step.to(torch.float32)
    c2 = 1.0 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = m.to(torch.float32) * cfg.b1 + g32 * (1.0 - cfg.b1)
        v32 = v.to(torch.float32) * cfg.b2 + torch.square(g32) * (1.0 - cfg.b2)
        update = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        if p.ndim >= 2:
            update = update + cfg.weight_decay * p.to(torch.float32)
        newp = (p.to(torch.float32) - lr * update).to(p.dtype)
        return newp, m32.to(m.dtype), v32.to(v.dtype)

    out = interop.tree_map(upd, params, grads, opt_state["mu"],
                           opt_state["nu"])
    new_p, mu, nu = (interop.tree_map(lambda t, i=i: t[i], out)
                     for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "step": step}, {
        "grad_norm": gnorm, "lr": lr}
