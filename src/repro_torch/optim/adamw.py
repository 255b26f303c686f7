"""AdamW with precision-scaled moments.

PyTorch-port counterpart of ``repro/optim/adamw.py``. Trees are nested
dicts of tensors (the port's param layout); the moments mirror the
params. ``moment_dtype="bfloat16"`` stores both moments in bf16, halving
the optimizer's memory (the paper's storage-precision lever applied to
training state); the update itself runs in float32 either way, in the
reference's order of operations, so the two packages agree to float32
rounding. The reference's ``opt_state_specs`` (moment sharding) comes with
ROADMAP A.13b (training on a mesh).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import interop


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


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (path order) of each leaf's float32 sum
    of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in interop.flatten_with_paths(tree).values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree, max_norm: float) -> tuple:
    """Every leaf scaled by ``min(1, max_norm / max(norm, 1e-12))`` in
    float32, kept in its dtype. Returns (tree, norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return interop.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: AdamWConfig, lr: torch.Tensor) -> tuple:
    """One AdamW step: gradients clipped to ``grad_clip`` by global norm,
    bias-corrected moments, decoupled weight decay on matrices (ndim >=
    2) only. Returns (new params, new opt state, {"grad_norm", "lr"});
    the inputs are left unchanged."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
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
