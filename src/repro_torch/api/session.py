"""``repro_torch.compile``: one entry point from (config, policy) to serving.

PyTorch-port counterpart of ``repro/api/session.py`` (the CNN branch)::

    import repro_torch
    session = repro_torch.compile(cnn_cfg, policy, mode="serve_packed",
                                  backend="cuda")
    logits = session.classify(images)      # NHWC [B, H, W, C]

The session runs on the card (``device="cuda"``) unless the caller asks
for the CPU. There is no integrity fingerprint yet (ROADMAP A.9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.api.plan import ExecutionPlan, build_plan
from repro_torch.core.policy import PrecisionPolicy

_SERVING_MODES = ("serve_packed",)


@dataclasses.dataclass
class ServingSession:
    """A compiled model + plan, ready to serve. Built by :func:`compile`."""

    cfg: Any
    plan: ExecutionPlan
    params: dict
    device: torch.device

    def classify(self, x) -> torch.Tensor:
        """x: [B, H, W, C] float (tensor or array) -> logits [B, n_classes]
        on the session's device."""
        from repro_torch.models import cnn
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return cnn.forward(self.params, self.cfg, x, self.plan)


def _convert_tree(params: dict, policy: PrecisionPolicy, mode: str) -> dict:
    """Pack every dense 2-D ``{"w": ...}`` layer of a flat CNN tree for
    ``mode``; layers already packed pass unchanged."""
    from repro_torch.models import layers as L
    out = {}
    for name, p in params.items():
        if isinstance(p, dict) and getattr(p.get("w"), "ndim", 0) == 2:
            out[name] = L.convert_linear_for_serving(p, policy.lookup(name),
                                                     mode)
        else:
            out[name] = p
    return out


def compile(cfg, policy: Optional[PrecisionPolicy] = None,
            mode: str = "dense", backend="cuda", *, params=None,
            generator: torch.Generator | None = None,
            device="cuda") -> ServingSession:
    """Compile a CNN for serving: plans + params on ``device``.

    ``params``: a tree in the dense or the packed layout, as tensors or
    numpy arrays (:func:`repro_torch.interop.params_from_numpy`); dense
    layers are packed here when ``mode`` is a serving mode. Omitted ->
    drawn from ``generator`` (seed 0 when None). ``backend``: registered
    name or Backend object; the default ``cuda`` launches the kernels on
    the card and takes their plain versions with ``device="cpu"``.
    ``device="cuda"`` without a card raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compile(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if not hasattr(cfg, "convs"):
        raise NotImplementedError(
            f"{getattr(cfg, 'name', cfg)!r}: LM sessions are not ported yet "
            f"(ROADMAP A.6)")
    from repro_torch import interop
    from repro_torch.models import cnn
    policy = policy if policy is not None else PrecisionPolicy()
    plan = build_plan(cfg, policy, mode, backend)
    if params is None:
        params = cnn.init_params(cfg, generator, device)
    params = interop.params_from_numpy(params, device)
    if mode in _SERVING_MODES:
        params = _convert_tree(params, policy, mode)
        plan.record_weight_groups(params)
    return ServingSession(cfg=cfg, plan=plan, params=params, device=device)
