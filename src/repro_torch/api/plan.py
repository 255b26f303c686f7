"""Execution plans: per-layer dispatch decisions resolved once, not per call.

PyTorch-port counterpart of ``repro/api/plan.py``. A :class:`LayerPlan`
freezes a layer's kind, route, (Pa, Pw), conv geometry and band size;
:func:`build_plan` produces the model-wide :class:`ExecutionPlan`, which
also owns the backend.

Every mode of the reference is ported, for the paper CNN and the LM
(whose plans are keyed by layer class, ``attn_q`` ... ``lm_head``):
``dense``, ``fake_quant`` (the QAT forward of training: straight-through
fake quantization of activations and weights, then a float product),
``serve_int8`` and ``serve_packed``. A CNN plan's ``conv_route`` picks
the fused conv or the reference's im2col A/B route (the conv as a linear
on the patch tensor, through the conv's linear twin).
:meth:`ExecutionPlan.fallback_report` reads a guarded backend's sticky
fallbacks. The conv band size is sized against one H100 thread block's
shared memory (:data:`repro_torch.kernels.bitserial_conv.SMEM_BUDGET`),
where the reference sizes it against the TPU's VMEM.
"""
from __future__ import annotations

import dataclasses

from repro_torch.api.backend import Backend, resolve_backend
from repro_torch.core.policy import LayerPrecision, PrecisionPolicy

# Routes: the closed set of execution strategies a layer can resolve to.
DENSE = "dense"              # float matmul / conv (DPNN-equivalent baseline)
FAKE_QUANT = "fake_quant"    # QAT: STE fake-quant forward, float product
INT8 = "int8"                # LM_8b: dynamic act quant + int8 weights
PACKED = "packed"            # paper-faithful bit-serial packed planes

# Execution-mode names -> routes.
MODE_ROUTES = {
    "dense": DENSE,
    "fake_quant": FAKE_QUANT,
    "serve_int8": INT8,
    "serve_packed": PACKED,
}

# Conv lowerings: the fused conv, or the reference's im2col A/B route.
CONV_ROUTES = ("fused", "im2col")

# Param-tree key -> apply-time layer-class name used by PrecisionPolicy
# (shared with models.model's serving conversion walk).
PARAM_CLASS_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
                     "wo": "attn_o", "w_gate": "ffn_gate", "w_up": "ffn_up",
                     "w_down": "ffn_down", "head": "lm_head",
                     "in_x": "ssm_x", "in_z": "ssm_z", "in_B": "ssm_B",
                     "in_C": "ssm_C", "in_dt": "ssm_dt", "out": "ssm_out"}

# Every linear layer class an LM architecture can route through.
LM_LINEAR_CLASSES = tuple(sorted(set(PARAM_CLASS_NAMES.values()))) + (
    "moe_expert", "moe_shared_gate", "moe_shared_up", "moe_shared_down")


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Everything apply-time dispatch needs for ONE layer, resolved once.

    ``conv_tile`` is the resolved output-rows-per-band of the conv kernel,
    filled in by :meth:`ExecutionPlan.conv_tile` from the layer's
    activation geometry (recorded in ``conv_tile_geom``). ``dynamic_a``
    trims activation planes per group of ``group_size`` rows or windows at
    run time. ``conv_route`` is ``"fused"`` or ``"im2col"`` (the conv as
    a linear on its patch tensor). ``w_group`` / ``w_group_counts`` are
    the pack-time per-filter-group weight plane counts (``None`` = none
    recorded).
    """

    name: str
    kind: str                      # "linear" | "conv"
    route: str                     # DENSE | FAKE_QUANT | INT8 | PACKED
    precision: LayerPrecision = LayerPrecision()
    dynamic_a: bool = False
    group_size: int = 256
    kernel: int | None = None
    stride: int | None = None
    conv_route: str = "fused"      # "fused" | "im2col"
    conv_tile: int | None = None
    conv_tile_geom: tuple | None = None   # (h, w, c) it was sized for
    w_group: int = 16
    w_group_counts: tuple | None = None

    @property
    def a_bits(self) -> int:
        return self.precision.a_bits

    @property
    def w_bits(self) -> int:
        return self.precision.w_bits


@dataclasses.dataclass
class ExecutionPlan:
    """Model-wide execution plan: resolved LayerPlans + the backend.

    ``layers`` maps ``(name, kind)`` to a resolved :class:`LayerPlan`;
    names not pre-resolved by :func:`build_plan` resolve on first use.
    """

    mode: str
    policy: PrecisionPolicy
    backend: Backend
    conv_route: str = "fused"
    layers: dict = dataclasses.field(default_factory=dict)

    def layer(self, name: str = "", kind: str = "linear",
              kernel: int | None = None, stride: int | None = None
              ) -> LayerPlan:
        key = (name, kind)
        lp = self.layers.get(key)
        if lp is None:
            lp = self._resolve(name, kind, kernel, stride)
            self.layers[key] = lp
        elif kernel is not None and (lp.kernel, lp.stride) != (kernel, stride):
            raise ValueError(
                f"layer {name!r} resolved with conv geometry "
                f"{(lp.kernel, lp.stride)} but called with {(kernel, stride)}")
        return lp

    def conv_tile(self, lp: LayerPlan, h: int, w: int, c: int) -> int:
        """Rows per band of the conv kernel for layer ``lp``, resolved from
        the activation geometry against the shared-memory budget and frozen
        into the stored LayerPlan for that geometry."""
        geom = (h, w, c)
        if lp.conv_tile is not None and lp.conv_tile_geom == geom:
            return lp.conv_tile
        rpb = conv_rows_per_band(h, w, c, kernel=lp.kernel, stride=lp.stride)
        self.layers[(lp.name, lp.kind)] = dataclasses.replace(
            lp, conv_tile=rpb, conv_tile_geom=geom)
        return rpb

    def fallback_report(self) -> dict:
        """Which ops degraded off the primary backend, and to where.

        The plan owns the backend, so backend fallbacks are plan state: a
        :class:`~repro_torch.api.backend.GuardedBackend` records every
        sticky per-op fallback in ``fallbacks_by_op`` and this accessor
        exposes it (``{}`` for unguarded backends and on the fault-free
        path). An op that fell back stays fallen back for the plan's
        lifetime.
        """
        return dict(getattr(self.backend, "fallbacks_by_op", {}))

    def weight_group_counts(self, named_params: dict) -> dict:
        """Pack-time per-filter-group weight plane counts of a packed tree.

        ``named_params`` maps layer names to their PACKED param dicts
        (``{"w_packed": uint8 [Pw, K/8, N], ...}``; :func:`counted_weights`
        names a model's tree so). For every resolved layer with a matching
        packed tensor the OR-tree counts are computed once; returns
        ``{(name, kind): tuple of Python ints}``, empty when
        ``policy.w_group`` is 0.
        """
        from repro_torch.core import bitpack, weightgroups
        if not self.policy.w_group:
            return {}
        out = {}
        memo = {}   # (name, w_group) -> counts: a conv's linear twin
        #             covers the same tensor
        for (name, kind), lp in self.layers.items():
            p = named_params.get(name)
            wp = p.get("w_packed") if isinstance(p, dict) else None
            if wp is None or wp.ndim != 3:
                continue
            counts = memo.get((name, lp.w_group))
            if counts is None:
                w_bits = wp.shape[0]
                counts = bitpack.by_columns(
                    lambda w: weightgroups.weight_group_counts(
                        bitpack.unpack_weights(w, w_bits), w_bits,
                        lp.w_group),
                    wp, 64 * w_bits * wp.shape[1], multiple=lp.w_group)
                counts = tuple(int(c) for c in counts.tolist())
                memo[(name, lp.w_group)] = counts
            out[(name, kind)] = counts
        return out

    def record_weight_groups(self, named_params: dict) -> None:
        """Freeze :meth:`weight_group_counts` of ``named_params`` into the
        layers' plans (a no-op when ``policy.w_group`` is 0)."""
        for (name, kind), counts in self.weight_group_counts(
                named_params).items():
            self.set_weight_counts(name, kind, counts)

    def set_weight_counts(self, name: str, kind: str, counts,
                          w_group: int | None = None) -> LayerPlan:
        """Attach per-filter-group plane counts (as Python ints) to one
        resolved layer, and optionally its group size."""
        lp = self.layers[(name, kind)]
        lp = dataclasses.replace(
            lp, w_group_counts=tuple(int(c) for c in counts),
            w_group=lp.w_group if w_group is None else w_group)
        self.layers[(name, kind)] = lp
        return lp

    def _resolve(self, name, kind, kernel=None, stride=None) -> LayerPlan:
        try:
            route = MODE_ROUTES[self.mode]
        except KeyError:
            raise ValueError(f"unknown execution mode {self.mode!r}; "
                             f"expected one of {sorted(MODE_ROUTES)}") from None
        return LayerPlan(
            name=name, kind=kind, route=route,
            precision=self.policy.lookup(name),
            dynamic_a=self.policy.dynamic_a,
            group_size=self.policy.group_size,
            w_group=self.policy.w_group or 16,
            kernel=kernel, stride=stride, conv_route=self.conv_route)


def counted_weights(cfg, params: dict) -> dict:
    """The packed tensors whose weight-group counts a plan records, keyed
    by plan layer name. LM blocks are stacked and share one plan per layer
    class, so of an LM only the unstacked head (``lm_head``) counts; a
    CNN's tree is keyed by its layers' names already."""
    if hasattr(cfg, "pattern"):
        return {"lm_head": params.get("head", {})}
    return params


def conv_rows_per_band(h: int, w: int, c: int, *, kernel: int,
                       stride: int) -> int:
    """Band size of the conv kernel: starts from one band covering the
    whole map and halves it until one block's shared memory
    (:func:`repro_torch.kernels.bitserial_conv.conv_smem_bytes`) fits the
    budget; floors at one output row per band."""
    from repro_torch.kernels.bitserial_conv import SMEM_BUDGET, conv_smem_bytes
    rpb = -(-h // stride)
    while rpb > 1 and conv_smem_bytes(h, w, c, kernel=kernel, stride=stride,
                                      rows_per_band=rpb) > SMEM_BUDGET:
        rpb = -(-rpb // 2)
    return rpb


def build_plan(cfg, policy: PrecisionPolicy | None = None,
               mode: str = "dense", backend="cuda",
               conv_route: str = "fused") -> ExecutionPlan:
    """Compile the per-layer plans for a model config.

    ``cfg`` may be a :class:`repro_torch.models.cnn.CNNConfig` (pre-resolves
    each conv with its kernel/stride plus the FC head), a
    :class:`repro_torch.models.transformer.ModelConfig` (pre-resolves the
    LM linear classes) or None (everything resolves on first use).
    ``backend`` is a Backend object or registered name; the default
    ``cuda`` takes the plain versions on CPU tensors. ``conv_route``:
    ``"fused"`` or ``"im2col"`` (:data:`CONV_ROUTES`).
    """
    if conv_route not in CONV_ROUTES:
        raise ValueError(f"unknown conv_route {conv_route!r}; expected one "
                         f"of {CONV_ROUTES}")
    policy = policy if policy is not None else PrecisionPolicy()
    plan = ExecutionPlan(mode=mode, policy=policy,
                         backend=resolve_backend(backend),
                         conv_route=conv_route)
    if cfg is None:
        return plan
    if hasattr(cfg, "convs"):            # CNNConfig
        for c in cfg.convs:
            plan.layer(c.name, kind="conv", kernel=c.kernel, stride=c.stride)
            # The im2col route reads a linear twin of each conv; it is
            # resolved on the fused route too, as the reference does, so
            # the plans' metadata (and the fingerprints over it) agree.
            plan.layer(c.name, kind="linear")
        for i in range(len(cfg.fcs)):
            plan.layer(f"fc{i}", kind="linear")
    elif hasattr(cfg, "pattern"):        # ModelConfig
        for cls in LM_LINEAR_CLASSES:
            plan.layer(cls, kind="linear")
    else:
        raise TypeError(f"unknown model config {cfg!r}")
    return plan
