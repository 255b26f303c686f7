"""Mixture-of-Experts: top-k router with its auxiliary load-balancing loss,
shared experts, and the per-row capacity dispatch.

PyTorch-port counterpart of ``repro/models/moe.py``.
Each sequence row dispatches its own tokens: token t's j-th choice takes
the next free place of its expert's ``cap`` slots, ``cap = max(1, int(S *
k / E * capacity_factor))``, and a token past its expert's capacity goes
to the sink slot ``E * cap`` and is dropped (weight 0). The router stays
float32 and out of weight conversion (tiny, accuracy-critical). The
experts' products are ``torch`` products over the experts' weights,
unpacked on every call where they are stored packed, as the reference's
``einsum``s are (no Pallas kernel there). Shared experts (deepseek) are
Loom linears through the plan (``moe_shared_gate`` / ``_up`` / ``_down``).

Batch invariance (a decode row of the batching engine equals the row
decoded alone): the router's product is an elementwise product and a sum
over the contiguous last dim, the softmax runs over at least 16 rows, the
sums over the k choices are explicit adds in float32, and the experts'
products run one sequence row at a time, at the same shapes whatever the
batch, where one batched ``einsum`` would let cuBLAS pick its kernel by
the row count.

On the ``fake_quant`` route (training) the tokens dispatched to the
experts and the experts' hidden activations are fake-quantized at Pa, as
in the reference; the router reads x unquantized.

On a mesh every MoE layer runs :func:`apply_shardmap` (the reference's
explicit expert parallelism, which also serves its ``expert_parallel``
placement): tokens are replicated within the "model" group, so the router
and the capacity dispatch are the same on every rank; each rank computes
its E/tp experts' slots and zeros elsewhere, and one exact sum over
"model" (one nonzero term per slot) gives every rank the gathered
outputs, combined over the k choices in the unsharded order. It trains
too: each rank's experts take gradients from their own slots, and the
auxiliary loss is the global batch's (the router's statistics reduced
over "data" before their product).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import plan as planlib
from repro_torch.core import bitpack, quantize as quant
from repro_torch.dist import sharding
from repro_torch.dist.parallel import lin
from repro_torch.dist.sharding import Spec
from repro_torch.models import layers as L
from repro_torch.runtime import tracing

# Rows of the router's product a step multiplies out at a time (float32
# [rows, E, d] intermediates: 1024 rows of deepseek's are 537 MB).
_ROUTER_ROWS = 256


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden size
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts, deepseek-style
    shared_d_ff: int = 0         # hidden size of the shared expert block
    capacity_factor: float = 1.25
    activation: str = "silu"
    expert_parallel: bool = True  # experts over "tp" (else d_ff over "tp")
    # The reference's explicit shard_map EP switch. Read nowhere in the
    # port: apply_shardmap serves it and expert_parallel alike; the
    # launch analysis (ROADMAP A.13c) reads it.
    shard_map_ep: bool = False
    router_aux_coef: float = 0.01


def init(cfg: MoEConfig, generator: torch.Generator,
         dtype=torch.bfloat16) -> dict:
    """Router ``{"w": float32 [d, E]}``, experts ``w_gate`` / ``w_up`` [E,
    d, f] and ``w_down`` [E, f, d] in ``dtype``, and with ``n_shared`` the
    shared block as three ``{"w"}`` linears, drawn from N(0, 1/fan_in) on
    ``generator``'s device."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = generator.device

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return w.mul_(fan_in ** -0.5)
    p = {"router": {"w": draw((d, e), d)},
         "w_gate": draw((e, d, f), d).to(dtype),
         "w_up": draw((e, d, f), d).to(dtype),
         "w_down": draw((e, f, d), f).to(dtype)}
    if cfg.n_shared > 0:
        sf = cfg.shared_d_ff or cfg.d_ff * cfg.n_shared
        p["shared"] = {"w_gate": L.linear_init(d, sf, generator, dtype),
                       "w_up": L.linear_init(d, sf, generator, dtype),
                       "w_down": L.linear_init(sf, d, generator, dtype)}
    return p


# Logical axes of the shared experts' linears (in, out).
_SHARED_IN_AXES, _SHARED_OUT_AXES = ("fsdp", "tp"), ("tp", "fsdp")


def _expert_axes(cfg: MoEConfig) -> tuple:
    """(E, d, f) logical axes of ``w_gate`` / ``w_up``; ``w_down`` takes
    (E, f, d)."""
    return ("tp", "fsdp", None) if cfg.expert_parallel \
        else (None, "fsdp", "tp")


def param_specs(cfg: MoEConfig) -> dict:
    """Logical specs of :func:`init`'s tree."""
    e_ax, d_ax, f_ax = _expert_axes(cfg)
    s = {"router": {"w": Spec(None, None)},
         "w_gate": Spec(e_ax, d_ax, f_ax), "w_up": Spec(e_ax, d_ax, f_ax),
         "w_down": Spec(e_ax, f_ax, d_ax)}
    if cfg.n_shared > 0:
        s["shared"] = {"w_gate": L.linear_specs(*_SHARED_IN_AXES),
                       "w_up": L.linear_specs(*_SHARED_IN_AXES),
                       "w_down": L.linear_specs(*_SHARED_OUT_AXES)}
    return s


def _sum_choices(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 2 of [B, S, k, ...] as k - 1 explicit adds in order."""
    out = t[:, :, 0]
    for j in range(1, t.shape[2]):
        out = out + t[:, :, j]
    return out


def router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.float() @ w`` ([B, S, d] x [d, E] -> float32 [B, S, E]) as an
    elementwise product and a sum over the contiguous last dim, over at
    least 16 rows (:func:`layers.rowwise`), so a row's logits do not
    depend on the other rows."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d).to(torch.float32)
    wt = w.to(torch.float32).t().contiguous()          # [E, d]
    out = [L.rowwise(lambda t: t.sum(-1),
                     (xf[i:i + _ROUTER_ROWS, None, :] * wt).reshape(-1, d))
           for i in range(0, b * s, _ROUTER_ROWS)]
    return torch.cat(out).reshape(b, s, -1)


def _one_hot(ids: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``one_hot(ids, n)`` in ``dtype`` as one comparison with ``arange(n)``
    (ids in [0, n): the top-k's). ``F.one_hot`` picks its ops by device
    and mode (on a CUDA tensor ``zeros`` and ``scatter_``, on a fake or
    an inference tensor this comparison, elsewhere a range check and a
    scatter), so the op analyzer would count another program on the card
    than in the dry run."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def _route(logits: torch.Tensor, cfg: MoEConfig, shard=None):
    """Top-k gating, logits [B, S, E] -> (probs float32 [B, S, k], ids
    [B, S, k], aux): softmax in float32, the k largest gates in descending
    order (``torch.topk`` and ``lax.top_k`` both sort so; exact ties
    among float32 gates are not expected), renormalised to sum 1. ``aux``
    is the load-balancing loss ``router_aux_coef * E * sum(mean gate *
    mean choice count)`` per expert, a float32 scalar. On a mesh
    (``shard``, logits of this rank's rows) both means are taken over the
    global batch, reduced over "data" before their product."""
    b, s, e = logits.shape
    gates = L.rowwise(lambda t: torch.softmax(t, dim=-1),
                      logits.to(torch.float32).reshape(b * s, e))
    probs, ids = torch.topk(gates.reshape(b, s, e), cfg.top_k, dim=-1)
    total = _sum_choices(probs[..., None])[..., 0]
    counts = _one_hot(ids, e, torch.float32).sum(2)
    me, ce = gates.mean(0), counts.mean((0, 1))
    if shard is not None:
        me, ce = shard.mean_over_data(me), shard.mean_over_data(ce)
    aux = cfg.router_aux_coef * e * torch.sum(me * ce)
    return probs / torch.clamp_min(total, 1e-9)[..., None], ids, aux


def dispatch(ids: torch.Tensor, cfg: MoEConfig, cap: int):
    """Per-row capacity dispatch of ids [B, S, k] -> (slot [B, S * k],
    keep [B, S * k]): choice (t, j) takes place ``pos`` of its expert (the
    count of earlier choices of that expert in the row, in (t, j) order),
    slot ``expert * cap + pos`` when ``pos < cap``, else the sink slot
    ``E * cap``."""
    b = ids.shape[0]
    e = cfg.n_experts
    flat = ids.reshape(b, -1)                                  # [B, S*k]
    onehot = _one_hot(flat, e, torch.int32)
    pos_in_e = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos_in_e, 2, flat[..., None])[..., 0]
    keep = pos < cap
    slot = torch.where(keep, flat * cap + pos, torch.full_like(flat, e * cap))
    return slot, keep


def _expert_weight(w, dtype) -> tuple:
    """An expert tensor's weights [E, din, dout] in ``dtype`` and its
    per-expert scale ([E] float32, or None): bf16 raw; ``{"wq",
    "scale"}`` int8 (weight-only); ``{"w_packed", "scale"}`` planes [E,
    Pw, din/8, dout], unpacked."""
    if not isinstance(w, dict):
        return w.to(dtype), None
    if "wq" in w:
        return w["wq"].to(dtype), w["scale"]
    with tracing.span("moe.unpack"):
        packed = w["w_packed"]
        e, bits, k8, n = packed.shape
        planes = packed.transpose(0, 1).reshape(bits, e * k8, n)
        wq = bitpack.unpack_weights(planes, bits).reshape(e, 8 * k8, n)
        return wq.to(dtype), w["scale"]


def _expert_mm(buf: torch.Tensor, p: dict, key: str) -> torch.Tensor:
    """buf [B, E, C, din] x expert weights ``p[key]`` -> [B, E, C, dout]
    in buf's dtype; a quantized layout is scaled per expert after the
    product, in buf's dtype. One batched product per sequence row."""
    w, scale = _expert_weight(p[key], buf.dtype)
    y = torch.stack([torch.bmm(row, w) for row in buf])
    if scale is not None:
        y = y * scale.to(y.dtype)[None, :, None, None]
    return y


def apply(p, cfg: MoEConfig, x: torch.Tensor, plan) -> torch.Tensor:
    """The serving call: :func:`apply_train`'s y alone."""
    return apply_train(p, cfg, x, plan)[0]


def apply_train(p, cfg: MoEConfig, x: torch.Tensor, plan) -> tuple:
    """x: [B, S, d] -> (y [B, S, d] in x's dtype, the router's auxiliary
    loss, a float32 scalar); dispatch per sequence row. The experts'
    products follow their stored layout (dense, or converted by
    ``model.convert_params_for_serving``); the shared experts take the
    plan's routes."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(s * k / e * cfg.capacity_factor))
    lp = plan.layer("moe_expert")
    fake_quant = lp.route == planlib.FAKE_QUANT
    xr = quant.fake_quant(x, lp.a_bits) if fake_quant else x
    probs, ids, aux = _route(router_logits(x, p["router"]["w"]), cfg)
    slot, keep = dispatch(ids, cfg, cap)
    if s > 1 and tracing.enabled():
        tracing.count("moe.prefill_choices", keep.numel())
        tracing.count("moe.prefill_dropped", torch.logical_not(keep))

    # Scatter the tokens into [B, E * cap (+1 sink), d].
    tok = torch.repeat_interleave(xr, k, dim=1)                # [B, S*k, d]
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(b, device=x.device)[:, None]
    buf[rows, slot] = tok
    buf = buf[:, :e * cap].reshape(b, e, cap, d)

    h = L.activation_fn(cfg.activation)(_expert_mm(buf, p, "w_gate")) \
        * _expert_mm(buf, p, "w_up")
    if fake_quant:
        h = quant.fake_quant(h, lp.a_bits)
    out = _expert_mm(h, p, "w_down").reshape(b, e * cap, d)
    out = torch.cat([out, torch.zeros((b, 1, d), dtype=out.dtype,
                                      device=out.device)], dim=1)
    gathered = torch.gather(out, 1, slot[..., None].expand(-1, -1, d))
    w_flat = torch.where(keep, probs.reshape(b, s * k), 0.0).to(x.dtype)
    comb = _sum_choices((gathered * w_flat[..., None]).reshape(b, s, k, d)
                        .to(torch.float32)).to(x.dtype)

    if cfg.n_shared > 0:
        sh = p["shared"]
        g = L.linear_apply(sh["w_gate"], x, plan, "moe_shared_gate")
        u = L.linear_apply(sh["w_up"], x, plan, "moe_shared_up")
        hh = L.activation_fn(cfg.activation)(g) * u
        comb = comb + L.linear_apply(sh["w_down"], hh, plan,
                                     "moe_shared_down").to(comb.dtype)
    return comb, aux


def _gathered_experts(w, axes: tuple, shard):
    """An expert leaf (raw [E, din, dout], or its ``wq`` / ``w_packed``
    layout) with its "fsdp"-split dims all-gathered."""
    resolved = sharding.resolve(Spec(*axes), shard.mesh)
    if not isinstance(w, dict):
        w, key, off = {"w": w}, "w", 0
    else:
        key = "w_packed" if "w_packed" in w else "wq"
        off = 1 if key == "w_packed" else 0
    out = dict(w)
    for d in (1, 2):
        if shard.role_of(resolved[d]) == "fsdp":
            out[key] = shard.gather_weight(out[key], d + off)
    return out["w"] if key == "w" else out


def apply_shardmap(p, cfg: MoEConfig, x: torch.Tensor, plan,
                   shard=None, global_aux: bool = False) -> tuple:
    """The MoE layer on a mesh, x [B, S, d] (this rank's rows, whole d) ->
    (y, aux); without one, the unsharded :func:`apply_train` (the
    reference's fallback).

    Expert-parallel (``expert_parallel``, E/tp experts per rank): each
    rank fills only its experts' capacity slots, runs them (only their
    planes are unpacked), leaves zeros in every other slot, and the
    gathered slot outputs are summed over "model" bit for bit. With
    ``expert_parallel=False`` (mixtral) d_ff is split over "model" and the
    down products' float partial sums are all-reduced: exact on the
    gate/up columns, held by tolerance on the sum. Shared experts are Loom
    linears, column- then row-parallel.

    Training: the tokens enter the local slots through
    :func:`~repro_torch.dist.parallel.copy_to`, so each rank's experts
    take gradients from their own slots alone and the tokens' gradient
    is summed over "model"; the down-sum and the one-hot sum pass their
    gradient unchanged. ``fake_quant`` takes the whole tensors' scales
    (the tokens' MAX over "data", the hidden activations' over both
    axes). With ``global_aux`` (training) ``aux`` is the global batch's
    (:func:`_route`); without it, this rank's rows', and serving, which
    discards it, issues no collective for it."""
    if shard is None:
        return apply_train(p, cfg, x, plan)
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(s * k / e * cfg.capacity_factor))
    lp = plan.layer("moe_expert")
    fake_quant = lp.route == planlib.FAKE_QUANT
    xr = quant.fake_quant(x, lp.a_bits, shard.max_over(("dp",))) \
        if fake_quant else x
    probs, ids, aux = _route(router_logits(x, p["router"]["w"]), cfg,
                             shard if global_aux else None)
    slot, keep = dispatch(ids, cfg, cap)
    e_ax, d_ax, f_ax = _expert_axes(cfg)
    w = {"w_gate": _gathered_experts(p["w_gate"], (e_ax, d_ax, f_ax), shard),
         "w_up": _gathered_experts(p["w_up"], (e_ax, d_ax, f_ax), shard),
         "w_down": _gathered_experts(p["w_down"], (e_ax, f_ax, d_ax), shard)}
    ep = cfg.expert_parallel
    e_loc = shard.local(e) if ep else e
    lo = shard.rank("tp") * e_loc if ep else 0
    ours = keep & (slot >= lo * cap) & (slot < (lo + e_loc) * cap)
    lslot = torch.where(ours, slot - lo * cap,
                        torch.full_like(slot, e_loc * cap))

    tok = torch.repeat_interleave(shard.copy_to(xr), k, dim=1)  # [B, S*k, d]
    buf = torch.zeros((b, e_loc * cap + 1, d), dtype=x.dtype, device=x.device)
    rows = torch.arange(b, device=x.device)[:, None]
    buf[rows, lslot] = tok
    buf = buf[:, :e_loc * cap].reshape(b, e_loc, cap, d)
    h = L.activation_fn(cfg.activation)(_expert_mm(buf, w, "w_gate")) \
        * _expert_mm(buf, w, "w_up")
    if fake_quant:
        h = quant.fake_quant(h, lp.a_bits, shard.max_over(("dp", "tp")))
    out = _expert_mm(h, w, "w_down").reshape(b, e_loc * cap, d)
    if not ep:
        out = shard.reduce_from(out.to(torch.float32)).to(x.dtype)
    out = torch.cat([out, torch.zeros((b, 1, d), dtype=out.dtype,
                                      device=out.device)], dim=1)
    gathered = torch.gather(out, 1, lslot[..., None].expand(-1, -1, d))
    if ep:
        gathered = shard.sum_one_hot(gathered)
    w_flat = torch.where(keep, probs.reshape(b, s * k), 0.0).to(x.dtype)
    comb = _sum_choices((gathered * w_flat[..., None]).reshape(b, s, k, d)
                        .to(torch.float32)).to(x.dtype)
    if cfg.n_shared > 0:
        sh = p["shared"]
        col = lin(shard, *_SHARED_IN_AXES)
        g = L.linear_apply(sh["w_gate"], x, plan, "moe_shared_gate", col)
        u = L.linear_apply(sh["w_up"], x, plan, "moe_shared_up", col)
        hh = L.activation_fn(cfg.activation)(g) * u
        comb = comb + L.linear_apply(
            sh["w_down"], hh, plan, "moe_shared_down",
            lin(shard, *_SHARED_OUT_AXES, x_local=True)).to(comb.dtype)
    return comb, aux
