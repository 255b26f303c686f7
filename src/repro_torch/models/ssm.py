"""Mamba2 (SSD, state-space duality) block: the chunked full-sequence scan
(training and prefill) and the one-token decode step.

PyTorch-port counterpart of ``repro/models/ssm.py`` (Dao & Gu 2024): within
each chunk a quadratic attention-like term, across chunks a state
recurrence (a Python loop over the chunks takes ``lax.scan``'s place),
both float32 einsums over ``[B, n_chunks, chunk, H, ...]``; decode is the
O(1) recurrent update. The six projections (``in_x``, ``in_z``, ``in_B``,
``in_C``, ``in_dt``, ``out``) are Loom linears; the depthwise causal conv
and the recurrence stay out of weight conversion (``A_log``, ``D`` and
``dt_bias`` are float32).

The cache is ``{"conv": [B, d_conv - 1, d_inner] bf16 (the conv's last
raw inputs), "state": float32 [B, H, head_dim, d_state]}``, written in
place by the prefill and by each decode step, where the reference returns
a new one. The decode step's sums run over the contiguous last dim (the
conv's taps as explicit adds), so a row's step does not depend on the
other rows of a batch.

On a mesh (``shard``) the heads are split over "model": ``in_x`` and
``in_z`` column-parallel, the conv's channels, ``A_log``, ``D``,
``dt_bias`` and the state local; ``in_B``, ``in_C`` and ``in_dt``
row-parallel over the whole input (outputs whole, exact; the rank keeps
its heads' ``dt``; in training their gradients, partial on each rank,
are summed over "model"). The gated output is all-gathered for the
RMSNorm over the whole inner dim, and ``out`` is row-parallel.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist.parallel import lin
from repro_torch.dist.sharding import Spec
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init(cfg: SSMConfig, generator: torch.Generator,
         dtype=torch.bfloat16) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads
    dev = generator.device
    p = {"in_x": L.linear_init(d, di, generator, dtype),
         "in_z": L.linear_init(d, di, generator, dtype),
         "in_B": L.linear_init(d, n, generator, dtype),
         "in_C": L.linear_init(d, n, generator, dtype),
         "in_dt": L.linear_init(d, h, generator, dtype)}
    conv = torch.randn((cfg.d_conv, di), generator=generator,
                       dtype=torch.float32, device=dev)
    p["conv"] = {"w": conv.mul_(0.2).to(dtype)}
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev))
    p["D"] = torch.ones((h,), dtype=torch.float32, device=dev)
    p["dt_bias"] = torch.zeros((h,), dtype=torch.float32, device=dev)
    p["norm"] = L.norm_init(di, dtype, dev)
    p["out"] = L.linear_init(di, d, generator, dtype)
    return p


# Logical axes (in, out) of the projections.
_IN_AXES, _BCDT_AXES, _OUT_AXES = ("fsdp", "tp"), ("tp", None), ("tp", "fsdp")


def param_specs(cfg: SSMConfig) -> dict:
    """Logical specs of :func:`init`'s tree: heads over "tp"."""
    return {"in_x": L.linear_specs(*_IN_AXES),
            "in_z": L.linear_specs(*_IN_AXES),
            "in_B": L.linear_specs(*_BCDT_AXES),
            "in_C": L.linear_specs(*_BCDT_AXES),
            "in_dt": L.linear_specs(*_BCDT_AXES),
            "conv": {"w": Spec(None, "tp")},
            "A_log": Spec("tp"), "D": Spec("tp"), "dt_bias": Spec("tp"),
            "norm": L.norm_specs(), "out": L.linear_specs(*_OUT_AXES)}


def cache_specs(cfg: SSMConfig) -> dict:
    return {"conv": Spec("dp", None, "tp"),
            "state": Spec("dp", "tp", None, None)}


def _heads(cfg: SSMConfig, shard) -> int:
    return cfg.n_heads if shard is None else shard.local(cfg.n_heads)


def _project(p, x, plan, shard) -> tuple:
    """(x_inner, z, B, C, dt_raw) of x: the rank's channels and heads."""
    col, rep = lin(shard, *_IN_AXES), lin(shard, *_BCDT_AXES)
    xi = L.linear_apply(p["in_x"], x, plan, "ssm_x", col)
    z = L.linear_apply(p["in_z"], x, plan, "ssm_z", col)
    Bv = L.linear_apply(p["in_B"], x, plan, "ssm_B", rep)
    Cv = L.linear_apply(p["in_C"], x, plan, "ssm_C", rep)
    dt = L.linear_apply(p["in_dt"], x, plan, "ssm_dt", rep)
    if shard is not None:
        # Whole on every rank, used by its own heads: each rank's gradient
        # is partial (copy_to sums it over "model").
        Bv, Cv = shard.copy_to(Bv), shard.copy_to(Cv)
        dt = shard.take(shard.copy_to(dt), -1).contiguous()
    return xi, z, Bv, Cv, dt


def _gated_out(p, y, z, plan, shard):
    """``out(rms_norm(y * silu(z)))``; on a mesh the gated product is
    gathered whole for the norm, then ``out`` takes its K-slice."""
    g = y * _silu(z)
    if shard is not None:
        g = shard.gather(g, -1)
    return L.linear_apply(p["out"], L.rms_norm(g, p["norm"]["g"]), plan,
                          "ssm_out", lin(shard, *_OUT_AXES))


# PyTorch's CPU kernels run whole blocks of 16 or 32 floats through a
# vectorized exp and log and the rest through scalar ones, which can round
# differently: an elementwise op over [B, H] with H not a multiple of the
# block gives a row of a batch other bits than the row alone. The decode
# step pads such rows to a multiple of _ROW_BLOCK (the card computes every
# element alike whatever the shape).
_ROW_BLOCK = 64


def _per_row(fn, x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``fn`` of x [B, n], each row zero-padded to a multiple
    of ``_ROW_BLOCK`` elements."""
    n = x.shape[-1]
    pad = (-n) % _ROW_BLOCK
    return fn(F.pad(x, (0, pad)))[..., :n] if pad else fn(x)


def _silu(x):
    return L.activation_fn("silu")(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # ``jax.nn.softplus``: log(1 + exp(x)) as logaddexp(x, 0).
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence. x: [B, S, C]; w: [K, C];
    each tap's product and add in x's dtype, in the reference's order."""
    k = w.shape[0]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :x.shape[1], :]
        out = out + xi * w[i][None, None, :]
    return out


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Segment sums L[i, j] = sum_{j < k <= i} a[k], -inf for j > i.
    a: [..., T] -> [..., T, T]."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward. x: [b, s, h, p]; dt: [b, s, h]; A: [h] (negative); B,
    C: [b, s, n]. Returns (y [b, s, h, p], final state [b, h, p, n]).
    ``s`` must be a multiple of ``chunk`` (the reference asserts it; no
    padding)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSM chunk {chunk}")
    c = s // chunk
    xr = x.reshape(b, c, chunk, h, p)
    dtr = dt.reshape(b, c, chunk, h)
    Br = B.reshape(b, c, chunk, n)
    Cr = C.reshape(b, c, chunk, n)

    da = dtr * A[None, None, None, :]                    # [b, c, l, h]
    da_cum = torch.cumsum(da, dim=2)
    da_tot = da_cum[:, :, -1, :]                         # [b, c, h]

    # Within each chunk (quadratic in the chunk).
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))    # [b, c, h, l, l]
    att = torch.einsum("bcin,bcjn,bchij->bchij", Cr, Br, lmat)
    y_intra = torch.einsum("bchij,bcjh,bcjhp->bcihp", att, dtr, xr)

    # Each chunk's state, then the recurrence across chunks.
    decay_to_end = torch.exp(da_tot[:, :, None, :] - da_cum)   # [b, c, l, h]
    states = torch.einsum("bcln,bclh,bclh,bclhp->bchpn",
                          Br, dtr, decay_to_end, xr)      # [b, c, h, p, n]
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    before = []                                          # state before chunk
    for i in range(c):
        before.append(state)
        state = state * torch.exp(da_tot[:, i])[:, :, None, None] \
            + states[:, i].to(torch.float32)
    h_prevs = torch.stack(before, dim=1)                 # [b, c, h, p, n]

    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp",
                           Cr, h_prevs.to(Cr.dtype), torch.exp(da_cum))
    return (y_intra + y_inter).reshape(b, s, h, p), state


def _forward_full(p, cfg: SSMConfig, x: torch.Tensor, plan, shard=None):
    """The full-sequence path. Returns (out, conv_tail, final_state)."""
    b, s, _ = x.shape
    h, pd = _heads(cfg, shard), cfg.head_dim
    xi, z, Bv, Cv, dt = _project(p, x, plan, shard)
    conv_tail = xi[:, s - (cfg.d_conv - 1):, :]     # raw conv input history
    xi = _silu(_causal_conv(xi, p["conv"]["w"].to(xi.dtype)))
    Bv, Cv = Bv.to(torch.float32), Cv.to(torch.float32)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(b, s, h, pd).to(torch.float32)
    y, final = ssd_chunked(xh, dt, A, Bv, Cv, cfg.chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, h * pd).to(x.dtype)
    return _gated_out(p, y, z, plan, shard), conv_tail, final


def apply_train(p, cfg: SSMConfig, x: torch.Tensor, plan,
                shard=None) -> torch.Tensor:
    """The full-sequence forward, x [B, S, d] -> [B, S, d] (S a multiple
    of the chunk), differentiable end to end; on a mesh (``shard``) over
    this rank's rows and heads."""
    return _forward_full(p, cfg, x, plan, shard)[0]


def apply_prefill(p, cfg: SSMConfig, x: torch.Tensor, plan,
                  cache: dict, shard=None) -> torch.Tensor:
    """The full forward over x [B, S, d] (S a multiple of the chunk); the
    cache's conv history and state are written in place. Returns out."""
    out, conv_tail, final = _forward_full(p, cfg, x, plan, shard)
    cache["conv"].copy_(conv_tail.to(cache["conv"].dtype))
    cache["state"].copy_(final)
    return out


def init_cache(cfg: SSMConfig, batch: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    return {"conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                                  cfg.d_state), dtype=torch.float32,
                                 device=device)}


def apply_decode(p, cfg: SSMConfig, x: torch.Tensor, plan,
                 cache: dict, shard=None) -> torch.Tensor:
    """One token, x [B, 1, d] -> out [B, 1, d]; the cache is updated in
    place."""
    b = x.shape[0]
    h, pd = _heads(cfg, shard), cfg.head_dim
    xi, z, Bv, Cv, dt = (t[:, 0] for t in _project(p, x, plan, shard))
    conv_w = p["conv"]["w"].to(xi.dtype).to(torch.float32)     # [K, di]
    window = torch.cat([cache["conv"], xi[:, None, :]], dim=1)  # [B, K, di]
    # The conv's taps: float32 products of bf16 values (exact) summed in
    # tap order, rounded once to xi's dtype.
    acc = window[:, 0].to(torch.float32) * conv_w[0]
    for i in range(1, cfg.d_conv):
        acc = acc + window[:, i].to(torch.float32) * conv_w[i]
    xc = _silu(acc.to(xi.dtype))

    Bv, Cv = Bv.to(torch.float32), Cv.to(torch.float32)
    dt = _per_row(_softplus, dt.to(torch.float32)
                  + p["dt_bias"][None, :])                      # [B, h]
    A = -torch.exp(p["A_log"])
    xh = xc.reshape(b, h, pd).to(torch.float32)

    decay = _per_row(torch.exp, dt * A[None, :])                # [B, h]
    state = cache["state"] * decay[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bv[:, None, None, :]
    y = (Cv[:, None, None, :] * state).sum(-1) + xh * p["D"][None, :, None]
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return _gated_out(p, y.reshape(b, 1, h * pd).to(x.dtype), z[:, None],
                      plan, shard)
