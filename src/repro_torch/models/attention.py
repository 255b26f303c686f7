"""Attention: GQA self-attention (full or sliding-window), the blockwise
training and prefill path with its flash backward, cross-attention, and
decode over the KV cache.

PyTorch-port counterpart of ``repro/models/attention.py``. All four
projections are Loom linears (through the plan). Training and prefill
run :func:`chunked_attention`, plain PyTorch with an online softmax, as
the reference's do; the kernel K7 is reached through
``kernels.ops.attention`` only. With ``flash_vjp`` the training forward
of a full-attention layer goes through :class:`FlashAttention`, whose
backward recomputes the probabilities block by block from the saved
logsumexp rows instead of keeping every block's (the reference's
``flash_attention_xla``). Decode attends over the whole cache, each KV
head with its group of query heads, masked by each slot's recorded
position, in a batch-invariant form (:func:`decode_attend`).

The KV cache is ``{"k", "v": [B, S_cache, H_kv, D] bf16, "slot_pos": int32
[B, S_cache]}`` (a ring of ``window`` slots for a sliding-window layer).
With ``kv_cache_bits=8`` it is Loom's int8 cache: ``k`` and ``v`` int8,
plus float32 ``k_scale`` / ``v_scale`` ``[B, S_cache, H_kv]``, one scale
per (slot, head). Where the reference returns a new cache, the port
writes the cache it is given in place: a decode step then moves one slot,
not the whole cache.

Decode routes: the queries grouped ``[B, G, R, D]`` against the
un-repeated cache in float32, whatever ``gqa_decode`` says (the
reference's repeat route gives the same bits, so the port keeps one
body); and on an int8 cache ``attn_int8``, integer QK and PV products on
the stored int8 values (:func:`_decode_attend_gqa_int8`). Both keep a
row's result independent of the other rows.

On a mesh (``shard``, a :class:`~repro_torch.dist.parallel.ShardCtx`)
attention is head-parallel: q column-parallel over "model", K and V
row-parallel (their whole outputs summed exactly; each rank keeps its own
KV heads), the output projection row-parallel, every layer running on its
local heads (:func:`local_cfg`); in training the ``qk_norm`` gains, used
on the local heads only, have their gradients SUM-reduced over "model"
(:func:`_head_local`). The KV cache is placed by KV heads over
"model" (:func:`cache_shard_specs`), where the reference's
:func:`cache_specs` split the sequence ("sp", flash-decoding): with the
heads local a decode step needs no softmax combine across ranks and stays
bit-exact. Where the mesh's rules select the reference's split
(:func:`seq_split`: ``decode_pin_seq``, an "sp" override, or heads that
do not split over "tp"), every rank holds every KV head: its q heads
pick theirs in prefill and training, and a decode step writes the new
K/V on the rank owning the slot, attends every head (q gathered over
"tp") over the rank's slots and merges the parts over "sp"
(:func:`decode_attend_split`). q heads that do not split over "tp" are
gathered whole, and every rank runs every head's attention
(:func:`placement`). ``kv_col_parallel`` / ``kv_replicated``
place the K/V projections as the reference's do (:func:`kv_axes`);
``mask_cache_update`` writes the cache by an elementwise ``where``.

Cross-attention (llama-3.2-vision's image layers): the prefill projects
the image embeddings' K/V into the layer's cache
(:func:`init_cross_cache`) and attends to them non-causally through the
training forward (:func:`apply_train` with ``kv_x``), as the reference's
prefill does; a decode step projects q alone, unroped, against that
cache, which it leaves unchanged.
"""
from __future__ import annotations

import dataclasses
import typing

import torch

from repro_torch.core.quantize import true_div
from repro_torch.dist.parallel import lin
from repro_torch.dist.sharding import Spec
from repro_torch.models import layers as L

NEG_INF = -1e30
# A run of this many int8 x int8 products (each at most 127 * 128 in
# magnitude) sums below 2^24, exactly in float32 in any order.
_EXACT_RUN = 1024


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 500000.0
    qk_norm: bool = False
    window: int | None = None          # sliding-window size (None = full)
    flash_vjp: bool = False            # memory-efficient custom backward
    kv_col_parallel: bool = False      # K/V projections column-parallel
    decode_pin_seq: bool = False       # the cache split by sequence ("sp")
    gqa_decode: bool = False           # the reference's; no route here
    mask_cache_update: bool = False    # where()-based cache write
    kv_replicated: bool = False        # K/V projections replicated over tp
    attn_int8: bool = False            # integer QK/PV on the int8 cache
    block: int = 512                   # training q/kv block size
    causal: bool = True                # the reference's (self layers are)
    cross: bool = False                # cross-attention (K/V from images)
    kv_cache_bits: int = 16            # 16 = bf16 cache; 8 = int8 cache


def init(cfg: AttnConfig, generator: torch.Generator,
         dtype=torch.bfloat16) -> dict:
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    p = {"wq": L.linear_init(cfg.d_model, hd, generator, dtype),
         "wk": L.linear_init(cfg.d_model, kvd, generator, dtype),
         "wv": L.linear_init(cfg.d_model, kvd, generator, dtype),
         "wo": L.linear_init(hd, cfg.d_model, generator, dtype)}
    if cfg.qk_norm:
        p["qnorm"] = L.norm_init(cfg.d_head, dtype, generator.device)
        p["knorm"] = L.norm_init(cfg.d_head, dtype, generator.device)
    return p


# Logical axes (in, out) of the projections, the reference's defaults: q
# column-parallel, K/V and the output projection row-parallel.
WQ_AXES, WKV_AXES, WO_AXES = ("fsdp", "tp"), ("tp", "fsdp"), ("tp", "fsdp")


def kv_axes(cfg: AttnConfig) -> tuple:
    """(in, out) axes of ``wk`` / ``wv``: row-parallel by default,
    column-parallel with ``kv_col_parallel``, replicated over "tp" with
    ``kv_replicated`` (the reference's choices)."""
    if cfg.kv_replicated:
        return "fsdp", None
    return ("fsdp", "tp") if cfg.kv_col_parallel else WKV_AXES


def param_specs(cfg: AttnConfig) -> dict:
    """Logical specs of :func:`init`'s tree."""
    kv = L.linear_specs(*kv_axes(cfg))
    s = {"wq": L.linear_specs(*WQ_AXES), "wk": kv, "wv": dict(kv),
         "wo": L.linear_specs(*WO_AXES)}
    if cfg.qk_norm:
        s["qnorm"], s["knorm"] = L.norm_specs(), L.norm_specs()
    return s


def seq_split(cfg, shard) -> bool:
    """Whether a mesh holds the KV cache split by sequence over "sp" (the
    reference's flash-decoding layout) rather than by KV heads over "tp":
    with ``decode_pin_seq``, where "sp" resolves elsewhere than "tp" (a
    rule override, e.g. ``long_500k``'s), or where the KV heads or the q
    heads do not split over "tp". ``cfg``: a model's or an attention
    layer's."""
    if shard is None:
        return False
    tp = shard.size("tp")
    return bool(cfg.decode_pin_seq or shard.axes("sp") != shard.axes("tp")
                or cfg.n_kv_heads % tp or cfg.n_heads % tp)


class Place(typing.NamedTuple):
    """Where a mesh puts an attention layer's heads: ``split``, every KV
    head on each rank and the cache split by sequence
    (:func:`seq_split`); ``whole``, every q head on each rank too (q heads
    that do not split over "tp", e.g. ``serve_2d_tp``'s 256-way "tp": the
    projections stay split, the attention runs whole on every rank)."""
    split: bool = False
    whole: bool = False


def placement(cfg: AttnConfig, shard) -> Place:
    if shard is None:
        return Place()
    return Place(seq_split(cfg, shard),
                 bool(cfg.n_heads % shard.size("tp")))


def local_cfg(cfg: AttnConfig, shard, place: Place) -> AttnConfig:
    """``cfg`` with this rank's q and KV heads (``cfg`` itself without a
    mesh): every KV head where ``place.split``, every q head where
    ``place.whole``."""
    if shard is None:
        return cfg
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads if place.whole else shard.local(cfg.n_heads),
        n_kv_heads=cfg.n_kv_heads if place.split
        else shard.local(cfg.n_kv_heads))


def _kv_proj(p, x, plan, name, cfg: AttnConfig, shard, place: Place):
    """K or V of ``x``: on a mesh the rank's KV heads (a cache placed by
    heads), or every KV head (``place.split``), from the projection as
    :func:`kv_axes` places it: row-parallel partial products
    reduce-scattered or all-reduced, column-parallel columns taken or
    all-gathered, a replicated product sliced or kept. Every KV head held
    whole and used by the rank's own q heads only has a partial gradient
    (:meth:`~repro_torch.dist.parallel.ShardCtx.copy_to` sums it); with
    every q head on every rank it is whole already."""
    if shard is None:
        return L.linear_apply(p, x, plan, name)
    in_ax, out_ax = kv_axes(cfg)
    split = place.split
    row = in_ax == "tp"
    y = L.linear_apply(p, x, plan, name, lin(shard, in_ax, out_ax,
                                             scatter=row and not split))
    if out_ax == "tp" and split:
        y = shard.gather(y, -1)
    if split:
        return y if place.whole else shard.copy_to(y)
    if row or out_ax == "tp":
        return y
    return shard.take(shard.copy_to(y), -1)


def _o_proj(p, out, plan, shard, whole: bool = False):
    """The output projection of this rank's heads, or of every head
    (``whole``: heads whole on every rank, or a decode over a
    sequence-split cache)."""
    return L.linear_apply(p["wo"], out, plan, "attn_o",
                          lin(shard, *WO_AXES, x_local=not whole))


def _head_local(gamma, shard, place: Place):
    """A replicated ``qk_norm`` gain applied to this rank's heads only:
    its gradient is partial on each rank and SUM-reduced over "tp"
    (whole on every rank where the rank holds every q head)."""
    if shard is None or place.whole:
        return gamma
    return shard.copy_to(gamma)


def _q_proj(p, x, plan, cfg: AttnConfig, shard, place: Place):
    """q of x [..., d] as [..., H, D] (the rank's heads): column-parallel,
    its columns all-gathered where the rank holds every head."""
    q = L.linear_apply(p["wq"], x, plan, "attn_q", lin(shard, *WQ_AXES))
    if place.whole:
        q = shard.gather(q, -1)
    return q.reshape(*x.shape[:-1], cfg.n_heads, cfg.d_head)


def _project_qkv(p, cfg: AttnConfig, x, positions, plan, kv_x=None,
                 shard=None, place: Place = Place()):
    """q from x, K and V from ``kv_x`` (a cross layer's image embeddings;
    x itself when None); RMSNorm'd with ``qk_norm``; roped unless
    cross. ``cfg`` carries the rank's heads on a mesh."""
    kv_x = x if kv_x is None else kv_x
    q = _q_proj(p, x, plan, cfg, shard, place)
    k = _kv_proj(p["wk"], kv_x, plan, "attn_k", cfg, shard, place)
    k = k.reshape(*kv_x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    v = _kv_proj(p["wv"], kv_x, plan, "attn_v", cfg, shard, place)
    v = v.reshape(*kv_x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_norm(q, _head_local(p["qnorm"]["g"], shard, place))
        k = L.rms_norm(k, _head_local(p["knorm"]["g"], shard, place))
    if not cfg.cross:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _kv_for_q(k: torch.Tensor, cfg: AttnConfig, shard,
              place: Place) -> torch.Tensor:
    """K or V [..., H_kv, D] with one head per (local) q head: repeated
    over each group; where the rank holds every KV head for its own q
    heads only (``place.split`` without ``place.whole``), the KV heads of
    those q heads picked out."""
    if not place.split or place.whole:
        return _repeat_kv(k, cfg.n_heads // cfg.n_kv_heads)
    n_rep = cfg.n_heads * shard.size("tp") // cfg.n_kv_heads
    q_heads = shard.rank("tp") * cfg.n_heads + torch.arange(
        cfg.n_heads, device=k.device)
    return k.index_select(2, q_heads // n_rep)


def _block_mask(q_pos, k_pos, causal, window) -> torch.Tensor:
    """[bq, bk] True where query position q_pos[i] sees key k_pos[j]."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def _kv_span(q_first: int, bq: int, bk: int, sk: int, window) -> tuple:
    """(start, span) of the keys a q block starting at ``q_first`` walks:
    a sliding-window layer's (window + bq)-wide span, rounded up to whole
    kv blocks, where the keys are longer than it; else all of them."""
    if window is not None and sk > window + bq:
        span = -(-(window + bq) // bk) * bk
        return min(max(q_first - window + 1, 0), sk - span), span
    return 0, sk


def chunked_attention(q, k, v, *, causal=True, window=None, bq=512, bk=512,
                      q_offset=0, return_stats=False):
    """Blockwise (flash) attention in plain PyTorch: loops over q and kv
    blocks with an online softmax in float32.

    q: [B, S, H, D]; k, v: [B, Sk, H, D] (one head count). A sliding-window
    layer's q block attends only its (window + bq)-wide KV span. q_offset:
    absolute position of q[0]. Output [B, S, H, D] in q's dtype; with
    ``return_stats`` also the float32 logsumexp rows [B, H, S] (the flash
    backward's).

    Causal kv blocks that start after a q block's last row are skipped.
    Bit for bit that changes nothing: every row has already folded in the
    block holding its own position, so its running max is a real logit,
    and a fully masked block would add ``exp(-1e30 - m) = 0`` with a
    rescale of ``exp(0) = 1``.
    """
    b, s, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    bq, bk = min(bq, s), min(bk, sk)
    if s % bq or sk % bk:
        raise ValueError(f"sequence lengths {s}, {sk} are not multiples of "
                         f"the blocks {bq}, {bk}")
    qt = q.permute(0, 2, 1, 3)                     # [B, H, S, D]
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    dev = q.device
    outs, lses = [], []
    for iq in range(s // bq):
        qblk = qt[:, :, iq * bq:(iq + 1) * bq].to(torch.float32) * scale
        q_first = q_offset + iq * bq
        q_pos = q_first + torch.arange(bq, device=dev)
        start, span = _kv_span(q_first, bq, bk, sk, window)
        m = torch.full((b, h, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, bq), dtype=torch.float32, device=dev)
        o = torch.zeros((b, h, bq, d), dtype=torch.float32, device=dev)
        for k0 in range(start, start + span, bk):
            if causal and k0 > q_first + bq - 1:
                break
            ks_ = kt[:, :, k0:k0 + bk].to(torch.float32)
            vs_ = vt[:, :, k0:k0 + bk].to(torch.float32)
            kp = k0 + torch.arange(bk, device=dev)
            logits = torch.einsum("bhqd,bhkd->bhqk", qblk, ks_)
            logits = torch.where(_block_mask(q_pos, kp, causal, window),
                                 logits, NEG_INF)
            m_cur = torch.maximum(m, logits.amax(-1))
            p_ = torch.exp(logits - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = l * alpha + p_.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p_, vs_)
            m = m_cur
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.cat(outs, dim=2).permute(0, 2, 1, 3)
    if return_stats:
        return out, torch.cat(lses, dim=2)
    return out


# ---------------------------------------------------------------------------
# Flash VJP: the backward recomputes each block's probabilities from the
# saved logsumexp rows, where autograd through chunked_attention keeps
# every [bq, bk] float32 block of the forward (O(S^2) memory).
# ---------------------------------------------------------------------------

def _flash_bwd(q, k, v, out, lse, dout, causal, window, bq, bk):
    """dq, dk, dv of :func:`chunked_attention` in float32, cast to the
    inputs' dtypes. Per q block: P = exp(q k^T - lse) under the mask, dV +=
    P^T dO, dS = P (dO V^T - delta) with delta = rowsum(dO * O), dQ += dS K,
    dK += dS^T q (q scaled). A sliding-window layer's q block walks only
    its span of keys, so the backward stays O(S * span); causal kv blocks
    past a q block's last row are skipped (their P is 0)."""
    b, s, h, d = q.shape
    sk = k.shape[1]
    scale = d ** -0.5
    bq, bk = min(bq, s), min(bk, sk)
    f32 = torch.float32
    qt, kt, vt, dot, ot = (t.permute(0, 2, 1, 3).to(f32)
                           for t in (q, k, v, dout, out))
    delta = (dot * ot).sum(-1)                           # [B, H, S]
    dq = torch.empty((b, h, s, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, s, bq):
        qi = qt[:, :, q0:q0 + bq] * scale
        doi = dot[:, :, q0:q0 + bq]
        lsei = lse[:, :, q0:q0 + bq, None]
        di = delta[:, :, q0:q0 + bq, None]
        q_pos = q0 + torch.arange(bq, device=q.device)
        start, span = _kv_span(q0, bq, bk, sk, window)
        dq_i = torch.zeros_like(qi)
        for k0 in range(start, start + span, bk):
            if causal and k0 > q0 + bq - 1:
                break
            kj, vj = kt[:, :, k0:k0 + bk], vt[:, :, k0:k0 + bk]
            k_pos = k0 + torch.arange(bk, device=q.device)
            p_ = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qi, kj) - lsei)
            p_ = torch.where(_block_mask(q_pos, k_pos, causal, window), p_,
                             0.0)
            dv[:, :, k0:k0 + bk] += torch.einsum("bhqk,bhqd->bhkd", p_, doi)
            dp = torch.einsum("bhqd,bhkd->bhqk", doi, vj)
            ds = p_ * (dp - di)
            dq_i = dq_i + torch.einsum("bhqk,bhkd->bhqd", ds, kj) * scale
            dk[:, :, k0:k0 + bk] += torch.einsum("bhqk,bhqd->bhkd", ds, qi)
        dq[:, :, q0:q0 + bq] = dq_i
    return tuple(g.permute(0, 2, 1, 3).to(t.dtype)
                 for g, t in ((dq, q), (dk, k), (dv, v)))


class FlashAttention(torch.autograd.Function):
    """:func:`chunked_attention` whose backward is :func:`_flash_bwd`: it
    saves q, k, v, the output and the logsumexp rows, nothing of size
    S x Sk. The reference's ``flash_attention_xla``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, bq, bk):
        out, lse = chunked_attention(q, k, v, causal=causal, window=window,
                                     bq=bq, bk=bk, return_stats=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, window, bq, bk)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _flash_bwd(*ctx.saved_tensors, dout, *ctx.blocks)
        return grads + (None,) * 4


def flash_attention(q, k, v, causal=True, window=None, bq=512, bk=512):
    """:class:`FlashAttention` on q [B, S, H, D], k, v [B, Sk, H, D]."""
    return FlashAttention.apply(q, k, v, causal, window, bq, bk)


# ---------------------------------------------------------------------------
# KV cache (decode): [B, S_cache, H_kv, D], a ring when the layer is
# sliding-window (S_cache = window); written in place.
# ---------------------------------------------------------------------------

def init_cache(cfg: AttnConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    s_cache = min(cfg.window or max_seq, max_seq)
    shape = (batch, s_cache, cfg.n_kv_heads, cfg.d_head)
    kv_dtype = torch.int8 if cfg.kv_cache_bits == 8 else dtype
    cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device),
             # per-row slot positions: rows may decode at different
             # absolute positions, so the causal mask is per slot
             "slot_pos": torch.full((batch, s_cache), -1, dtype=torch.int32,
                                    device=device)}
    if cfg.kv_cache_bits == 8:
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
    return cache


def cache_specs(cfg: AttnConfig) -> dict:
    """The reference's logical cache specs: the sequence over "sp" (its
    flash-decoding layout)."""
    s = {"k": Spec("dp", "sp", None, None), "v": Spec("dp", "sp", None, None),
         "slot_pos": Spec("dp", "sp")}
    if cfg.kv_cache_bits == 8:
        s["k_scale"] = Spec("dp", "sp", None)
        s["v_scale"] = Spec("dp", "sp", None)
    return s


def cache_shard_specs(cfg: AttnConfig, split: bool = False) -> dict:
    """Where the port places the cache on a mesh: rows over "dp", KV heads
    over "tp" (a port difference by design; module docstring); with
    ``split`` (:func:`seq_split`) the reference's :func:`cache_specs`."""
    if split:
        return cache_specs(cfg)
    s = {"k": Spec("dp", None, "tp", None), "v": Spec("dp", None, "tp", None),
         "slot_pos": Spec("dp", None)}
    if cfg.kv_cache_bits == 8:
        s["k_scale"] = Spec("dp", None, "tp")
        s["v_scale"] = Spec("dp", None, "tp")
    return s


def _quant_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] -> int8 values and one float32 scale per head
    ([..., H]): absmax / 127 (a true division, floored at 1e-20), values
    rounded half to even and clipped to [-128, 127]."""
    xf = x.to(torch.float32)
    s = torch.clamp_min(true_div(torch.amax(xf.abs(), dim=-1), 127.0), 1e-20)
    xq = torch.clamp(torch.round(xf / s[..., None]), -128, 127)
    return xq.to(torch.int8), s


def _cache_entries(cache: dict, cfg: AttnConfig, k_new, v_new) -> dict:
    """The values one write stores, by cache key: K/V cast to the cache's
    dtype, or on an int8 cache quantized with their scales."""
    if cfg.kv_cache_bits == 8:
        (kq, ks), (vq, vs) = _quant_kv(k_new), _quant_kv(v_new)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k_new.to(cache["k"].dtype), "v": v_new.to(cache["v"].dtype)}


def _bcast(mask: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """A [B|1, S] or [B|1] mask shaped to broadcast against ``val``."""
    return mask.reshape(mask.shape + (1,) * (val.ndim - mask.ndim))


def cache_update(cache: dict, cfg: AttnConfig, k_new, v_new, pos,
                 shard=None) -> dict:
    """Write one token's K/V (k_new, v_new: [B, 1, H_kv, D]) at absolute
    position ``pos`` (slot ``pos % S_cache``), in place; an int8 cache
    stores them quantized, with their scales. ``pos``: an int or a 0-d
    int tensor (the whole batch at one position; the tensor is never read
    on the host) or an int [B] tensor (each row at its own position).

    ``mask_cache_update``: the reference's elementwise write, a ``where``
    over every slot against the slot index. ``shard`` is given for a
    sequence-split cache only: the cache holds this rank's S_cache / sp
    slots, and only the rank owning the slot writes it (a masked write of
    one slot on the others)."""
    s_loc = cache["k"].shape[1]
    split = shard is not None
    s_cache = s_loc * shard.size("sp") if split else s_loc
    lo = shard.rank("sp") * s_loc if split else 0
    new = _cache_entries(cache, cfg, k_new[:, 0], v_new[:, 0])
    b = k_new.shape[0]
    is_t = isinstance(pos, torch.Tensor)
    new["slot_pos"] = (pos.to(torch.int32).expand(b) if is_t else
                       torch.full((b,), pos, dtype=torch.int32,
                                  device=k_new.device))
    per_row = is_t and pos.ndim == 1
    if cfg.mask_cache_update:
        slot = pos % s_cache
        slots = lo + torch.arange(s_loc, device=k_new.device)
        hit = slots[None, :] == (slot[:, None] if per_row else slot)
        for key, val in new.items():
            cache[key].copy_(torch.where(_bcast(hit, cache[key]),
                                         val[:, None], cache[key]))
        return cache
    if is_t:
        local = (pos % s_cache).long().reshape(-1)       # [B] or [1]
        if split:
            local = local - lo
            own = (local >= 0) & (local < s_loc)
            local = local.clamp(0, s_loc - 1)
        rows = torch.arange(b, device=pos.device)
        for key, val in new.items():
            if not per_row:
                val = val[:, None]
            if split:
                old = cache[key][rows, local] if per_row \
                    else cache[key].index_select(1, local)
                val = torch.where(_bcast(own, val), val, old)
            if per_row:
                cache[key][rows, local] = val
            else:
                cache[key].index_copy_(1, local, val)
        return cache
    local = pos % s_cache - lo
    if 0 <= local < s_loc:
        for key, val in new.items():
            cache[key][:, local] = val
    return cache


def _valid_slots(cache: dict, cfg: AttnConfig, pos) -> torch.Tensor:
    """Causal validity mask over cache slots, [B, S_cache]; each row masks
    against its own position when ``pos`` is a [B] tensor."""
    sp = cache["slot_pos"]
    pos_b = pos[:, None] if isinstance(pos, torch.Tensor) and pos.ndim == 1 \
        else pos
    valid = (sp >= 0) & (sp <= pos_b)
    if cfg.window is not None:
        valid &= sp > pos_b - cfg.window
    return valid


def _kv_float(cache: dict, cfg: AttnConfig):
    """The cache's K as [B, G, S, D] and V as [B, G, D, S], float32 and
    contiguous; an int8 cache dequantized (``k.float() * k_scale``, the
    reference's values). The cast from the cache's dtype is always a
    copy, so the two sums of :func:`decode_attend` reduce the last dim
    of contiguous tensors: a sum over a strided dim takes a CUDA
    reduction laid out by the batch (other bits at batch 8 than alone)."""
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    k = cache["k"].permute(0, 2, 1, 3).to(**f32)
    v = cache["v"].permute(0, 2, 3, 1).to(**f32)
    if cfg.kv_cache_bits == 8:
        k = k * cache["k_scale"].permute(0, 2, 1)[..., None]
        v = v * cache["v_scale"].permute(0, 2, 1)[:, :, None, :]
    return k, v


def decode_attend(q, cache: dict, cfg: AttnConfig, pos) -> torch.Tensor:
    """q: [B, 1, Hq, D] against the cache; returns [B, 1, Hq, D] in q's
    dtype. Integer products on an int8 cache with ``attn_int8``
    (:func:`_decode_attend_gqa_int8`); otherwise the queries grouped
    [B, G, R, D] against the un-repeated [B, G, S, D] K and V in float32
    (an int8 cache dequantized first). The reference repeats the KV heads
    unless ``gqa_decode``; the grouped body sums the same products over
    the same dim, so it gives the repeat route's bits without the
    repeated copy, and the port keeps it alone. ``attn_int8`` on a bf16
    cache takes the float route, as in the reference.

    Written so that row b's result does not depend on the other rows,
    and a row of the batching engine's decode equals the same row decoded
    alone: the two float32 products are an elementwise product and a sum
    over the tensor's last, contiguous dim, not ``einsum`` (cuBLAS picks
    its kernel by the batch count; an ``einsum`` gave other bits at batch
    4 than at batch 1 on an H100). Shown on an H100 at batch 4 against 1
    with 448 cache slots and at batch 8 against 1 with 32768
    (``chip_batch_variance.py``); other sizes rest on PyTorch's reduction
    heuristics and are not measured (each of its sums runs over 16 rows
    or more). It materialises float32 copies of K and V and their
    products: at batch 8 and 32768 slots a decode step is about 0.25 s
    of device time and 4 GiB of transient memory on the H100,
    ``attn_int8`` 2.1 GiB (PERF.md)."""
    if cfg.attn_int8 and cfg.kv_cache_bits == 8:
        return _decode_attend_gqa_int8(q, cache, cfg, pos)
    kt, vt = _kv_float(cache, cfg)
    b, _, hq, d = q.shape
    g = cfg.n_kv_heads
    qt = q.reshape(b, g, hq // g, d).to(torch.float32) * d ** -0.5
    logits = (qt[:, :, :, None, :] * kt[:, :, None]).sum(-1)  # [B, G, R, S]
    valid = _valid_slots(cache, cfg, pos)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p_ = torch.softmax(logits, dim=-1)
    out = (p_[:, :, :, None, :] * vt[:, :, None]).sum(-1)     # [B, G, R, D]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a [..., M, K] @ b [..., K, N]`` of int8 operands -> int32,
    the reference's integer ``dot_general``. It runs as float32 batched
    products over runs of at most ``_EXACT_RUN`` of K: every product is at
    most 127 * 128 in magnitude, so each run's sum is an integer below
    2^24, exact in float32 (and TF32: the operands need 8 bits) in any
    order; the runs are summed in int32. Exact, hence the same bits at any
    batch size."""
    k = a.shape[-1]
    if k <= _EXACT_RUN:
        return torch.matmul(a.to(torch.float32),
                            b.to(torch.float32)).to(torch.int32)
    pad = (-k) % _EXACT_RUN
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    n_runs = (k + pad) // _EXACT_RUN
    ar = a.unflatten(-1, (n_runs, _EXACT_RUN)).transpose(-3, -2)
    br = b.unflatten(-2, (n_runs, _EXACT_RUN))      # [..., runs, run, N]
    part = torch.matmul(ar.to(torch.float32), br.to(torch.float32))
    return part.to(torch.int32).sum(-3, dtype=torch.int32)


def _decode_attend_gqa_int8(q, cache, cfg: AttnConfig, pos):
    """Integer decode attention on the int8 cache: q quantized per (batch,
    head) to [-127, 127], QK an exact int32 product (:func:`int8_dot`)
    with the scales folded into the logits, softmax, ``p * v_scale``
    quantized to [0, 127], PV an exact int32 product times its scale. No
    float32 copy of the dequantized cache is built."""
    b, _, hq, d = q.shape
    g = cfg.n_kv_heads
    r = hq // g
    kq = cache["k"].permute(0, 2, 1, 3)                # [B, G, S, D] int8
    vq = cache["v"].permute(0, 2, 1, 3)
    k_scale = cache["k_scale"].permute(0, 2, 1)        # [B, G, S]
    v_scale = cache["v_scale"].permute(0, 2, 1)
    qf = q.reshape(b, g, r, d).to(torch.float32) * d ** -0.5
    q_scale = torch.clamp_min(
        true_div(torch.amax(qf.abs(), dim=-1, keepdim=True), 127.0), 1e-20)
    qi = torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8)
    logits_i = int8_dot(qi, kq.transpose(-1, -2))      # [B, G, R, S]
    logits = logits_i.to(torch.float32) * q_scale * k_scale[:, :, None, :]
    valid = _valid_slots(cache, cfg, pos)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p_ = torch.softmax(logits, dim=-1)
    pv = p_ * v_scale[:, :, None, :]                   # [B, G, R, S]
    p_scale = torch.clamp_min(
        true_div(torch.amax(pv, dim=-1, keepdim=True), 127.0), 1e-20)
    pi = torch.clamp(torch.round(pv / p_scale), 0, 127).to(torch.int8)
    out_i = int8_dot(pi, vq)                           # [B, G, R, D]
    out = out_i.to(torch.float32) * p_scale
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode over a sequence-split cache (flash-decoding): each rank attends
# over its own slots, and one MAX and one SUM over "sp" merge the parts.
# ---------------------------------------------------------------------------

def _partial_float(q, cache: dict, cfg: AttnConfig, pos) -> tuple:
    """(m, l, o) over this rank's slots, the float route: the largest
    logit, the sum of exp(logit - m) and the unnormalised exp-weighted
    sum of V, each [B, G, R, 1 | D]."""
    kt, vt = _kv_float(cache, cfg)
    b, _, hq, d = q.shape
    g = cfg.n_kv_heads
    qt = q.reshape(b, g, hq // g, d).to(torch.float32) * d ** -0.5
    logits = (qt[:, :, :, None, :] * kt[:, :, None]).sum(-1)  # [B, G, R, S]
    valid = _valid_slots(cache, cfg, pos)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p_ = torch.exp(logits - m)
    o = (p_[:, :, :, None, :] * vt[:, :, None]).sum(-1)       # [B, G, R, D]
    return m, p_.sum(-1, keepdim=True), o


def _partial_int8(q, cache: dict, cfg: AttnConfig, pos) -> tuple:
    """(m, l, o) over this rank's slots, the ``attn_int8`` route: exact
    int32 QK and PV products on the stored int8 values, the local
    ``exp(logit - m) * v_scale`` quantized under its own local max (a
    shard's grid, so the merged result is held to the unsharded one by
    tolerance)."""
    b, _, hq, d = q.shape
    g = cfg.n_kv_heads
    r = hq // g
    kq = cache["k"].permute(0, 2, 1, 3)
    vq = cache["v"].permute(0, 2, 1, 3)
    k_scale = cache["k_scale"].permute(0, 2, 1)
    v_scale = cache["v_scale"].permute(0, 2, 1)
    qf = q.reshape(b, g, r, d).to(torch.float32) * d ** -0.5
    q_scale = torch.clamp_min(
        true_div(torch.amax(qf.abs(), dim=-1, keepdim=True), 127.0), 1e-20)
    qi = torch.clamp(torch.round(qf / q_scale), -127, 127).to(torch.int8)
    logits = int8_dot(qi, kq.transpose(-1, -2)).to(torch.float32) \
        * q_scale * k_scale[:, :, None, :]
    valid = _valid_slots(cache, cfg, pos)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p_ = torch.exp(logits - m)
    pv = p_ * v_scale[:, :, None, :]
    p_scale = torch.clamp_min(
        true_div(torch.amax(pv, dim=-1, keepdim=True), 127.0), 1e-20)
    pi = torch.clamp(torch.round(pv / p_scale), 0, 127).to(torch.int8)
    o = int8_dot(pi, vq).to(torch.float32) * p_scale
    return m, p_.sum(-1, keepdim=True), o


def decode_attend_split(q, cache: dict, cfg: AttnConfig, pos,
                        shard) -> torch.Tensor:
    """q: every q head [B, 1, Hq, D] against this rank's slots of a
    sequence-split cache; returns [B, 1, Hq, D], the attention over the
    whole cache on every rank of "sp". Each rank takes its local max m,
    exp-sum l and exp-weighted V sum o (float32; integer products with
    ``attn_int8``), then M = MAX(m) and one SUM of [o e^(m - M), l
    e^(m - M)] over "sp", and o / l. A rank whose slots are all masked
    contributes e^(-1e30 - M) = 0. The sums run in another order than
    :func:`decode_attend`'s, so the result is held to it by tolerance."""
    if cfg.attn_int8 and cfg.kv_cache_bits == 8:
        m, l, o = _partial_int8(q, cache, cfg, pos)
    else:
        m, l, o = _partial_float(q, cache, cfg, pos)
    group = shard.group("sp")
    mx = shard.comm.all_reduce(m.clone(), "max", group)   # reduced in place
    a = torch.exp(m - mx)
    nd = shard.comm.all_reduce(torch.cat([o * a, l * a], dim=-1), "sum",
                               group)
    b, _, hq, d = q.shape
    out = nd[..., :d] / nd[..., d:]
    return out.reshape(b, 1, hq, d).to(q.dtype)


def _attend(q, cache: dict, cfg: AttnConfig, pos, shard,
            place: Place) -> torch.Tensor:
    """A decode step's attention of this rank's q heads: over its own
    cache (unsharded, or placed by heads); over a sequence-split cache,
    every q head (gathered over "tp" unless the rank holds them all)
    against this rank's slots, merged over "sp", so the result holds
    every head."""
    if not place.split:
        return decode_attend(q, cache, cfg, pos)
    if not place.whole:
        q = shard.gather(q, 2)
    return decode_attend_split(q, cache, cfg, pos, shard)


def _owned_runs(first: int, end: int, s_cache: int, lo: int, s_loc: int):
    """(position, local slot, count) runs of the positions [first, end)
    whose ring slot ``p % s_cache`` lies in this rank's [lo, lo + s_loc):
    host arithmetic on the prompt's positions, no tensor read."""
    runs = []
    for p_ in range(first, end):
        local = p_ % s_cache - lo
        if not 0 <= local < s_loc:
            continue
        if runs and runs[-1][0] + runs[-1][2] == p_ \
                and runs[-1][1] + runs[-1][2] == local:
            runs[-1][2] += 1
        else:
            runs.append([p_, local, 1])
    return runs


# ---------------------------------------------------------------------------
# Layer-level entry points
# ---------------------------------------------------------------------------

def apply_train(p, cfg: AttnConfig, x, positions, plan, kv_x=None,
                shard=None):
    """The full-sequence forward (training, and a cross layer's prefill):
    x [B, S, d] -> [B, S, d]. A cross layer attends to ``kv_x`` [B, N, d]
    without rope, causal mask or window. With ``flash_vjp`` a layer whose
    window covers the sequence (or that has none) takes
    :class:`FlashAttention`; a short window keeps autograd's backward,
    whose saved blocks are span-sized already, as the reference chooses."""
    place = placement(cfg, shard)
    cfg = local_cfg(cfg, shard, place)
    q, k, v = _project_qkv(p, cfg, x, positions, plan,
                           kv_x=kv_x if cfg.cross else None, shard=shard,
                           place=place)
    k, v = _kv_for_q(k, cfg, shard, place), _kv_for_q(v, cfg, shard, place)
    causal = not cfg.cross
    win = None if cfg.cross else cfg.window
    if cfg.flash_vjp and (win is None or win >= x.shape[1]):
        out = flash_attention(q, k, v, causal, win, cfg.block, cfg.block)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=win,
                                bq=cfg.block, bk=cfg.block)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.d_head)
    return _o_proj(p, out, plan, shard, whole=place.whole)


def apply_prefill(p, cfg: AttnConfig, x, positions, plan, cache,
                  shard=None):
    """Prefill: full forward over x [B, S, d] (positions [S], the prompt's
    0..S-1), and the cache filled with the last S_cache tokens' K/V (on a
    sequence-split cache, those whose slots this rank holds). Returns
    (out, cache)."""
    place = placement(cfg, shard)
    cfg = local_cfg(cfg, shard, place)
    q, k, v = _project_qkv(p, cfg, x, positions, plan, shard=shard,
                           place=place)
    out = chunked_attention(q, _kv_for_q(k, cfg, shard, place),
                            _kv_for_q(v, cfg, shard, place), causal=True,
                            window=cfg.window)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.d_head)
    out = _o_proj(p, out, plan, shard, whole=place.whole)
    s = x.shape[1]
    s_loc = cache["k"].shape[1]
    if place.split:
        s_cache = s_loc * shard.size("sp")
        take = min(s, s_cache)
        entries = _cache_entries(cache, cfg, k[:, s - take:], v[:, s - take:])
        for p0, l0, n in _owned_runs(s - take, s, s_cache,
                                     shard.rank("sp") * s_loc, s_loc):
            i0 = p0 - (s - take)
            for key, val in entries.items():
                cache[key][:, l0:l0 + n] = val[:, i0:i0 + n]
            cache["slot_pos"][:, l0:l0 + n] = positions[p0:p0 + n]
        return out, cache
    take = min(s, s_loc)
    pos_tail = positions[s - take:]
    slots = (pos_tail % s_loc).long()
    for key, val in _cache_entries(cache, cfg, k[:, s - take:],
                                   v[:, s - take:]).items():
        cache[key][:, slots] = val
    cache["slot_pos"][:, slots] = pos_tail.to(torch.int32)
    return out, cache


def apply_decode(p, cfg: AttnConfig, x, pos, plan, cache, shard=None):
    """One-token decode. x: [B, 1, d]; ``pos`` an int, a 0-d int tensor
    (never read on the host) or an int [B] tensor. Returns (out [B, 1, d],
    cache)."""
    place = placement(cfg, shard)
    cfg = local_cfg(cfg, shard, place)
    whole = place.whole or place.split
    if isinstance(pos, torch.Tensor):
        positions = pos[:, None] if pos.ndim == 1 else pos.reshape(1)
    else:
        positions = torch.arange(int(pos), int(pos) + 1, device=x.device)
    b = x.shape[0]
    q = _q_proj(p, x, plan, cfg, shard, place)
    if cfg.cross:
        # The image K/V were projected into the cache at prefill.
        if cfg.qk_norm:
            q = L.rms_norm(q, p["qnorm"]["g"])
        out = _attend(q, cache, cfg, pos, shard, place).reshape(b, 1, -1)
        return _o_proj(p, out, plan, shard, whole=whole), cache
    k = _kv_proj(p["wk"], x, plan, "attn_k", cfg, shard, place)
    k = k.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = _kv_proj(p["wv"], x, plan, "attn_v", cfg, shard, place)
    v = v.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_norm(q, _head_local(p["qnorm"]["g"], shard, place))
        k = L.rms_norm(k, _head_local(p["knorm"]["g"], shard, place))
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    cache = cache_update(cache, cfg, k, v, pos,
                         shard if place.split else None)
    out = _attend(q, cache, cfg, pos, shard, place).reshape(b, 1, -1)
    return _o_proj(p, out, plan, shard, whole=whole), cache


# ---------------------------------------------------------------------------
# Cross-attention (the image layers of llama-3.2-vision)
# ---------------------------------------------------------------------------

def init_cross_cache(p, cfg: AttnConfig, img_embeds, plan, cache,
                     shard=None) -> dict:
    """Project the image embeddings [B, N, d] into a cross layer's cache,
    in place: ``k`` and ``v`` [B, N, H_kv, D] bf16 (K RMSNorm'd with
    ``qk_norm``), ``slot_pos`` zeros (every slot valid); on a
    sequence-split cache this rank's N / sp image tokens. Returns it."""
    place = placement(cfg, shard)
    cfg = local_cfg(cfg, shard, place)
    b, n, _ = img_embeds.shape
    k = _kv_proj(p["wk"], img_embeds, plan, "attn_k", cfg, shard,
                 place).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
    v = _kv_proj(p["wv"], img_embeds, plan, "attn_v", cfg, shard,
                 place).reshape(b, n, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = L.rms_norm(k, p["knorm"]["g"])
    if place.split:
        k, v = shard.take(k, 1, "sp"), shard.take(v, 1, "sp")
    cache["k"].copy_(k.to(torch.bfloat16))
    cache["v"].copy_(v.to(torch.bfloat16))
    cache["slot_pos"].zero_()
    return cache
