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
bit-exact.

Cross-attention (llama-3.2-vision's image layers): the prefill projects
the image embeddings' K/V into the layer's cache
(:func:`init_cross_cache`) and attends to them non-causally through the
training forward (:func:`apply_train` with ``kv_x``), as the reference's
prefill does; a decode step projects q alone, unroped, against that
cache, which it leaves unchanged.
"""
from __future__ import annotations

import dataclasses

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
    gqa_decode: bool = False           # the reference's; no route here
    attn_int8: bool = False            # integer QK/PV on the int8 cache
    cross: bool = False                # cross-attention (K/V from images)
    kv_cache_bits: int = 16            # 16 = bf16 cache; 8 = int8 cache
    block: int = 512                   # training q/kv block size


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


def param_specs(cfg: AttnConfig) -> dict:
    """Logical specs of :func:`init`'s tree."""
    s = {"wq": L.linear_specs(*WQ_AXES), "wk": L.linear_specs(*WKV_AXES),
         "wv": L.linear_specs(*WKV_AXES), "wo": L.linear_specs(*WO_AXES)}
    if cfg.qk_norm:
        s["qnorm"], s["knorm"] = L.norm_specs(), L.norm_specs()
    return s


def local_cfg(cfg: AttnConfig, shard) -> AttnConfig:
    """``cfg`` with this rank's q and KV heads (``cfg`` itself without a
    mesh)."""
    if shard is None:
        return cfg
    return dataclasses.replace(cfg, n_heads=shard.local(cfg.n_heads),
                               n_kv_heads=shard.local(cfg.n_kv_heads))


def _kv_proj(p, x, plan, name, shard):
    """K or V of ``x``: on a mesh the rank's KV heads' columns of the
    row-parallel product, reduce-scattered over "model"."""
    return L.linear_apply(p, x, plan, name, lin(shard, *WKV_AXES,
                                                scatter=True))


def _o_proj(p, out, plan, shard):
    return L.linear_apply(p["wo"], out, plan, "attn_o",
                          lin(shard, *WO_AXES, x_local=True))


def _head_local(gamma, shard):
    """A replicated ``qk_norm`` gain applied to this rank's heads only:
    its gradient is partial on each rank and SUM-reduced over "model"."""
    return gamma if shard is None else shard.copy_to(gamma)


def _project_qkv(p, cfg: AttnConfig, x, positions, plan, kv_x=None,
                 shard=None):
    """q from x, K and V from ``kv_x`` (a cross layer's image embeddings;
    x itself when None); RMSNorm'd with ``qk_norm``; roped unless
    cross. ``cfg`` carries the rank's heads on a mesh."""
    kv_x = x if kv_x is None else kv_x
    q = L.linear_apply(p["wq"], x, plan, "attn_q", lin(shard, *WQ_AXES))
    q = q.reshape(*x.shape[:-1], cfg.n_heads, cfg.d_head)
    k = _kv_proj(p["wk"], kv_x, plan, "attn_k", shard)
    k = k.reshape(*kv_x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    v = _kv_proj(p["wv"], kv_x, plan, "attn_v", shard)
    v = v.reshape(*kv_x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_norm(q, _head_local(p["qnorm"]["g"], shard))
        k = L.rms_norm(k, _head_local(p["knorm"]["g"], shard))
    if not cfg.cross:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


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


def cache_shard_specs(cfg: AttnConfig) -> dict:
    """Where the port places the cache on a mesh: rows over "dp", KV heads
    over "tp" (a port difference by design; module docstring)."""
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


def cache_update(cache: dict, cfg: AttnConfig, k_new, v_new, pos) -> dict:
    """Write one token's K/V (k_new, v_new: [B, 1, H_kv, D]) at absolute
    position ``pos`` (slot ``pos % S_cache``), in place; an int8 cache
    stores them quantized, with their scales. ``pos``: an int (the whole
    batch at one position) or an int [B] tensor (each row at its own
    position)."""
    s_cache = cache["k"].shape[1]
    new = _cache_entries(cache, cfg, k_new[:, 0], v_new[:, 0])
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        rows = torch.arange(pos.shape[0], device=pos.device)
        slot = (pos % s_cache).long()
        for key, val in new.items():
            cache[key][rows, slot] = val
        cache["slot_pos"][rows, slot] = pos.to(torch.int32)
        return cache
    slot = pos % s_cache
    for key, val in new.items():
        cache[key][:, slot] = val
    cache["slot_pos"][:, slot] = pos
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
    cfg = local_cfg(cfg, shard)
    q, k, v = _project_qkv(p, cfg, x, positions, plan,
                           kv_x=kv_x if cfg.cross else None, shard=shard)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    causal = not cfg.cross
    win = None if cfg.cross else cfg.window
    if cfg.flash_vjp and (win is None or win >= x.shape[1]):
        out = flash_attention(q, k, v, causal, win, cfg.block, cfg.block)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=win,
                                bq=cfg.block, bk=cfg.block)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.d_head)
    return _o_proj(p, out, plan, shard)


def apply_prefill(p, cfg: AttnConfig, x, positions, plan, cache,
                  shard=None):
    """Prefill: full forward over x [B, S, d] (positions [S]), and the
    cache filled with the last S_cache tokens' K/V. Returns (out, cache)."""
    cfg = local_cfg(cfg, shard)
    q, k, v = _project_qkv(p, cfg, x, positions, plan, shard=shard)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                            causal=True, window=cfg.window)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.d_head)
    s = x.shape[1]
    s_cache = cache["k"].shape[1]
    take = min(s, s_cache)
    pos_tail = positions[s - take:]
    slots = (pos_tail % s_cache).long()
    for key, val in _cache_entries(cache, cfg, k[:, s - take:],
                                   v[:, s - take:]).items():
        cache[key][:, slots] = val
    cache["slot_pos"][:, slots] = pos_tail.to(torch.int32)
    return _o_proj(p, out, plan, shard), cache


def apply_decode(p, cfg: AttnConfig, x, pos, plan, cache, shard=None):
    """One-token decode. x: [B, 1, d]; ``pos`` an int or an int [B]
    tensor. Returns (out [B, 1, d], cache)."""
    cfg = local_cfg(cfg, shard)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos[:, None]                       # [B, 1]
    else:
        positions = torch.arange(int(pos), int(pos) + 1, device=x.device)
    b = x.shape[0]
    q = L.linear_apply(p["wq"], x, plan, "attn_q", lin(shard, *WQ_AXES))
    q = q.reshape(b, 1, cfg.n_heads, cfg.d_head)
    if cfg.cross:
        # The image K/V were projected into the cache at prefill.
        if cfg.qk_norm:
            q = L.rms_norm(q, p["qnorm"]["g"])
        out = decode_attend(q, cache, cfg, pos)
        out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
        return _o_proj(p, out, plan, shard), cache
    k = _kv_proj(p["wk"], x, plan, "attn_k", shard)
    k = k.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = _kv_proj(p["wv"], x, plan, "attn_v", shard)
    v = v.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_norm(q, _head_local(p["qnorm"]["g"], shard))
        k = L.rms_norm(k, _head_local(p["knorm"]["g"], shard))
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    cache = cache_update(cache, cfg, k, v, pos)
    out = decode_attend(q, cache, cfg, pos)
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return _o_proj(p, out, plan, shard), cache


# ---------------------------------------------------------------------------
# Cross-attention (the image layers of llama-3.2-vision)
# ---------------------------------------------------------------------------

def init_cross_cache(p, cfg: AttnConfig, img_embeds, plan, cache,
                     shard=None) -> dict:
    """Project the image embeddings [B, N, d] into a cross layer's cache,
    in place: ``k`` and ``v`` [B, N, H_kv, D] bf16 (K RMSNorm'd with
    ``qk_norm``), ``slot_pos`` zeros (every slot valid). Returns it."""
    cfg = local_cfg(cfg, shard)
    b, n, _ = img_embeds.shape
    k = _kv_proj(p["wk"], img_embeds, plan, "attn_k", shard).reshape(
        b, n, cfg.n_kv_heads, cfg.d_head)
    v = _kv_proj(p["wv"], img_embeds, plan, "attn_v", shard).reshape(
        b, n, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        k = L.rms_norm(k, p["knorm"]["g"])
    cache["k"].copy_(k.to(torch.bfloat16))
    cache["v"].copy_(v.to(torch.bfloat16))
    cache["slot_pos"].zero_()
    return cache
