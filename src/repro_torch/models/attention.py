"""Attention for serving: GQA self-attention (full or sliding-window), the
blockwise prefill path, and decode over the KV cache.

PyTorch-port counterpart of the serving half of ``repro/models/
attention.py``. All four projections are Loom linears (through the plan).
Prefill runs :func:`chunked_attention`, plain PyTorch with an online
softmax, as the reference's prefill does; the kernel K7 is reached through
``kernels.ops.attention`` only. Decode repeats the KV heads and attends
over the whole cache, masked by each slot's recorded position, in a
batch-invariant form (:func:`decode_attend`).

The KV cache is ``{"k", "v": [B, S_cache, H_kv, D] bf16, "slot_pos": int32
[B, S_cache]}`` (a ring of ``window`` slots for a sliding-window layer).
Where the reference returns a new cache, the port writes the cache it is
given in place: a decode step then moves one slot, not the whole cache.

Not ported (ROADMAP A.6): the int8 KV cache (``kv_cache_bits=8``), the
grouped decode routes (``gqa_decode``, ``attn_int8``), cross-attention,
and the training path with its flash backward.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 500000.0
    qk_norm: bool = False
    window: int | None = None          # sliding-window size (None = full)
    gqa_decode: bool = False           # grouped decode einsum (not ported)
    attn_int8: bool = False            # integer decode attention (not ported)
    cross: bool = False                # cross-attention (not ported)
    kv_cache_bits: int = 16            # 16 = bf16 cache; 8 not ported


def _check_ported(cfg: AttnConfig) -> None:
    for flag, what in ((cfg.kv_cache_bits != 16, "the int8 KV cache"),
                       (cfg.gqa_decode or cfg.attn_int8,
                        "the grouped decode routes"),
                       (cfg.cross, "cross-attention")):
        if flag:
            raise NotImplementedError(f"{what} is not ported yet "
                                      f"(ROADMAP A.6)")


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


def _project_qkv(p, cfg: AttnConfig, x, positions, plan):
    q = L.linear_apply(p["wq"], x, plan, "attn_q")
    q = q.reshape(*x.shape[:-1], cfg.n_heads, cfg.d_head)
    k = L.linear_apply(p["wk"], x, plan, "attn_k")
    k = k.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    v = L.linear_apply(p["wv"], x, plan, "attn_v")
    v = v.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["qnorm"]["g"])
        k = L.rms_norm(k, p["knorm"]["g"])
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def chunked_attention(q, k, v, *, causal=True, window=None, bq=512, bk=512,
                      q_offset=0):
    """Blockwise (flash) attention in plain PyTorch: loops over q and kv
    blocks with an online softmax in float32.

    q: [B, S, H, D]; k, v: [B, Sk, H, D] (one head count). A sliding-window
    layer's q block attends only its (window + bq)-wide KV span. q_offset:
    absolute position of q[0]. Output [B, S, H, D] in q's dtype.

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
    outs = []
    for iq in range(s // bq):
        qblk = qt[:, :, iq * bq:(iq + 1) * bq].to(torch.float32) * scale
        q_first = q_offset + iq * bq
        q_pos = q_first + torch.arange(bq, device=dev)
        if window is not None and sk > window + bq:
            span = -(-(window + bq) // bk) * bk
            start = min(max(q_first - window + 1, 0), sk - span)
        else:
            span, start = sk, 0
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
            mask = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                mask &= kp[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= kp[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits, NEG_INF)
            m_cur = torch.maximum(m, logits.amax(-1))
            p_ = torch.exp(logits - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = l * alpha + p_.sum(-1)
            o = o * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p_, vs_)
            m = m_cur
        out = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# KV cache (decode): [B, S_cache, H_kv, D], a ring when the layer is
# sliding-window (S_cache = window); written in place.
# ---------------------------------------------------------------------------

def init_cache(cfg: AttnConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> dict:
    _check_ported(cfg)
    s_cache = min(cfg.window or max_seq, max_seq)
    shape = (batch, s_cache, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            # per-row slot positions: rows may decode at different
            # absolute positions, so the causal mask is per slot
            "slot_pos": torch.full((batch, s_cache), -1, dtype=torch.int32,
                                   device=device)}


def cache_update(cache: dict, cfg: AttnConfig, k_new, v_new, pos) -> dict:
    """Write one token's K/V (k_new, v_new: [B, 1, H_kv, D]) at absolute
    position ``pos`` (slot ``pos % S_cache``), in place. ``pos``: an int
    (the whole batch at one position) or an int [B] tensor (each row at its
    own position)."""
    _check_ported(cfg)
    s_cache = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        rows = torch.arange(pos.shape[0], device=pos.device)
        slot = (pos % s_cache).long()
        cache["k"][rows, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v_new[:, 0].to(cache["v"].dtype)
        cache["slot_pos"][rows, slot] = pos.to(torch.int32)
        return cache
    slot = pos % s_cache
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
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


def decode_attend(q, cache: dict, cfg: AttnConfig, pos) -> torch.Tensor:
    """q: [B, 1, Hq, D] against the cache (KV heads repeated); returns
    [B, 1, Hq, D] in q's dtype.

    Written so that row b's result does not depend on the other rows,
    and a row of the batching engine's decode equals the same row decoded
    alone: the two float32 products are an elementwise product and a sum
    over the tensor's last, contiguous dim, not ``einsum`` (cuBLAS picks
    its kernel by the batch count; an ``einsum`` gave other bits at batch
    4 than at batch 1 on an H100). Shown on an H100 at batch 4 against 1
    with 448 cache slots and at batch 8 against 1 with 32768
    (``chip_batch_variance.py``); other sizes rest on PyTorch's reduction
    heuristics and are not measured. It materialises float32 copies of
    K and V and their products: at batch 8 and 32768 slots a decode step
    is about 0.4 s of device time and 6 GiB of transient memory on the
    H100 (PERF.md)."""
    _check_ported(cfg)
    d = q.shape[-1]
    n_rep = q.shape[2] // cfg.n_kv_heads
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    kh = _repeat_kv(cache["k"], n_rep).permute(0, 2, 1, 3).to(**f32)
    vt = _repeat_kv(cache["v"], n_rep).permute(0, 2, 3, 1).to(**f32)
    qt = q.permute(0, 2, 1, 3).to(torch.float32) * d ** -0.5  # [B, Hq, 1, D]
    logits = (qt * kh).sum(-1)[:, :, None, :]                 # [B, Hq, 1, S]
    valid = _valid_slots(cache, cfg, pos)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p_ = torch.softmax(logits, dim=-1)
    out = (p_ * vt).sum(-1)[:, :, None, :]                    # [B, Hq, 1, D]
    return out.permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# Layer-level entry points
# ---------------------------------------------------------------------------

def apply_prefill(p, cfg: AttnConfig, x, positions, plan, cache):
    """Prefill: full forward over x [B, S, d] (positions [S]), and the
    cache filled with the last S_cache tokens' K/V. Returns (out, cache)."""
    _check_ported(cfg)
    q, k, v = _project_qkv(p, cfg, x, positions, plan)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    out = chunked_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep),
                            causal=True, window=cfg.window)
    out = out.reshape(*x.shape[:-1], cfg.n_heads * cfg.d_head)
    s = x.shape[1]
    s_cache = cache["k"].shape[1]
    take = min(s, s_cache)
    pos_tail = positions[s - take:]
    slots = (pos_tail % s_cache).long()
    cache["k"][:, slots] = k[:, s - take:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, s - take:].to(cache["v"].dtype)
    cache["slot_pos"][:, slots] = pos_tail.to(torch.int32)
    return L.linear_apply(p["wo"], out, plan, "attn_o"), cache


def apply_decode(p, cfg: AttnConfig, x, pos, plan, cache):
    """One-token decode. x: [B, 1, d]; ``pos`` an int or an int [B]
    tensor. Returns (out [B, 1, d], cache)."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        positions = pos[:, None]                       # [B, 1]
    else:
        positions = torch.arange(int(pos), int(pos) + 1, device=x.device)
    b = x.shape[0]
    q = L.linear_apply(p["wq"], x, plan, "attn_q")
    q = q.reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = L.linear_apply(p["wk"], x, plan, "attn_k")
    k = k.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = L.linear_apply(p["wv"], x, plan, "attn_v")
    v = v.reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["qnorm"]["g"])
        k = L.rms_norm(k, p["knorm"]["g"])
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    cache = cache_update(cache, cfg, k, v, pos)
    out = decode_attend(q, cache, cfg, pos)
    out = out.reshape(b, 1, cfg.n_heads * cfg.d_head)
    return L.linear_apply(p["wo"], out, plan, "attn_o"), cache
