"""The plain reference of deepseek-moe-16b (arXiv:2401.06066 and the
published config) as it is served at (Pa, Pw), in float32, one sequence
at a time, over the whole sequence at once.

Per layer: RMSNorm (eps 1e-6, gain 1 + g), multi-head attention (q, k,
v, o projections, rotate-half RoPE of theta ``rope_theta``, causal
softmax at d_head^-0.5), residual; RMSNorm, then the dense gated SiLU
FFN on the first ``first_k_dense_replace`` layers and the MoE on the
others, residual; a final RMSNorm and the head. The MoE: a float32
softmax router over ``n_routed_experts``, the ``num_experts_per_tok``
largest gates, each routed expert a gated SiLU FFN of
``moe_intermediate_size``, plus ``n_shared_experts`` shared experts as
one gated FFN of their summed width.

How it is served, which the configuration file lists as departures from
the published layer: every projection, the dense FFN, the shared
experts and the head are served linears (activations per token at
``a_bits``, weights per tensor at ``w_bits``, an exact integer
product); each routed expert's weights are quantized at ``w_bits``
under one scale per expert and take the activations unquantized; the
top-k gates are renormalised to sum 1 (``norm_topk_prob``); and a
prompt's tokens pass a capacity dispatch: in (token, choice) order each
expert takes at most ``max(1, int(S * k / E * capacity_factor))`` of the
S prompt tokens' choices, later ones are dropped. A generated token is
routed alone and never dropped.
"""
from __future__ import annotations

import torch

from perfbench.reference import quant

# Query rows attention takes at a time.
_Q_BLOCK = 1024


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    ms = (x * x).mean(-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * (1.0 + g.to(torch.float32))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D] at positions 0..S-1, rotate-half."""
    s, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, q, k, v [S, H, D] -> [S, H * D]."""
    s, h, d = q.shape
    qt, kt, vt = (t.permute(1, 0, 2) for t in (q, k, v))
    out = []
    for i in range(0, s, _Q_BLOCK):
        logits = qt[:, i:i + _Q_BLOCK] @ kt.transpose(1, 2) * d ** -0.5
        rows = torch.arange(i, min(i + _Q_BLOCK, s), device=q.device)
        mask = torch.arange(s, device=q.device)[None, :] <= rows[:, None]
        logits = torch.where(mask, logits, float("-inf"))
        out.append(torch.softmax(logits, dim=-1) @ vt)
    return torch.cat(out, dim=1).permute(1, 0, 2).reshape(s, h * d)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gated_ffn(p: dict, x: torch.Tensor, a: int, w: int) -> torch.Tensor:
    g = quant.loom_linear(x, p["w_gate"]["w"], a, w)
    u = quant.loom_linear(x, p["w_up"]["w"], a, w)
    return quant.loom_linear(silu(g) * u, p["w_down"]["w"], a, w)


def expert_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """One expert's weight [din, dout] quantized at ``bits`` under its own
    scale, scaled back (float32)."""
    wq, s = quant.quantize_weight(w, bits)
    return wq * s


def moe(p: dict, cfg: dict, x: torch.Tensor, prompt_len: int, a: int,
        w: int) -> torch.Tensor:
    """The MoE layer over x [S, d]: the first ``prompt_len`` tokens one
    prefill (capacity dispatch), the rest one token each."""
    s, _ = x.shape
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    gates = torch.softmax(x @ p["router"]["w"].to(torch.float32), dim=-1)
    probs, ids = torch.topk(gates, k, dim=-1)                  # [S, k]
    if cfg["norm_topk_prob"]:
        probs = probs / probs.sum(-1, keepdim=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    cap = max(1, int(prompt_len * k / e * cfg["capacity_factor"]))
    flat = ids[:prompt_len].reshape(-1)
    onehot = flat[:, None] == torch.arange(e, device=x.device)
    place = (torch.cumsum(onehot.to(torch.int64), 0) - 1).gather(
        1, flat[:, None])[:, 0]
    keep[:prompt_len] = (place < cap).reshape(prompt_len, k)
    out = torch.zeros_like(x)
    for j in range(e):
        tok, choice = torch.nonzero((ids == j) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = silu(xe @ expert_weight(p["w_gate"][j], w)) \
            * (xe @ expert_weight(p["w_up"][j], w))
        ye = h @ expert_weight(p["w_down"][j], w)
        out.index_add_(0, tok, ye * probs[tok, choice][:, None])
    if cfg["n_shared_experts"]:
        out = out + gated_ffn(p["shared"], x, a, w)
    return out


def block_params(params: dict, layer: int) -> dict:
    """Layer ``layer``'s params: position ``p<layer>`` of the stacked
    blocks, group 0 (each layer is its own pattern position)."""
    def first(t):
        return {k: first(v) for k, v in t.items()} \
            if isinstance(t, dict) else t[0]
    return first(params["blocks"][f"p{layer}"])


def forward(params: dict, cfg: dict, tokens: torch.Tensor, prompt_len: int,
            first: int, a_bits: int, w_bits: int) -> torch.Tensor:
    """Logits float32 [S - first, vocab] at positions first..S-1 of the
    sequence ``tokens`` [S] (a prompt of ``prompt_len`` tokens and the
    tokens generated after it)."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h_, hd = cfg["num_attention_heads"], cfg["head_dim"]
    kv = cfg["num_key_value_heads"]
    x = params["embed"]["emb"][tokens].to(torch.float32)
    s = x.shape[0]
    for layer in range(cfg["num_hidden_layers"]):
        p = block_params(params, layer)
        h = rms_norm(x, p["ln1"]["g"], eps)
        mix = p["mix"]
        q = quant.loom_linear(h, mix["wq"]["w"], a_bits, w_bits)
        k = quant.loom_linear(h, mix["wk"]["w"], a_bits, w_bits)
        v = quant.loom_linear(h, mix["wv"]["w"], a_bits, w_bits)
        q = rope(q.reshape(s, h_, hd), theta)
        k = rope(k.reshape(s, kv, hd), theta)
        v = v.reshape(s, kv, hd)
        rep = h_ // kv
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        x = x + quant.loom_linear(attention(q, k, v), mix["wo"]["w"],
                                  a_bits, w_bits)
        h = rms_norm(x, p["ln2"]["g"], eps)
        if layer < cfg["first_k_dense_replace"]:
            x = x + gated_ffn(p["ffn"], h, a_bits, w_bits)
        else:
            x = x + moe(p["ffn"], cfg, h, prompt_len, a_bits, w_bits)
    x = rms_norm(x[first:], params["final_norm"]["g"], eps)
    return quant.loom_linear(x, params["head"]["w"], a_bits, w_bits)
