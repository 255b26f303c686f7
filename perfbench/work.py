"""The benchmark's yardstick: the H100's peaks, the work of the port's
Loom kernels at a call's shapes, and the model's operations.

The kernel formulas are a frozen copy of ``src/repro_torch/kernels/work.py``
(K1, K2 and K5, the kernels the cells' per-layer metrics read), kept here
so that the yardstick does not move when the program does. A kernel's
least time is the larger of its bytes over the HBM3 rate and its
operations over the peak of their type. Bytes: each input read once,
each output written once. Operations: one multiply-add (2 operations)
per term of the integer product.

The peaks are the H100 SXM datasheet's dense rates (80 GB HBM3 at 700 W);
a card set below 700 W reaches less, so every share is printed beside the
card's power limit.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 bandwidth
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores

PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S,
         "int8_ops_per_s": INT8_OPS_PER_S,
         "bf16_flops": BF16_FLOPS, "f32_flops": F32_FLOPS}


def least_s(nbytes: float, ops: float, peak: float = INT8_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def k1_work(m: int, k: int, n: int, w_bits: int) -> tuple:
    """(bytes, operations) of one K1 call, int8 x [M, K] against packed
    planes uint8 [Pw, K/8, N] -> int32 [M, N] (K padded to a multiple of
    8, as the packed layout pads it)."""
    k8 = -(-k // 8) * 8
    nbytes = m * k8 + w_bits * (k8 // 8) * n + 4 * m * n
    return nbytes, 2 * m * n * k8


def conv_out_side(side: int, stride: int) -> int:
    return -(-side // stride)


def k2_work(b: int, h: int, w: int, c: int, n: int, kernel: int,
            stride: int, w_bits: int) -> tuple:
    """(bytes, operations) of one K2 call: int8 x [B, H, W, C] against
    packed planes uint8 [Pw, ceil(k*k*C/8), N] -> int32 [B, Ho, Wo, N]."""
    kkc = kernel * kernel * c
    out = b * conv_out_side(h, stride) * conv_out_side(w, stride) * n
    nbytes = b * h * w * c + w_bits * (-(-kkc // 8)) * n + 4 * out
    return nbytes, 2 * out * kkc


def k5_work(b: int, h: int, w: int, c: int, n: int, kernel: int,
            stride: int, n_groups: int) -> tuple:
    """(bytes, operations) of one K5 call: int8 x [B, H, W, C] against
    dense int8 weights [k*k*C, N] and int32 plane counts [B, G] -> int32
    [B, Ho, Wo, N]. The tensor cores take all eight planes of an int8
    operand in one product, so the operations are the static conv's."""
    kkc = kernel * kernel * c
    out = b * conv_out_side(h, stride) * conv_out_side(w, stride) * n
    nbytes = b * h * w * c + kkc * n + 4 * b * n_groups + 4 * out
    return nbytes, 2 * out * kkc


# -- the model's operations --------------------------------------------------

def cnn_macs_per_image(cfg: dict) -> int:
    """Multiply-adds of one image through every conv and fc of a CNN
    configuration (``configs/vgg19.json``'s sizes)."""
    side, ch, macs = cfg["image_size"], cfg["in_channels"], 0
    for conv in cfg["convs"]:
        out_side = conv_out_side(side, conv["stride"])
        macs += out_side * out_side * conv["filters"] * conv["kernel"] ** 2 * ch
        side, ch = out_side // conv["pool"], conv["filters"]
    d_in = side * side * ch
    for width in cfg["fcs"]:
        macs += d_in * width
        d_in = width
    return macs


def conv_shapes(cfg: dict, batch: int) -> list:
    """(B, H, W, C, N, kernel, stride) of each conv of one request."""
    side, ch, out = cfg["image_size"], cfg["in_channels"], []
    for conv in cfg["convs"]:
        out.append((batch, side, side, ch, conv["filters"], conv["kernel"],
                    conv["stride"]))
        side = conv_out_side(side, conv["stride"]) // conv["pool"]
        ch = conv["filters"]
    return out


def lm_linears(cfg: dict) -> list:
    """(name, K, N) of every Loom linear of one token's pass through a
    MoE LM configuration (``configs/deepseek-moe-16b-l5.json``'s sizes),
    the head last: per layer q, k, v, o; the dense FFN's gate, up, down
    on the first ``first_k_dense_replace`` layers; the shared experts'
    gate, up, down on the others."""
    d, hd = cfg["hidden_size"], cfg["num_attention_heads"] * cfg["head_dim"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    shared = cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    out = []
    for layer in range(cfg["num_hidden_layers"]):
        out += [("q", d, hd), ("k", d, kvd), ("v", d, kvd), ("o", hd, d)]
        if layer < cfg["first_k_dense_replace"]:
            f = cfg["intermediate_size"]
            out += [("ffn_gate", d, f), ("ffn_up", d, f), ("ffn_down", f, d)]
        else:
            out += [("shared_gate", d, shared), ("shared_up", d, shared),
                    ("shared_down", shared, d)]
    out.append(("head", d, cfg["vocab_size"]))
    return out


def lm_macs_per_token(cfg: dict, ctx: int, head: bool) -> int:
    """Multiply-adds of one token at context length ``ctx`` (the keys it
    attends to): every linear of :func:`lm_linears` (the head only where
    its logits are computed, ``head``), the router, the routed experts at
    ``num_experts_per_tok`` of ``n_routed_experts``, and attention's QK
    and PV over ``ctx`` keys in every layer."""
    lin = lm_linears(cfg)
    macs = sum(k * n for name, k, n in lin if name != "head")
    if head:
        macs += cfg["hidden_size"] * cfg["vocab_size"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    macs += moe_layers * (d * cfg["n_routed_experts"]
                          + cfg["num_experts_per_tok"] * 3 * d * f)
    hd = cfg["num_attention_heads"] * cfg["head_dim"]
    macs += cfg["num_hidden_layers"] * 2 * hd * ctx
    return macs


def lm_prefill_macs(cfg: dict, s: int) -> int:
    """A prompt of ``s`` tokens, causal (token i attends to i + 1 keys),
    the head on its last token only."""
    base = lm_macs_per_token(cfg, 0, head=False)
    hd = cfg["num_attention_heads"] * cfg["head_dim"]
    attn = cfg["num_hidden_layers"] * 2 * hd * (s * (s + 1) // 2)
    return s * base + attn + cfg["hidden_size"] * cfg["vocab_size"]
