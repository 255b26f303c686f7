"""Dense weights drawn from the run's seed on the device, in the tree
layout that ``repro_torch.compile(..., params=...)`` takes and that the
references read. Every weight matrix [fan_in, fan_out] is N(0, 1/fan_in);
the embedding N(0, 0.02^2); norm gains 0 (a gain of 1 + g). A model's
matrices come from one large draw, split into views; the same seed gives
the same tree on every call.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run, from ``seed`` and ``tag``."""
    words = [int(seed) % (1 << 64), *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]) >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def _fill(shapes: dict, seed: int, tag: str, device, dtype) -> dict:
    """Views of one N(0, 1) draw, one per shape, each scaled by its
    ``1/sqrt(fan_in)`` (dim -2 of the shape)."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, tag, device),
                       dtype=dtype, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        out[name] = flat[at:at + n].view(shape).mul_(shape[-2] ** -0.5)
        at += n
    return out


def cnn_params(cfg: dict, seed: int, device) -> dict:
    """``{layer: {"w": float32 [fan_in, fan_out]}}`` of a CNN config."""
    shapes, side, ch = {}, cfg["image_size"], cfg["in_channels"]
    for conv in cfg["convs"]:
        shapes[conv["name"]] = (conv["kernel"] ** 2 * ch, conv["filters"])
        side = -(-side // conv["stride"]) // conv["pool"]
        ch = conv["filters"]
    d_in = side * side * ch
    for i, width in enumerate(cfg["fcs"]):
        shapes[f"fc{i}"] = (d_in, width)
        d_in = width
    w = _fill(shapes, seed, "cnn", device, torch.float32)
    return {name: {"w": t} for name, t in w.items()}


def lm_params(cfg: dict, seed: int, device) -> dict:
    """A MoE LM's dense tree in bf16 (the router float32): ``embed``,
    ``final_norm``, ``head`` and ``blocks/p<i>`` for each layer i, each
    leaf with a leading group axis of 1."""
    d, e = cfg["hidden_size"], cfg["n_routed_experts"]
    hd = cfg["num_attention_heads"] * cfg["head_dim"]
    kvd = cfg["num_key_value_heads"] * cfg["head_dim"]
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    sf = cfg["n_shared_experts"] * fe
    shapes, routers = {"head": (d, cfg["vocab_size"])}, {}
    for i in range(cfg["num_hidden_layers"]):
        for name, shape in (("wq", (d, hd)), ("wk", (d, kvd)),
                            ("wv", (d, kvd)), ("wo", (hd, d))):
            shapes[f"{i}/mix/{name}"] = (1,) + shape
        if i < cfg["first_k_dense_replace"]:
            ffn = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
        else:
            ffn = {"w_gate": (e, d, fe), "w_up": (e, d, fe),
                   "w_down": (e, fe, d), "shared/w_gate": (d, sf),
                   "shared/w_up": (d, sf), "shared/w_down": (sf, d)}
            routers[f"{i}/ffn/router"] = (1, d, e)
        for name, shape in ffn.items():
            shapes[f"{i}/ffn/{name}"] = (1,) + shape
    w = _fill(shapes, seed, "lm", device, torch.bfloat16)
    w.update(_fill(routers, seed, "router", device, torch.float32))
    emb = torch.randn((cfg["vocab_size"], d),
                      generator=generator(seed, "embed", device),
                      dtype=torch.bfloat16, device=device).mul_(0.02)

    def zeros():
        return torch.zeros((1, d), dtype=torch.bfloat16, device=device)

    blocks = {}
    for i in range(cfg["num_hidden_layers"]):
        blk = {"ln1": {"g": zeros()}, "ln2": {"g": zeros()}, "mix": {},
               "ffn": {}}
        for path, t in w.items():
            head, _, rest = path.partition("/")
            if head != str(i):
                continue
            part, _, name = rest.partition("/")
            if name in ("w_gate", "w_up", "w_down") and t.ndim == 4:
                blk[part][name] = t                     # experts, raw
            elif name.startswith("shared/"):
                blk[part].setdefault("shared", {})[name[7:]] = {"w": t}
            else:
                blk[part][name] = {"w": t}
        blocks[f"p{i}"] = blk
    return {"embed": {"emb": emb},
            "final_norm": {"g": torch.zeros((d,), dtype=torch.bfloat16,
                                            device=device)},
            "head": {"w": w["head"]}, "blocks": blocks}
