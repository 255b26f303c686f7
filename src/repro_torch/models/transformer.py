"""Decoder blocks of the LM, for serving.

PyTorch-port counterpart of ``repro/models/transformer.py``. A model is a
repeating ``pattern`` of LayerSpecs; its params are stacked per pattern
position with a leading ``[n_groups]`` axis (``models/model.py``). Every
block: pre-norm -> attention -> residual, pre-norm -> FFN -> residual,
every linear a Loom linear through the plan.

This port runs the dense family (attention blocks with a gated dense
FFN). The mamba and cross-attention mixers, the MoE FFN and the non-gated
FFN raise NotImplementedError (ROADMAP A.11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"           # "attn" | "mamba" | "cross"
    ffn: str = "dense"           # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding window for this position


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    activation: str = "silu"
    qk_norm: bool = False
    rope_theta: float = 500000.0
    ffn_gated: bool = True       # False (nemotron): not ported, A.11
    pattern: tuple = (LayerSpec(),)
    max_seq: int = 8192
    kv_cache_bits: int = 16
    gqa_decode: bool = False
    attn_int8: bool = False
    # families: dense | moe | ssm | hybrid | audio | vlm
    family: str = "dense"

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.n_layers} layers are not a multiple of "
                             f"the pattern period {self.period}")
        return self.n_layers // self.period

    def attn_cfg(self, spec: LayerSpec) -> attn.AttnConfig:
        return attn.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_head=self.d_head,
            rope_theta=self.rope_theta, qk_norm=self.qk_norm,
            window=spec.window, cross=(spec.kind == "cross"),
            kv_cache_bits=self.kv_cache_bits, gqa_decode=self.gqa_decode,
            attn_int8=self.attn_int8)


def check_ported(spec: LayerSpec) -> None:
    if spec.kind != "attn" or spec.ffn == "moe":
        raise NotImplementedError(
            f"layer {spec}: only attention blocks with a dense FFN are "
            f"ported (mamba, cross-attention and MoE: ROADMAP A.11)")


def ffn_init(d: int, f: int, generator: torch.Generator,
             dtype=torch.bfloat16, gated: bool = True) -> dict:
    if not gated:
        raise NotImplementedError("the non-gated FFN (nemotron) is not "
                                  "ported yet (ROADMAP A.11)")
    return {"w_gate": L.linear_init(d, f, generator, dtype),
            "w_up": L.linear_init(d, f, generator, dtype),
            "w_down": L.linear_init(f, d, generator, dtype)}


def ffn_apply(p, x, activation: str, plan) -> torch.Tensor:
    if "w_gate" not in p:
        raise NotImplementedError("the non-gated FFN (nemotron) is not "
                                  "ported yet (ROADMAP A.11)")
    u = L.linear_apply(p["w_up"], x, plan, "ffn_up")
    g = L.linear_apply(p["w_gate"], x, plan, "ffn_gate")
    h = L.activation_fn(activation)(g) * u
    return L.linear_apply(p["w_down"], h, plan, "ffn_down")


def block_init(cfg: ModelConfig, spec: LayerSpec, generator: torch.Generator,
               dtype=torch.bfloat16) -> dict:
    check_ported(spec)
    dev = generator.device
    p = {"ln1": L.norm_init(cfg.d_model, dtype, dev),
         "mix": attn.init(cfg.attn_cfg(spec), generator, dtype)}
    if spec.ffn != "none":
        p["ln2"] = L.norm_init(cfg.d_model, dtype, dev)
        p["ffn"] = ffn_init(cfg.d_model, cfg.d_ff, generator, dtype,
                            gated=cfg.ffn_gated)
    return p


def block_apply_prefill(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
                        plan, cache):
    check_ported(spec)
    h = L.rms_norm(x, p["ln1"]["g"])
    mix, cache = attn.apply_prefill(p["mix"], cfg.attn_cfg(spec), h,
                                    positions, plan, cache)
    x = x + mix
    if spec.ffn != "none":
        x = x + ffn_apply(p["ffn"], L.rms_norm(x, p["ln2"]["g"]),
                          cfg.activation, plan)
    return x, cache


def block_apply_decode(p, cfg: ModelConfig, spec: LayerSpec, x, pos, plan,
                       cache):
    check_ported(spec)
    h = L.rms_norm(x, p["ln1"]["g"])
    mix, cache = attn.apply_decode(p["mix"], cfg.attn_cfg(spec), h, pos, plan,
                                   cache)
    x = x + mix
    if spec.ffn != "none":
        x = x + ffn_apply(p["ffn"], L.rms_norm(x, p["ln2"]["g"]),
                          cfg.activation, plan)
    return x, cache


def block_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, device="cpu") -> dict:
    check_ported(spec)
    return attn.init_cache(cfg.attn_cfg(spec), batch, max_seq, device=device)
