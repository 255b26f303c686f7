"""Decoder blocks of the LM, for training and serving.

PyTorch-port counterpart of ``repro/models/transformer.py``. A model is a
repeating ``pattern`` of LayerSpecs (jamba's 1:7 attention:mamba
interleave, gemma3's 5:1 local:global windows, llama-vision's
cross-attention layers); its params are stacked per pattern position with
a leading ``[n_groups]`` axis (``models/model.py``). Every block:
pre-norm -> mixer (attention | mamba | cross-attention) -> residual,
pre-norm -> FFN (dense gated or not | MoE | none) -> residual, every
linear a Loom linear through the plan.

:func:`block_apply_train` is the differentiable full-sequence forward; it
returns the block's output and its MoE auxiliary loss. Every serving
block writes its cache in place: the attention K/V slots, the
mamba conv history and state (``models/ssm.py``), the cross-attention
K/V over the image embeddings.

Each module's ``param_specs`` / ``cache_specs`` give the reference's
logical specs of its trees (:mod:`repro_torch.dist.sharding`); every
block, training and serving, takes a ``shard`` (a
:class:`~repro_torch.dist.parallel.ShardCtx`) on a mesh, and runs each
projection as the shard its spec names.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.dist.parallel import lin
from repro_torch.dist.sharding import Spec
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod


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
    ffn_gated: bool = True       # False: h = act(W_up x) (nemotron's relu^2)
    pattern: tuple = (LayerSpec(),)
    moe: Optional[moe_mod.MoEConfig] = None
    ssm: Optional[ssm_mod.SSMConfig] = None
    max_seq: int = 8192
    n_img_tokens: int = 0        # VLM: length of the image embeddings
    kv_cache_bits: int = 16
    flash_vjp: bool = False      # memory-efficient attention backward
    kv_col_parallel: bool = False  # K/V projections column-parallel
    decode_pin_seq: bool = False   # the KV cache split by sequence ("sp")
    gqa_decode: bool = False
    mask_cache_update: bool = False  # cache writes as an elementwise where
    kv_replicated: bool = False    # K/V projections replicated over "tp"
    attn_int8: bool = False
    attn_block: int = 512        # training attention q/kv block size
    remat: str = "full"          # "full" | "dots" | "none" (models/model.py)
    sub_quadratic: bool = False  # eligible for the long_500k cell
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
            kv_cache_bits=self.kv_cache_bits, flash_vjp=self.flash_vjp,
            kv_col_parallel=self.kv_col_parallel,
            decode_pin_seq=self.decode_pin_seq, gqa_decode=self.gqa_decode,
            mask_cache_update=self.mask_cache_update,
            kv_replicated=self.kv_replicated, attn_int8=self.attn_int8,
            block=self.attn_block)


def ffn_init(d: int, f: int, generator: torch.Generator,
             dtype=torch.bfloat16, gated: bool = True) -> dict:
    p = {"w_gate": L.linear_init(d, f, generator, dtype)} if gated else {}
    p["w_up"] = L.linear_init(d, f, generator, dtype)
    p["w_down"] = L.linear_init(f, d, generator, dtype)
    return p


# Logical axes (in, out) of the FFN's projections: up/gate column-parallel,
# down row-parallel.
FFN_IN_AXES, FFN_OUT_AXES = ("fsdp", "tp"), ("tp", "fsdp")


def ffn_specs(gated: bool = True) -> dict:
    s = {"w_gate": L.linear_specs(*FFN_IN_AXES)} if gated else {}
    s["w_up"] = L.linear_specs(*FFN_IN_AXES)
    s["w_down"] = L.linear_specs(*FFN_OUT_AXES)
    return s


def ffn_apply(p, x, activation: str, plan, shard=None) -> torch.Tensor:
    """The dense FFN: ``act(W_gate x) * W_up x`` when gated, else
    ``act(W_up x)``, then ``W_down``."""
    col = lin(shard, *FFN_IN_AXES)
    u = L.linear_apply(p["w_up"], x, plan, "ffn_up", col)
    if "w_gate" in p:
        g = L.linear_apply(p["w_gate"], x, plan, "ffn_gate", col)
        h = L.activation_fn(activation)(g) * u
    else:
        h = L.activation_fn(activation)(u)
    return L.linear_apply(p["w_down"], h, plan, "ffn_down",
                          lin(shard, *FFN_OUT_AXES, x_local=True))


def block_init(cfg: ModelConfig, spec: LayerSpec, generator: torch.Generator,
               dtype=torch.bfloat16) -> dict:
    dev = generator.device
    p = {"ln1": L.norm_init(cfg.d_model, dtype, dev)}
    if spec.kind == "mamba":
        p["mix"] = ssm_mod.init(cfg.ssm, generator, dtype)
    else:
        p["mix"] = attn.init(cfg.attn_cfg(spec), generator, dtype)
    if spec.ffn != "none":
        p["ln2"] = L.norm_init(cfg.d_model, dtype, dev)
        if spec.ffn == "moe":
            p["ffn"] = moe_mod.init(cfg.moe, generator, dtype)
        else:
            p["ffn"] = ffn_init(cfg.d_model, cfg.d_ff, generator, dtype,
                                gated=cfg.ffn_gated)
    return p


def block_specs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """Logical specs of :func:`block_init`'s tree."""
    s = {"ln1": L.norm_specs()}
    if spec.kind == "mamba":
        s["mix"] = ssm_mod.param_specs(cfg.ssm)
    else:
        s["mix"] = attn.param_specs(cfg.attn_cfg(spec))
    if spec.ffn != "none":
        s["ln2"] = L.norm_specs()
        s["ffn"] = moe_mod.param_specs(cfg.moe) if spec.ffn == "moe" \
            else ffn_specs(cfg.ffn_gated)
    return s


def _ffn(p, cfg: ModelConfig, spec: LayerSpec, x, plan,
         shard=None, train: bool = False) -> tuple:
    """x plus the block's FFN, and the MoE's auxiliary loss (0.0 for any
    other FFN); on a mesh the global batch's only in training (``train``),
    which alone reads it."""
    if spec.ffn == "none":
        return x, 0.0
    h = L.rms_norm(x, p["ln2"]["g"])
    if spec.ffn == "moe":
        if shard is not None:
            f, aux = moe_mod.apply_shardmap(p["ffn"], cfg.moe, h, plan,
                                            shard, global_aux=train)
        else:
            f, aux = moe_mod.apply_train(p["ffn"], cfg.moe, h, plan)
        return x + f, aux
    return x + ffn_apply(p["ffn"], h, cfg.activation, plan, shard), 0.0


def block_apply_train(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
                      plan, img_embeds=None, shard=None) -> tuple:
    """One block's differentiable forward over x [B, S, d] (positions
    [S]; a cross-attention block attends to ``img_embeds``). Returns (x,
    the MoE auxiliary loss or 0.0). On a mesh (``shard``) x is this
    rank's rows and every projection its shard, as in serving."""
    h = L.rms_norm(x, p["ln1"]["g"])
    if spec.kind == "mamba":
        mix = ssm_mod.apply_train(p["mix"], cfg.ssm, h, plan, shard)
    else:
        mix = attn.apply_train(p["mix"], cfg.attn_cfg(spec), h, positions,
                               plan, kv_x=img_embeds, shard=shard)
    return _ffn(p, cfg, spec, x + mix, plan, shard, train=True)


def block_apply_prefill(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
                        plan, cache, img_embeds=None, shard=None):
    """One block over the prompt (x [B, S, d]), its cache filled in place,
    as the reference's ``model.prefill`` runs each kind: a mamba block
    keeps its conv history and final state; a cross-attention block
    projects the image embeddings' K/V into its cache
    (``attention.init_cross_cache``) and attends to them, non-causal
    (``attention.apply_train``). Returns x."""
    h = L.rms_norm(x, p["ln1"]["g"])
    if spec.kind == "mamba":
        mix = ssm_mod.apply_prefill(p["mix"], cfg.ssm, h, plan, cache, shard)
    elif spec.kind == "cross":
        if img_embeds is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             f"img_embeds [B, {cfg.n_img_tokens}, "
                             f"{cfg.d_model}] at prefill")
        acfg = cfg.attn_cfg(spec)
        attn.init_cross_cache(p["mix"], acfg, img_embeds, plan, cache, shard)
        mix = attn.apply_train(p["mix"], acfg, h, positions, plan,
                               kv_x=img_embeds, shard=shard)
    else:
        mix, _ = attn.apply_prefill(p["mix"], cfg.attn_cfg(spec), h,
                                    positions, plan, cache, shard)
    return _ffn(p, cfg, spec, x + mix, plan, shard)[0]


def block_apply_decode(p, cfg: ModelConfig, spec: LayerSpec, x, pos, plan,
                       cache, shard=None):
    """One block of a decode step (x [B, 1, d]), its cache updated in
    place. Returns x."""
    h = L.rms_norm(x, p["ln1"]["g"])
    if spec.kind == "mamba":
        mix = ssm_mod.apply_decode(p["mix"], cfg.ssm, h, plan, cache, shard)
    else:
        mix, _ = attn.apply_decode(p["mix"], cfg.attn_cfg(spec), h, pos,
                                   plan, cache, shard)
    return _ffn(p, cfg, spec, x + mix, plan, shard)[0]


def block_cache_init(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, device="cpu") -> dict:
    if spec.kind == "mamba":
        return ssm_mod.init_cache(cfg.ssm, batch, device=device)
    if spec.kind == "cross":
        # K/V of the image embeddings, written whole by each prefill;
        # every slot is valid at any decode position.
        a = cfg.attn_cfg(spec)
        shape = (batch, cfg.n_img_tokens, a.n_kv_heads, a.d_head)
        return {"k": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "v": torch.zeros(shape, dtype=torch.bfloat16, device=device),
                "slot_pos": torch.zeros(shape[:2], dtype=torch.int32,
                                        device=device)}
    return attn.init_cache(cfg.attn_cfg(spec), batch, max_seq, device=device)


def block_cache_specs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """The reference's logical specs of :func:`block_cache_init`'s tree."""
    if spec.kind == "mamba":
        return ssm_mod.cache_specs(cfg.ssm)
    if spec.kind == "cross":
        return {"k": Spec("dp", "sp", None, None),
                "v": Spec("dp", "sp", None, None),
                "slot_pos": Spec("dp", "sp")}
    return attn.cache_specs(cfg.attn_cfg(spec))


def block_cache_shard_specs(cfg: ModelConfig, spec: LayerSpec,
                            split: bool = False) -> dict:
    """Where the port places a block's cache on a mesh: rows over "dp",
    attention KV heads and the SSM's channels and heads over "tp"; with
    ``split`` (``attention.seq_split``) the attention caches' sequence
    over "sp", the reference's :func:`block_cache_specs`."""
    if spec.kind == "mamba":
        return ssm_mod.cache_specs(cfg.ssm)
    if split:
        return block_cache_specs(cfg, spec)
    if spec.kind == "cross":
        return {"k": Spec("dp", None, "tp", None),
                "v": Spec("dp", None, "tp", None),
                "slot_pos": Spec("dp", None)}
    return attn.cache_shard_specs(cfg.attn_cfg(spec))
