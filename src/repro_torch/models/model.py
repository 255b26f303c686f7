"""LM: init, the training forward and loss, prefill and decode over the
stacked blocks, and the offline weight packing.

PyTorch-port counterpart of ``repro/models/model.py``.
The param tree is the reference's: ``{"embed": {"emb"}, "final_norm":
{"g"}, "head": {"w"}, "blocks": {"p<i>": tree with a leading [n_groups]
axis on every leaf}}``, so a tree made or converted by the JAX package
(carried across by ``repro_torch.interop.params_from_numpy``) runs here
unchanged. The cache tree has the same shape, each leaf stacked over the
groups, and is written in place: ``{"k", "v", "slot_pos"}`` per attention
or cross-attention position (plus ``"k_scale"`` and ``"v_scale"`` on an
int8 cache, ``kv_cache_bits=8``), ``{"conv", "state"}`` per mamba one.
Python loops over the groups take the place of the reference's
``lax.scan``.

The training forward (:func:`forward_train`, :func:`loss_fn`) is
differentiable with autograd. ``cfg.remat`` picks what a layer group
keeps for the backward, as the reference's ``jax.checkpoint`` policies
do: ``"none"`` everything, ``"full"`` only the group's input (the group
runs again in the backward, ``torch.utils.checkpoint``), ``"dots"`` the
outputs of the products without batch dims (``aten.mm``), the rest
recomputed.

Logical specs (:mod:`repro_torch.dist.sharding`): :func:`param_spec_tree`
and :func:`cache_spec_tree` are the reference's, leaf for leaf, and
:func:`convert_specs_for_serving` maps a dense spec tree to the serving
layouts'. On a mesh (``shard``) :func:`prefill` and :func:`decode_step`
take this rank's batch rows and shards: the embedding vocab-parallel,
every block as its specs place it, the head column-parallel with its
logits all-gathered; the cache is placed by :func:`cache_shard_spec_tree`
(KV heads over "model", or the reference's sequence split where the
mesh's rules select it).
:func:`forward_train` and :func:`loss_fn` take the same placements (the
logits of the rank's rows, the whole vocab: B_local x S x V float32 a
rank), and the loss is the global batch's mean.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.api.plan import PARAM_CLASS_NAMES
from repro_torch.core import bitpack
from repro_torch.dist.parallel import lin
from repro_torch.dist.sharding import Spec, is_spec
from repro_torch.models import layers as L, transformer as T

# Logical axes (in, out) of the LM head: column-parallel over the vocab.
HEAD_AXES = ("fsdp", "tp")
# The training forward's activation dtype: the reference's bf16. With
# float32 params and this set to float32 the whole forward and backward
# run in float32 (the sharded gradients' checks use it to see past bf16
# rounding).
TRAIN_DTYPE = torch.bfloat16


def _stack_trees(trees: list) -> dict:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=0)


def _index_tree(tree, g: int):
    """Group ``g`` of a stacked tree: views, so writes reach the stack."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind_tree(tree, n: int) -> list:
    """The ``n`` groups of a stacked tree as ``n`` trees of views, by one
    ``torch.unbind`` per leaf: its backward stacks the groups' gradients
    once, where indexing group g would give each group's gradient a
    zero-filled tensor of the whole stacked leaf."""
    if isinstance(tree, dict):
        parts = {k: _unbind_tree(v, n) for k, v in tree.items()}
        return [{k: v[g] for k, v in parts.items()} for g in range(n)]
    return torch.unbind(tree, 0)


def _stack_specs(tree):
    """A block's spec tree with the leading [n_groups] axis replicated."""
    if is_spec(tree):
        return Spec(None, *tree)
    return {k: _stack_specs(v) for k, v in tree.items()}


def _unstack_specs(tree):
    if is_spec(tree):
        return Spec(*tree[1:])
    return {k: _unstack_specs(v) for k, v in tree.items()}


def param_spec_tree(cfg: T.ModelConfig) -> dict:
    """The logical specs of :func:`init_params`'s tree (the reference's
    ``init_params`` specs)."""
    return {"embed": L.embed_specs(), "final_norm": L.norm_specs(),
            "head": L.linear_specs(*HEAD_AXES),
            "blocks": {f"p{i}": _stack_specs(T.block_specs(cfg, spec))
                       for i, spec in enumerate(cfg.pattern)}}


def cache_spec_tree(cfg: T.ModelConfig) -> dict:
    """The reference's logical specs of :func:`init_cache`'s tree."""
    return {f"p{i}": _stack_specs(T.block_cache_specs(cfg, spec))
            for i, spec in enumerate(cfg.pattern)}


def cache_shard_spec_tree(cfg: T.ModelConfig, shard=None) -> dict:
    """Where a meshed session places the cache: rows over "dp", KV heads
    and SSM heads over "tp" (ROADMAP: port differences by design); where
    ``shard``'s mesh splits the attention caches by sequence
    (``attention.seq_split``: ``decode_pin_seq``, an "sp" override, or KV
    heads that do not split over "tp"), their sequence over "sp" as
    :func:`cache_spec_tree` places it."""
    split = T.attn.seq_split(cfg, shard)
    return {f"p{i}": _stack_specs(T.block_cache_shard_specs(cfg, spec,
                                                            split))
            for i, spec in enumerate(cfg.pattern)}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def init_params(cfg: T.ModelConfig, generator: torch.Generator | None = None,
                device="cpu", dtype=torch.bfloat16) -> dict:
    """Random params in the reference's layout, drawn with ``generator``
    on its device (a seed-0 generator on ``device`` when None)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {"embed": L.embed_init(cfg.vocab, cfg.d_model, generator, dtype),
              "final_norm": L.norm_init(cfg.d_model, dtype, generator.device),
              "head": L.linear_init(cfg.d_model, cfg.vocab, generator, dtype)}
    params["blocks"] = {
        f"p{i}": _stack_trees([T.block_init(cfg, spec, generator, dtype)
                               for _ in range(cfg.n_groups)])
        for i, spec in enumerate(cfg.pattern)}
    return params


def param_skeleton(cfg: T.ModelConfig, dtype=torch.bfloat16) -> dict:
    """:func:`init_params`'s keys, shapes and dtypes as meta tensors, with
    nothing drawn or allocated: the ``like`` tree of a checkpoint restore
    (a full-size random tree would cost the memory of the weights)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch import interop
    with FakeTensorMode():
        fake = init_params(cfg, torch.Generator(), "cpu", dtype)
    return interop.map_with_paths(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def init_cache(cfg: T.ModelConfig, batch: int, max_seq: int,
               device="cpu") -> dict:
    return {f"p{i}": _stack_trees([T.block_cache_init(cfg, spec, batch,
                                                      max_seq, device)
                                   for _ in range(cfg.n_groups)])
            for i, spec in enumerate(cfg.pattern)}


def _layers(params, cache, cfg: T.ModelConfig):
    """(spec, block params, block cache) of every layer, in order."""
    for g in range(cfg.n_groups):
        for i, spec in enumerate(cfg.pattern):
            yield (spec, _index_tree(params["blocks"][f"p{i}"], g),
                   _index_tree(cache[f"p{i}"], g))


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of the products without batch
    dims (every Loom linear's ``aten.mm``; the reference's
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(cfg: T.ModelConfig):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a layer group,
    or None (``remat="none"``: no checkpoint)."""
    if cfg.remat == "none":
        return None
    if cfg.remat == "dots":
        return functools.partial(ckpt.create_selective_checkpoint_contexts,
                                 _save_dots)
    if cfg.remat == "full":
        return ckpt.noop_context_fn
    raise ValueError(f"unknown remat {cfg.remat!r}; expected 'none', "
                     f"'dots' or 'full'")


def forward_train(params, cfg: T.ModelConfig, tokens, plan,
                  img_embeds=None, shard=None) -> tuple:
    """tokens: int [B, S] -> (logits [B, S, V], the summed MoE auxiliary
    loss, a float32 scalar). A VLM's cross-attention layers attend to
    ``img_embeds`` [B, n_img_tokens, d]. On a mesh (``shard``) the rows,
    params and logits are this rank's, placed as :func:`prefill` places
    them: the whole vocab's logits of the rank's rows."""
    s = tokens.shape[1]
    x = L.embed_apply(params["embed"], tokens, shard).to(TRAIN_DTYPE)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    groups = {k: _unbind_tree(v, cfg.n_groups)
              for k, v in params["blocks"].items()}

    def group_body(x, group):
        aux = 0.0
        for i, spec in enumerate(cfg.pattern):
            x, a = T.block_apply_train(group[f"p{i}"], cfg, spec, x,
                                       positions, plan, img_embeds, shard)
            aux = aux + a
        return x, aux

    context_fn = _remat_policy(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for g in range(cfg.n_groups):
        group = {k: v[g] for k, v in groups.items()}
        if context_fn is None:
            x, a = group_body(x, group)
        else:
            x, a = ckpt.checkpoint(group_body, x, group, use_reentrant=False,
                                   context_fn=context_fn)
        aux = aux + a
    x = L.rms_norm(x, params["final_norm"]["g"])
    return _head(params, x, plan, shard), aux


def loss_fn(params, cfg: T.ModelConfig, batch: dict, plan,
            shard=None) -> tuple:
    """Next-token loss of ``batch`` (``tokens``, ``labels`` int [B, S],
    and a VLM's ``img_embeds``): the mean of float32 logsumexp minus the
    gold logit, plus the auxiliary loss. Returns (loss, {"nll", "aux"}).
    On a mesh (``shard``, the batch this rank's rows) the mean is the
    global batch's: each rank's mean over its rows, averaged over "data"
    (:meth:`~repro_torch.dist.parallel.ShardCtx.mean_over_data`: each
    rank's backward carries its share, and the step SUM-reduces the
    gradients over "data"); every rank returns the global loss."""
    logits, aux = forward_train(params, cfg, batch["tokens"], plan,
                                batch.get("img_embeds"), shard)
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, batch["labels"][..., None].long())
    nll = torch.mean(torch.logsumexp(logits, dim=-1) - gold.squeeze(-1))
    if shard is not None:
        nll = shard.mean_over_data(nll)
    return nll + aux, {"nll": nll, "aux": aux}


def _head(params, x, plan, shard):
    """The LM head; on a mesh column-parallel, its logits all-gathered."""
    y = L.linear_apply(params["head"], x, plan, "lm_head",
                       lin(shard, *HEAD_AXES))
    return y if shard is None else shard.gather(y, -1)


def prefill(params, cfg: T.ModelConfig, tokens, cache, plan,
            img_embeds=None, shard=None):
    """Fill the caches from a full prompt (tokens: int [B, S]; a VLM's
    cross-attention layers also take ``img_embeds`` [B, n_img_tokens, d]
    bf16). Returns (last-token logits [B, 1, V], cache). On a mesh
    (``shard``) everything is this rank's: its rows, shards and cache."""
    s = tokens.shape[1]
    x = L.embed_apply(params["embed"], tokens, shard).to(torch.bfloat16)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    for spec, p, c in _layers(params, cache, cfg):
        x = T.block_apply_prefill(p, cfg, spec, x, positions, plan, c,
                                  img_embeds, shard)
    x = L.rms_norm(x[:, -1:], params["final_norm"]["g"])
    return _head(params, x, plan, shard), cache


def decode_step(params, cfg: T.ModelConfig, token, pos, cache, plan,
                shard=None):
    """One decode step. token: int [B]; pos: the absolute position, an int
    or a 0-d int tensor (never read on the host) for the whole batch, or
    an int [B] tensor per row. Returns (logits [B, V], cache). Row b of
    the result is written not to depend on the other rows
    (``attention.decode_attend``: shown bit for bit on an H100 at the
    sizes its docstring names)."""
    x = L.embed_apply(params["embed"], token[:, None], shard).to(
        torch.bfloat16)
    for spec, p, c in _layers(params, cache, cfg):
        x = T.block_apply_decode(p, cfg, spec, x, pos, plan, c, shard)
    x = L.rms_norm(x, params["final_norm"]["g"])
    return _head(params, x[:, 0], plan, shard), cache


# ---------------------------------------------------------------------------
# Offline weight packing (the paper's bit-interleaved storage step)
# ---------------------------------------------------------------------------

_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_SKIP_LINEARS = ("router", "conv")  # tiny/accuracy-critical or depthwise conv


def _policy_key(path: tuple) -> str:
    if path and path[-1] in PARAM_CLASS_NAMES:
        return PARAM_CLASS_NAMES[path[-1]]
    return "/".join(path)


def _convert_expert_int8(w, prec, reduce_max=None) -> dict:
    """Experts [E, din, dout] -> ``{"wq": int8 [E, din, dout], "scale":
    float32 [E]}``, one absmax scale per expert (weight-only int8: the
    products take bf16 activations)."""
    out = [L.quantize_by_columns(we, 8, lambda b: b.to(torch.int8),
                                 reduce_max)
           for we in w]
    return {"wq": torch.stack([wq for wq, _ in out]),
            "scale": torch.cat([scale.reshape(1) for _, scale in out])}


def _convert_expert_packed(w, prec, reduce_max=None) -> dict:
    """Experts [E, din, dout] -> ``{"w_packed": uint8 [E, Pw, din/8,
    dout], "scale": float32 [E]}``: each expert quantized under its own
    absmax scale and bit-packed at ``prec.w_bits``."""
    bits = prec.w_bits
    out = [L.quantize_by_columns(we, bits,
                                 lambda b: bitpack.pack_weights(b, bits),
                                 reduce_max)
           for we in w]
    return {"w_packed": torch.stack([wp for wp, _ in out]),
            "scale": torch.cat([scale.reshape(1) for _, scale in out])}


_EXPERT_CONVERTERS = {"serve_int8": _convert_expert_int8,
                      "serve_packed": _convert_expert_packed}

# The serving layouts' expert specs from the dense (E, in, out) axes.
_EXPERT_SPEC_CONVERTERS = {
    "serve_int8": lambda e_ax, in_ax, out_ax: {
        "wq": Spec(e_ax, in_ax, out_ax), "scale": Spec(e_ax)},
    "serve_packed": lambda e_ax, in_ax, out_ax: {
        "w_packed": Spec(e_ax, None, in_ax, out_ax), "scale": Spec(e_ax)},
}


def _is_linear(p, path) -> bool:
    return ("w" in p and getattr(p["w"], "ndim", 0) == 2
            and (not path or path[-1] not in _SKIP_LINEARS))


def _convert_specs(p, s, mode: str, path: tuple = ()):
    if not isinstance(p, dict):
        return s
    if _is_linear(p, path):
        return L.convert_linear_specs(s, mode)
    out = {}
    for k, v in p.items():
        if k in _EXPERT_KEYS and getattr(v, "ndim", 0) == 3:
            try:
                out[k] = _EXPERT_SPEC_CONVERTERS[mode](*s[k])
            except KeyError:
                raise ValueError(f"no serving conversion for mode "
                                 f"{mode!r}") from None
        else:
            out[k] = _convert_specs(v, s[k], mode, path + (k,))
    return out


def convert_specs_for_serving(params: dict, specs: dict, mode: str) -> dict:
    """Spec-tree counterpart of :func:`convert_params_for_serving` (and of
    :func:`convert_tree` on a tree without ``blocks``, a CNN's): the same
    routing, read off ``params``' keys and ranks (meta tensors do, e.g.
    :func:`param_skeleton`), no arithmetic."""
    out = {}
    for k, v in params.items():
        if k == "blocks":
            out[k] = {pk: _stack_specs(_convert_specs(
                _index_tree(stacked, 0), _unstack_specs(specs[k][pk]), mode))
                for pk, stacked in v.items()}
        else:
            out[k] = _convert_specs(v, specs[k], mode)
    return out


def convert_tree(params: dict, policy, mode: str, root: tuple = (),
                 absmax_hook=None, where: tuple = ()) -> dict:
    """Walk an UNSTACKED tree, converting every dense 2-D linear ``{"w"}``
    for ``mode`` (``serve_int8``: ``{"wq", "w_scale"}``; ``serve_packed``:
    ``{"w_packed", "w_scale"}``) under its layer class's precision, and
    every 3-D expert tensor under the policy key of its path
    (``ffn/w_gate``; ``{"wq", "scale"}`` or ``{"w_packed", "scale"}``);
    the router and the SSM's conv stay, as do converted layers and other
    leaves. ``absmax_hook(path, expert)`` (a rank's shards on a mesh),
    given the leaf's path under ``where``, returns the map from a local
    absmax to the whole leaf's (one expert's for an expert tensor)."""
    def hook(path, expert):
        return None if absmax_hook is None else absmax_hook(
            tuple(where) + path, expert)

    def walk(p, path):
        if not isinstance(p, dict):
            return p
        if _is_linear(p, path):
            return L.convert_linear_for_serving(
                p, policy.lookup(_policy_key(path)), mode,
                hook(path, False))
        out = {}
        for k, v in p.items():
            if k in _EXPERT_KEYS and getattr(v, "ndim", 0) == 3:
                try:
                    converter = _EXPERT_CONVERTERS[mode]
                except KeyError:
                    raise ValueError(f"no serving conversion for mode "
                                     f"{mode!r}") from None
                out[k] = converter(v, policy.lookup("/".join(path + (k,))),
                                   hook(path + (k,), True))
            else:
                out[k] = walk(v, path + (k,))
        return out

    return walk(params, tuple(root))


def convert_structs_for_serving(params: dict, policy, mode: str) -> dict:
    """The keys, shapes and dtypes of :func:`convert_params_for_serving`'s
    tree, on fake tensors (the reference's ``convert_structs_for_serving``):
    group 0 of each stacked block is converted, with one expert of each
    expert tensor and a few columns of each linear, and stands for every
    group, expert and column, so a deep or wide model's conversion costs
    a few small conversions' operations."""
    from repro_torch import interop
    cols = 8

    def resized(dim, n):
        def fn(t):
            shape = list(t.shape)
            shape[dim] = n
            return torch.empty(shape, dtype=t.dtype, device=t.device)
        return fn

    def narrow(p, path=()):
        if not isinstance(p, dict):
            return p
        if _is_linear(p, path):
            return dict(p, w=p["w"].narrow(-1, 0, min(cols, p["w"].shape[-1])))
        return {k: v.narrow(0, 0, 1) if k in _EXPERT_KEYS and getattr(
            v, "ndim", 0) == 3 else narrow(v, path + (k,))
            for k, v in p.items()}

    def widen(conv, dense, path=()):
        if isinstance(dense, dict) and _is_linear(dense, path):
            n = dense["w"].shape[-1]
            return {k: resized(-1, n)(v) if k in ("wq", "w_packed") else v
                    for k, v in conv.items()}
        out = {}
        for k, v in conv.items():
            d = dense.get(k) if isinstance(dense, dict) else None
            if k in _EXPERT_KEYS and getattr(d, "ndim", 0) == 3:
                out[k] = interop.tree_map(resized(0, d.shape[0]), v)
            elif isinstance(v, dict):
                out[k] = widen(v, d, path + (k,))
            else:
                out[k] = v
        return out

    def convert(tree, root=()):
        return widen(convert_tree(narrow(tree, root), policy, mode,
                                  root=root), tree, root)

    out = {}
    for k, v in params.items():
        if k != "blocks":
            out[k] = convert(v, (k,))
            continue
        out[k] = {}
        for pk, stacked in v.items():
            n_groups = _leaves(stacked)[0].shape[0]
            one = convert(_index_tree(stacked, 0))
            out[k][pk] = interop.tree_map(
                lambda t: torch.empty((n_groups,) + tuple(t.shape),
                                      dtype=t.dtype, device=t.device), one)
    return out


def convert_params_for_serving(params: dict, policy, mode: str,
                               absmax_hook=None) -> dict:
    """Every linear's ``w`` -> its serving representation. Embeddings and
    norms stay bf16. Stacked block params are unstacked, converted layer by
    layer (one weight scale per layer) and restacked. ``absmax_hook``: see
    :func:`convert_tree` (paths from the tree's root)."""
    out = {}
    for k, v in params.items():
        if k == "blocks":
            out[k] = {}
            for pk, stacked in v.items():
                n_groups = _leaves(stacked)[0].shape[0]
                out[k][pk] = _stack_trees([
                    convert_tree(_index_tree(stacked, g), policy, mode,
                                 absmax_hook=absmax_hook, where=(k, pk))
                    for g in range(n_groups)])
        else:
            out[k] = convert_tree(v, policy, mode, root=(k,),
                                  absmax_hook=absmax_hook)
    return out
