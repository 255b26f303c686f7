"""``repro_torch.compile``: one entry point from (config, policy) to serving.

PyTorch-port counterpart of ``repro/api/session.py``::

    import repro_torch
    session = repro_torch.compile(cnn_cfg, policy, mode="serve_packed",
                                  backend="cuda")
    logits = session.classify(images)      # NHWC [B, H, W, C]

    session = repro_torch.compile(lm_cfg, policy, mode="serve_packed")
    logits, cache = session.prefill(tokens)           # tokens int [B, S]
    logits, cache = session.decode(token, pos, cache)
    gen = session.generate(tokens, gen_len=16)        # greedy, numpy int32

The session runs on the card (``device="cuda"``) unless the caller asks
for the CPU. PyTorch runs eagerly, so there is nothing to jit: the entry
points ``_prefill`` / ``_decode`` / ``_classify`` are plain closures over
the config and the plan, the hooks that
:class:`~repro_torch.runtime.serving.ServingSupervisor` wraps, as the
reference wraps its jitted ones. The LM's cache is written in place by
``prefill`` and ``decode``. ``compile(..., guarded=True)`` wraps the
backend in a :class:`~repro_torch.api.backend.GuardedBackend`. A session
compiled for serving carries the CRC32 fingerprint of its weights
(``core.integrity``), taken once at ``compile``; ``verify_integrity``
re-checks it.

On a mesh (``compile(..., mesh=mesh)``, a ("data", "model") ``DeviceMesh``
of ``torch.distributed`` ranks, one process each) an LM session holds this
rank's shards only: the dense weights are split by their logical specs,
each rank quantizes and packs its own shard under the whole leaf's scale
(an all-reduced absmax), so its bytes are the slice of the unsharded
packing. ``prefill`` / ``decode`` take the whole batch and return this
rank's rows (:meth:`ServingSession.rows`), run tensor-parallel over
"model" and batch-parallel over "data"; ``generate`` returns every row.
A CNN ignores the mesh, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.api.plan import ExecutionPlan, build_plan, counted_weights
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.runtime import tracing

_SERVING_MODES = ("serve_int8", "serve_packed")


@dataclasses.dataclass
class ServingSession:
    """A compiled model + plan, ready to serve. Built by :func:`compile`.

    ``_prefill(params, tokens, cache[, img_embeds])``, ``_decode(params,
    token, pos, cache)`` and ``_classify(params, x)`` are the entry points
    (None where the model has none); the public methods put their inputs
    on the session's device and call them under ``torch.inference_mode``.
    """

    cfg: Any
    plan: ExecutionPlan
    params: dict
    device: torch.device
    _prefill: Any = None
    _decode: Any = None
    _classify: Any = None
    # This rank's place on a mesh (dist.parallel.ShardCtx); None unsharded.
    shard: Any = None
    # Content identity of the compiled weights (core.integrity), computed
    # once per compile/reload for serving modes; None = not fingerprinted.
    fingerprint: Any = None

    @property
    def is_lm(self) -> bool:
        return hasattr(self.cfg, "pattern")

    def _need(self, lm: bool) -> None:
        if self.is_lm != lm:
            raise ValueError(f"{self.cfg.name}: not "
                             f"{'an LM' if lm else 'a CNN'} session")

    # -- LM entry points ----------------------------------------------------

    def rows(self, batch: int) -> slice:
        """The rows of a ``batch``-row input this rank serves (all of them
        without a mesh)."""
        if self.shard is None:
            return slice(0, batch)
        n = self.shard.local(batch, "dp")
        return slice(self.shard.rank("dp") * n,
                     (self.shard.rank("dp") + 1) * n)

    def init_cache(self, batch: int, max_seq: int | None = None) -> dict:
        """A cache for ``batch`` rows (on a mesh: this rank's rows and its
        KV heads or its slots of it, ``model.cache_shard_spec_tree``)."""
        from repro_torch.models import model as M
        self._need(lm=True)
        cache = M.init_cache(self.cfg, batch, max_seq or self.cfg.max_seq,
                             self.device)
        if self.shard is None:
            return cache
        from repro_torch.dist import sharding
        return sharding.shard_tree(
            cache, self.shard.place(M.cache_shard_spec_tree(self.cfg,
                                                            self.shard)),
            self.shard.mesh)

    def _local_rows(self, t):
        if self.shard is None or not isinstance(t, torch.Tensor) \
                or t.ndim == 0:
            return t
        return t[self.rows(t.shape[0])]

    def prefill(self, tokens, cache=None, img_embeds=None):
        """Fill caches from a full prompt (int [B, S]). Returns
        (last-token logits [B, 1, V], cache); ``cache`` defaults to a new
        one of ``cfg.max_seq`` slots. A VLM's cross-attention layers take
        ``img_embeds`` [B, n_img_tokens, d] (a tensor or numpy array, bf16
        included)."""
        self._need(lm=True)
        with tracing.span("session.prefill"):
            tokens = torch.as_tensor(tokens, device=self.device).long()
            if cache is None:
                cache = self.init_cache(tokens.shape[0])
            tokens = self._local_rows(tokens)
            with torch.inference_mode():
                if img_embeds is None:
                    return self._prefill(self.params, tokens, cache)
                from repro_torch import interop
                img_embeds = self._local_rows(
                    interop.params_from_numpy(img_embeds, self.device))
                return self._prefill(self.params, tokens, cache, img_embeds)

    def decode(self, token, pos, cache):
        """One decode step. token: int [B]; pos: the absolute position, an
        int for the whole batch or an int [B] tensor per row. Returns
        (logits [B, V], cache)."""
        self._need(lm=True)
        with tracing.span("session.decode"):
            token = self._local_rows(
                torch.as_tensor(token, device=self.device).long())
            if not isinstance(pos, int):
                pos = self._local_rows(torch.as_tensor(
                    pos, dtype=torch.int32, device=self.device))
            with torch.inference_mode():
                return self._decode(self.params, token, pos, cache)

    def generate(self, tokens, gen_len: int, max_seq: int | None = None):
        """Greedy generation: prefill + gen_len - 1 decode steps over a
        cache of ``max_seq`` slots (default ``cfg.max_seq``). The tokens
        stay on the device; returns numpy int32 [B, gen_len] after one
        transfer. On a mesh each rank decodes its rows; every rank gets
        the whole batch's tokens."""
        tokens = torch.as_tensor(tokens, device=self.device)
        b, s = tokens.shape
        logits, cache = self.prefill(tokens, self.init_cache(b, max_seq))
        tok = torch.argmax(logits[:, 0], dim=-1)
        out = [tok]
        for i in range(gen_len - 1):
            logits, cache = self.decode(self._whole_rows(tok), s + i, cache)
            tok = torch.argmax(logits, dim=-1)
            out.append(tok)
        out = self._whole_rows(torch.stack(out, dim=1).to(torch.int32))
        return out.cpu().numpy()

    def _whole_rows(self, t):
        """Every rank's rows of ``t`` (t itself without a mesh)."""
        return t if self.shard is None else self.shard.gather(t, 0, "dp")

    # -- CNN entry point ----------------------------------------------------

    def classify(self, x) -> torch.Tensor:
        """x: [B, H, W, C] float (tensor or array) -> logits [B, n_classes]
        on the session's device."""
        self._need(lm=False)
        with tracing.span("session.classify"):
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            with torch.inference_mode():
                return self._classify(self.params, x)

    # -- Integrity ----------------------------------------------------------

    def verify_integrity(self, where: str = "") -> int:
        """Re-verify the serving weights against the compile-time CRC32
        fingerprint and the plan's pass-law count metadata (a typed
        :class:`~repro_torch.api.guards.WeightIntegrityError` on any
        mismatch). Returns the number of leaves verified; 0 when the
        session was compiled without a fingerprint (non-serving modes).
        Every leaf crosses to the host to be hashed."""
        if self.fingerprint is None:
            return 0
        from repro_torch.core import integrity
        where = where or self.cfg.name
        n = integrity.verify_params(self.params, self.fingerprint, where)
        integrity.verify_plan_counts(self.plan, self.fingerprint, where)
        return n

    def refingerprint(self) -> None:
        """Recompute the fingerprint from the CURRENT params/plan -- only
        legitimate after an intentional weight swap (engine reload)."""
        from repro_torch.core import integrity
        self.fingerprint = integrity.fingerprint_session(self.params,
                                                         self.plan)

    # -- Plan state ---------------------------------------------------------

    def rejit(self) -> "ServingSession":
        """Fresh entry points for the same cfg/plan/params.

        The reference re-jits after a backend quarantine, because a traced
        entry point baked the old dispatch into its cache. The port runs
        eagerly: every call already reads the plan's backend state (a
        guarded backend's sticky fallbacks included), so the fresh
        closures only drop any instrumentation wrapped around the old
        ones. The fingerprint is kept."""
        return dataclasses.replace(
            self, **entry_points(self.cfg, self.plan, self.shard))

    def layer_plan(self, name: str = "", kind: str = "linear"):
        """The resolved :class:`~repro_torch.api.plan.LayerPlan` of one
        layer (an LM's layer class, or a CNN layer's name)."""
        return self.plan.layer(name, kind=kind)

    def dynamic_stats(self, x, layer_name: str = "") -> dict:
        """Runtime trimming report for ``x`` entering ``layer_name``: what
        fraction of the static activation planes the OR-tree path executes
        (Loom's dynamic speedup contribution). ``x`` (a tensor or array)
        is taken onto the session's device; the means are float32 0-d
        tensors there."""
        from repro_torch.core import dynamic, quantize
        lp = self.plan.layer(layer_name)
        bits = min(lp.a_bits, 8)
        x = torch.as_tensor(x, device=self.device)
        xq, _ = quantize.quantize(
            x.to(torch.float32).reshape(-1, x.shape[-1]), bits)
        return dynamic.dynamic_stats(xq, bits, lp.group_size)


def entry_points(cfg, plan, shard=None) -> dict:
    """The session's entry-point closures over ``cfg`` and ``plan``
    (``_prefill`` and ``_decode`` for an LM, on a mesh over ``shard``,
    a :class:`~repro_torch.dist.parallel.ShardCtx`; ``_classify`` for a
    CNN); ``launch.serve.make_serve_fns`` and ``jit_serve_steps`` hand out
    the LM's pair."""
    if hasattr(cfg, "pattern"):
        from repro_torch.models import model as M

        def prefill(params, tokens, cache, img_embeds=None):
            return M.prefill(params, cfg, tokens, cache, plan, img_embeds,
                             shard)

        def decode(params, token, pos, cache):
            return M.decode_step(params, cfg, token, pos, cache, plan, shard)

        return dict(_prefill=prefill, _decode=decode)
    from repro_torch.models import cnn

    def classify(params, x):
        return cnn.forward(params, cfg, x, plan)

    return dict(_classify=classify)


def compile(cfg, policy: Optional[PrecisionPolicy] = None,
            mode: str = "dense", backend="cuda", *, params=None,
            generator: torch.Generator | None = None,
            device="cuda", guarded: bool = False,
            conv_route: str = "fused", mesh=None) -> ServingSession:
    """Compile a model for serving: plans + params on ``device``.

    ``cfg``: a CNN config (``classify``) or an LM ``ModelConfig``
    (``prefill``/``decode``/``generate``). ``mode``: ``dense``,
    ``serve_int8`` (int8 weights, one exact int8 product per linear) or
    ``serve_packed`` (bit-packed planes). ``params``: a tree in the dense
    or a serving layout, as tensors or numpy arrays
    (:func:`repro_torch.interop.params_from_numpy`; the LM's is stacked
    over its groups); dense layers are packed here when ``mode`` is a
    serving mode. Omitted -> drawn from ``generator`` (seed 0 when None;
    the LM's on ``device``). ``backend``: registered name or Backend
    object; the default ``cuda`` launches the kernels on the card and takes
    their plain versions with ``device="cpu"``. ``device="cuda"`` without
    a card raises. ``guarded``: wrap the backend in a
    :class:`~repro_torch.api.backend.GuardedBackend` -- typed fault
    classification, sticky per-op fallback down ``cuda -> torch_ref`` and
    numeric-integrity prechecks; bit-identical to unguarded on the
    fault-free path (pair with ``repro_torch.runtime.ServingSupervisor``
    for request-level retry/timeout/health). A serving mode fingerprints
    the packed weights (``session.fingerprint``), hashing every leaf on
    the host. ``mesh``: a ("data", "model") ``DeviceMesh``
    (``launch.mesh.make_host_mesh``): an LM is then compiled as this
    rank's shards on the mesh's device (module docstring); ``params`` may
    be whole or this rank's shards (``interop.params_from_numpy(...,
    specs=, mesh=)``), told apart by the embedding table's shape.
    """
    if mesh is not None and hasattr(cfg, "pattern"):
        from repro_torch.dist.parallel import ShardCtx
        shard = ShardCtx(mesh)
        device = shard.device
    else:
        shard = None
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compile(device='cuda'): no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    from repro_torch import interop
    from repro_torch.models import model as M
    policy = policy if policy is not None else PrecisionPolicy()
    if guarded:
        from repro_torch.api.backend import guard_backend
        backend = guard_backend(backend)
    plan = build_plan(cfg, policy, mode, backend, conv_route)
    lm = hasattr(cfg, "pattern")
    if params is None:
        if lm:
            params = M.init_params(cfg, generator, device)
        else:
            from repro_torch.models import cnn
            params = cnn.init_params(cfg, generator, device)
    params = interop.params_from_numpy(params, device)
    if shard is not None:
        params = _shard_params(cfg, policy, mode, params, shard)
        plan.record_weight_groups(counted_shards(params, mode, shard))
    elif mode in _SERVING_MODES:
        if lm:
            params = M.convert_params_for_serving(params, policy, mode)
        else:
            params = M.convert_tree(params, policy, mode)
        plan.record_weight_groups(counted_weights(cfg, params))
    sess = ServingSession(cfg=cfg, plan=plan, params=params, device=device,
                          shard=shard, **entry_points(cfg, plan, shard))
    if mode in _SERVING_MODES:
        with tracing.span("compile.fingerprint"):
            sess.refingerprint()
    return sess


def _is_converted(params) -> bool:
    from repro_torch import interop
    return any(k.endswith(("/w_packed", "/wq"))
               for k in interop.flatten_with_paths(params))


def _spec_at(specs, path: tuple):
    for k in path:
        specs = specs[k]
    return specs


def _shard_params(cfg, policy, mode: str, params: dict, shard) -> dict:
    """This rank's serving tree from ``params`` (whole, or this rank's
    shards already). Dense leaves are split by ``param_spec_tree``; in a
    serving mode each rank then converts its own shards, every linear's
    (and expert's) absmax all-reduced with MAX over the ranks holding its
    pieces, so the scale is the whole leaf's and the packed bytes are the
    slice of the unsharded packing."""
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import Spec
    from repro_torch.models import model as M
    dense_specs = M.param_spec_tree(cfg)
    whole = tuple(params["embed"]["emb"].shape) == (cfg.vocab, cfg.d_model)
    if mode in _SERVING_MODES and _is_converted(params):
        specs = M.convert_specs_for_serving(M.param_skeleton(cfg),
                                            dense_specs, mode)
        return sharding.shard_tree(params, specs, shard.mesh) if whole \
            else params
    if whole:
        params = sharding.shard_tree(params, dense_specs, shard.mesh)
    if mode not in _SERVING_MODES:
        return params

    def absmax_hook(path, expert):
        spec = _spec_at(dense_specs, path)
        spec = spec if expert else spec["w"]
        if path[0] == "blocks":
            spec = Spec(*spec[1:])
        return shard.absmax_reducer(spec, (1, 2) if expert else (0, 1))

    return M.convert_params_for_serving(params, policy, mode, absmax_hook)


def counted_shards(params: dict, mode: str, shard) -> dict:
    """The head's weight-group counts are taken over its whole K: the
    rank's column shard, its "fsdp" split gathered."""
    if mode not in _SERVING_MODES:
        return {}
    from repro_torch.models import model as M
    return {"lm_head": shard.lin(*M.HEAD_AXES).weights(params["head"])}
