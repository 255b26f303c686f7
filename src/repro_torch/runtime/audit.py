"""Online shadow audit: catch silent compute corruption on live traffic.

PyTorch-port counterpart of ``repro/runtime/audit.py``.
``core.integrity`` closes the *storage* half of the silent fault model
(weights no longer being the compiled weights). This module closes the
*compute* half: a backend op that returns wrong-but-finite values -- a
miscompiled kernel, the ``backend.silent_corrupt`` chaos point -- raises
nothing, poisons no NaN, and sails through every loud guard while serving
corrupt tokens.

The :class:`ShadowAuditor` samples COMPLETED requests at a configurable
rate and, off the hot path (at engine step boundaries, never inside the
batched decode), deterministically replays each sampled request's prompt
on an independently built reference session (always the ``torch_ref``
plain versions -- a different backend object, the same packed weights,
on the serving session's device; an oracle on the serving kernels would
audit them against themselves) and byte-compares the replay
against the tokens the stream actually delivered:

  * match      -- the serving path is certified for that request
                  (``n_audits`` counts it);
  * divergence -- a typed :class:`~repro_torch.api.guards.
                  SilentDivergenceError` identifying the exact request and
                  first diverging token. The engine then QUARANTINES the
                  serving backend through the sticky-fallback machinery
                  (``GuardedBackend.quarantine``, along the chain usable
                  on the session's device: nothing on the card), degrades
                  health, and a minimized repro bundle (.npz: prompt +
                  served + reference tokens + plan/policy/backend/device
                  identity) is written with a printed one-command pytest
                  replay.

The replay runs over a cache of the engine's pool length (``max_seq``):
a batched stream equals a solo run only over a cache of that length (it
sets the length of the decode attention's sums). Sampling is
counter-based and deterministic (request ``n`` is audited iff
``floor(n * rate)`` increments), so chaos tests replay exactly.
``rate=0`` builds nothing and touches nothing. The reference session is
built lazily on the first audit and shares the serving session's packed
params -- it must be invalidated (``invalidate_reference``) after a hot
weight swap.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.api import guards

_BUNDLE_TEST = "tests/test_torch_audit.py -k replay_saved_bundle"
_BUNDLE_ENV = "LOOM_AUDIT_BUNDLE"
# The reference oracle's backend: the plain versions, never the kernels.
REF_BACKEND = "torch_ref"
# The config's serving-side attention fields: a bundle records them, as
# the registry's config by ``cfg.name`` would replay on its defaults.
_ATTN_FIELDS = ("kv_cache_bits", "gqa_decode", "attn_int8")
# Audit verdicts the lag percentile is taken over.
_LAG_RING = 512


@dataclass
class AuditRecord:
    """One sampled, completed request awaiting replay."""

    request_id: int
    prompt: np.ndarray            # [S] int32
    gen_len: int
    served: np.ndarray            # [gen_len] int32 -- what the stream got
    done_t: float                 # completion time (audit lag anchor)


@dataclass
class AuditResult:
    """Outcome of one replay (ok or the divergence details)."""

    record: AuditRecord
    ok: bool
    ref: np.ndarray | None = None
    diverged_at: int = -1
    bundle_path: str | None = None
    error: guards.SilentDivergenceError | None = None


@dataclass
class ShadowAuditor:
    """Sampled reference-replay auditor for a continuous-batching engine.

    ``rate``: fraction of completed requests audited (deterministic
    counter sampling; 1.0 = every request, 0.0 = disabled). The oracle
    runs on :data:`REF_BACKEND`. ``bundle_dir``: where
    divergence repro bundles are written (created on first divergence).
    ``max_seq``: the replay's cache length (the engine passes its pool's;
    None = the config's ``max_seq``).
    """

    rate: float = 0.0
    bundle_dir: str = "audit_bundles"
    max_seq: int | None = None
    _n_seen: int = 0
    _pending: deque = field(default_factory=deque)
    _lags: deque = field(default_factory=lambda: deque(maxlen=_LAG_RING))
    _ref_session: object = None

    def __post_init__(self):
        self.rate = min(max(float(self.rate), 0.0), 1.0)

    # -- sampling ------------------------------------------------------------

    def observe(self, req) -> bool:
        """Offer one COMPLETED request; True when it was sampled.

        Called by the engine at retire time with a fully-streamed request
        (``n_emitted == gen_len``). Copies the prompt and the delivered
        tokens -- the audit happens later, off the hot path."""
        if self.rate <= 0.0:
            return False
        self._n_seen += 1
        if int(self._n_seen * self.rate) <= int((self._n_seen - 1) * self.rate):
            return False
        self._pending.append(AuditRecord(
            request_id=req.request_id,
            prompt=np.asarray(req.prompt, np.int32).copy(),
            gen_len=int(req.gen_len),
            served=np.asarray(req.stream.tokens_so_far(), np.int32).copy(),
            done_t=time.monotonic()))
        return True

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def lag_p95(self) -> float:
        """p95 of completion -> audit-verdict lag (bounded ring)."""
        if not self._lags:
            return 0.0
        return float(np.percentile(np.asarray(self._lags, np.float64), 95))

    # -- the reference oracle ------------------------------------------------

    def invalidate_reference(self) -> None:
        """Drop the cached reference session AND any pending records --
        required after a hot weight swap (pending streams were produced
        by the old weights; replaying them under the new ones would
        false-positive)."""
        self._ref_session = None
        self._pending.clear()

    def _reference(self, session):
        """Lazily build the reference session: same cfg/policy/mode, device
        and the SAME packed params, but an independent plan on
        :data:`REF_BACKEND` -- an error in the serving backend cannot also
        be in the oracle's."""
        if self._ref_session is not None:
            return self._ref_session
        from repro_torch.api import plan as planlib
        from repro_torch.api.session import ServingSession, entry_points
        plan = session.plan
        ref_plan = planlib.build_plan(session.cfg, plan.policy, plan.mode,
                                      REF_BACKEND, plan.conv_route)
        # Pack-time weight-group counts were derived from the shared
        # packed tensors -- copy, don't recompute.
        for (name, kind), lp in plan.layers.items():
            if lp.w_group_counts:
                ref_plan.layer(name, kind=kind, kernel=lp.kernel,
                               stride=lp.stride)
                ref_plan.set_weight_counts(name, kind, lp.w_group_counts,
                                           lp.w_group)
        self._ref_session = ServingSession(
            cfg=session.cfg, plan=ref_plan, params=session.params,
            device=session.device, **entry_points(session.cfg, ref_plan))
        return self._ref_session

    # -- replay + compare ----------------------------------------------------

    def audit_one(self, session, rec: AuditRecord) -> AuditResult:
        """Replay one record on the reference oracle and byte-compare.

        Raises :class:`~repro_torch.api.guards.SilentDivergenceError`
        (with the repro bundle already written) on mismatch."""
        ref_sess = self._reference(session)
        ref = np.asarray(ref_sess.generate(rec.prompt[None, :], rec.gen_len,
                                           max_seq=self.max_seq)[0], np.int32)
        self._lags.append(time.monotonic() - rec.done_t)
        if rec.served.shape == ref.shape and bool(np.array_equal(rec.served,
                                                                 ref)):
            return AuditResult(record=rec, ok=True, ref=ref)
        diverged_at = int(np.argmax(rec.served != ref)) \
            if rec.served.shape == ref.shape else 0
        bundle = self._write_bundle(session, rec, ref, diverged_at)
        exc = guards.SilentDivergenceError(
            f"request {rec.request_id}: served tokens diverge from the "
            f"{REF_BACKEND!r} reference replay at position "
            f"{diverged_at} (served {rec.served[diverged_at]} != ref "
            f"{ref[diverged_at]}) -- the serving backend returned wrong-"
            f"but-finite values; repro bundle: {bundle}")
        exc.request_id = rec.request_id
        exc.diverged_at = diverged_at
        exc.ref_tokens = ref
        exc.bundle_path = bundle
        raise exc

    def drain(self, session) -> tuple[int, list[AuditResult]]:
        """Audit every pending record. Returns ``(n_audited, results)``;
        divergences come back as failed :class:`AuditResult`s (the typed
        error attached) instead of raising, so one corrupt request does
        not mask the rest of the batch."""
        results = []
        n = 0
        while self._pending:
            rec = self._pending.popleft()
            try:
                results.append(self.audit_one(session, rec))
            except guards.SilentDivergenceError as exc:
                results.append(AuditResult(
                    record=rec, ok=False, diverged_at=exc.diverged_at,
                    ref=exc.ref_tokens, bundle_path=exc.bundle_path,
                    error=exc))
            n += 1
        return n, results

    # -- repro bundles --------------------------------------------------------

    def _write_bundle(self, session, rec: AuditRecord, ref: np.ndarray,
                      diverged_at: int) -> str:
        """Minimized replayable divergence bundle: the one request's
        tokens + enough plan/policy/backend/device identity to rebuild the
        oracle. ``params_src`` "rng:0" names ``compile``'s default seed-0
        weights, which are drawn on the session's device (the card's
        generator draws other numbers than the CPU's): ``device``
        records where."""
        os.makedirs(self.bundle_dir, exist_ok=True)
        plan = session.plan
        pol = plan.policy
        cfg = session.cfg
        meta = {
            "arch": cfg.name,
            "mode": plan.mode,
            "conv_route": plan.conv_route,
            "attention": {f: getattr(cfg, f) for f in _ATTN_FIELDS},
            "backend": plan.backend.name,
            "ref_backend": REF_BACKEND,
            "device": session.device.type,
            "max_seq": self.max_seq,
            "policy": {"a_bits": pol.default.a_bits,
                       "w_bits": pol.default.w_bits,
                       "dynamic_a": pol.dynamic_a,
                       "group_size": pol.group_size,
                       "w_group": pol.w_group},
            "weights_fingerprint": session.fingerprint.digest()
            if session.fingerprint is not None else "",
            "params_src": "rng:0",
            "request_id": rec.request_id,
            "gen_len": rec.gen_len,
            "diverged_at": diverged_at,
        }
        path = os.path.join(
            self.bundle_dir,
            f"divergence_req{rec.request_id}_"
            f"{meta['weights_fingerprint'] or 'x'}.npz")
        np.savez(path, prompt=rec.prompt, served=rec.served, ref=ref,
                 meta=np.asarray(json.dumps(meta)))
        print(f"[audit] DIVERGENCE on request {rec.request_id} -- repro "
              f"bundle written; replay with:\n"
              f"  {_BUNDLE_ENV}={path} python -m pytest {_BUNDLE_TEST} -q",
              flush=True)
        return path


def load_bundle(path: str) -> dict:
    """Load a repro bundle: prompt/served/ref arrays + decoded metadata."""
    with np.load(path) as z:
        return {"prompt": np.asarray(z["prompt"], np.int32),
                "served": np.asarray(z["served"], np.int32),
                "ref": np.asarray(z["ref"], np.int32),
                "meta": json.loads(str(z["meta"]))}


def _resolve_cfg(name: str):
    """Map a bundle's recorded config name (``cfg.name``: "qwen3-1.7b",
    "qwen3-smoke", ...) back to the registry config carrying it."""
    from repro_torch import configs
    for arch in configs.ARCHS:
        for smoke in (False, True):
            cfg = configs.get(arch, smoke=smoke)
            if cfg.name == name:
                return cfg
    raise KeyError(f"bundle arch {name!r} matches no registered config")


def replay_bundle(path: str) -> dict:
    """Replay a divergence bundle in one call (what the pytest repro runs):
    recompile the REFERENCE oracle from the recorded arch (with its
    attention fields), policy, mode and conv route on the recorded device (``compile``'s default seed-0 params, drawn
    there), regenerate the bundled prompt over the recorded cache length,
    and compare against both stored streams. Returns the bundle dict plus
    ``regenerated`` (the fresh reference tokens), ``reproduced`` (fresh
    reference == stored reference) and ``diverged`` (stored served !=
    stored reference). A bundle written on the card needs the card."""
    import dataclasses as dc

    import repro_torch
    from repro_torch.core.policy import uniform_policy

    b = load_bundle(path)
    meta = b["meta"]
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"bundle {path!r} was written on device 'cuda': its seed-0 "
            f"weights are drawn by the card's generator, so it replays on "
            f"a CUDA device only")
    cfg = dc.replace(_resolve_cfg(meta["arch"]), **meta.get("attention", {}))
    pol = meta["policy"]
    policy = uniform_policy(pol["a_bits"], pol["w_bits"],
                            dynamic_a=pol["dynamic_a"],
                            w_group=pol["w_group"])
    policy = dc.replace(policy, group_size=pol["group_size"])
    sess = repro_torch.compile(cfg, policy, mode=meta["mode"],
                               backend=meta["ref_backend"],
                               device=meta["device"],
                               conv_route=meta.get("conv_route", "fused"))
    regenerated = np.asarray(
        sess.generate(b["prompt"][None, :], meta["gen_len"],
                      max_seq=meta["max_seq"])[0], np.int32)
    b["regenerated"] = regenerated
    b["reproduced"] = bool(np.array_equal(regenerated, b["ref"]))
    b["diverged"] = not bool(np.array_equal(b["served"], b["ref"]))
    return b
