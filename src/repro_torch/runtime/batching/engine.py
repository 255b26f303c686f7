"""BatchingEngine: continuous-batching decode loop over a ServingSession.

PyTorch-port counterpart of ``repro/runtime/batching/engine.py``. The step
loop (one :meth:`step` per decode-step boundary):

  1. retire requests whose callers cancelled since the last step;
  2. retire in-flight requests whose deadline passed -- typed
     :class:`~repro_torch.api.guards.RequestTimeoutError` on the stream,
     partial tokens retained;
  3. admit queued requests into free slots -- expired-while-queued
     requests are shed BEFORE prefill (typed timeout, never silent);
     each admission is a batch-1 prefill (bit-identical to a solo
     prefill of the same prompt) copied into its pool slot, so running
     requests never wait behind a drain barrier;
  4. run ONE batched decode over the full ``max_batch``-wide pool with
     per-slot positions (``pos: [B]``) and hand the argmax tokens to the
     per-request :class:`~repro_torch.runtime.batching.streams.StreamHandle`
     objects; inactive rows decode garbage into their own row only, and
     admission rewrites the whole row anyway;
  5. feed the serving gauges (queue depth, occupancy, tokens/s,
     p50/p95 latency + queue wait) into
     :class:`~repro_torch.runtime.serving.ServeStats`.

Overload protection and lifecycle:

  * **admission control** -- ``max_queue`` bounds the request queue; a
    full queue raises a typed ``QueueFullError`` (or blocks with a
    timeout in ``submit(block=True)``); per-request ``deadline_s``
    sheds/retires requests that can no longer be served in time.
  * **graceful lifecycle** -- the engine walks ``accepting -> draining ->
    stopped``: :meth:`drain` stops admissions and finishes in-flight
    work; :meth:`shutdown` drains within a wall-clock bound and then
    fails residual streams loudly with a typed ``EngineClosedError``.
    A step loop that dies with an unexpected exception fails every live
    stream with the typed cause -- ``result()``/iterators never hang.
  * **decode watchdog** -- ``step_timeout_s`` bounds one decode step; a
    stuck step (chaos point ``engine.step_stall``) trips a typed
    ``StepStallError`` and routes into restart-and-replay below. The
    watched call runs on a worker thread, on the caller's CUDA stream
    (streams are per thread), and ends by taking the argmax tokens to
    the host, so its deadline covers the device's work and not only the
    launches.

Hot checkpoint swap: :meth:`reload` validates a new DENSE param tree
against the plan (tree/shape/dtype + packed weight-group counts;
:meth:`reload_checkpoint` adds CRC via the checkpoint manifest, in the
reference's on-disk format) and replays the survivors under the new
weights between steps: every post-swap token equals what a fresh engine
started on the new checkpoint would emit at that position.

Silent-corruption defense:

  * **integrity cadence** -- ``integrity_every=N`` re-verifies the weight
    CRC32 fingerprint (``core.integrity``) every N steps, BEFORE the
    decode, so a flipped bit (chaos point ``weights.bitflip``, applied at
    the tick) never serves a token; ``heal_dir`` self-heals through
    :meth:`reload_checkpoint`, else the engine fails loudly with a typed
    ``WeightIntegrityError``.
  * **shadow audit** -- ``audit_rate=r`` samples completed requests and
    replays them on the reference oracle (``runtime.audit``, the plain
    versions on the session's device) at step boundaries; a divergence
    (chaos point ``backend.silent_corrupt``) quarantines the backend
    (demoting nothing on the card, where the plain version never takes
    over serving), degrades health, and writes a replayable repro bundle.
    ``audit_rate=0`` (default) builds nothing.

Byte-identity: the decode path has no cross-row coupling (per-ROW
activation quantization scales, per-slot causal masks over per-row
``slot_pos``, value-preserving dynamic plane truncation, integer-exact
kernels at any M, the MoE's per-row dispatch and per-row expert
products, the SSM's per-row state), so row ``r`` of the batched decode
equals a solo batch-1 ``session.generate`` of the same prompt over a
cache of the pool's ``max_seq`` slots (the cache length sets the length
of the decode attention's reductions). The fault-free path is byte-identical with or
without the watchdog: the watched call is the same computation.

Fault composition (with or without a :class:`ServingSupervisor`): the
decode writes the pool in place, so a fault in the middle of a step
leaves it half written, and a stalled call abandoned by the watchdog may
still write it later -- a naive step retry is impossible. Instead the
engine RESTARTS-AND-REPLAYS: every active request re-prefilled into the
pool (a new pool after a stall, whose abandoned call may still write the
old one), regenerated deterministically while the tokens its stream
already received are suppressed (replayed tokens are byte-identical by
the parity property). Restarts are bounded by ``max_restarts``
consecutive failures; prefill faults retry per request and fail only
that request's stream. Either way the QUEUE survives -- a faulted step
degrades the session, never the engine.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import time
import warnings
from collections import deque

import numpy as np
import torch

from repro_torch.api import guards
from repro_torch.runtime import faults, tracing
from repro_torch.runtime.batching import streams
from repro_torch.runtime.batching.kvpool import KVPool
from repro_torch.runtime.batching.scheduler import FCFSScheduler, Request

# Engine lifecycle states.
ACCEPTING, DRAINING, STOPPED = "accepting", "draining", "stopped"

# Completions (and admissions) the latency (and queue-wait) percentiles
# are taken over.
_LATENCY_RING = 512


def _retryable():
    from repro_torch.runtime.serving import _RETRYABLE
    return _RETRYABLE


def _pct(ring, q: float) -> float:
    if not ring:
        return 0.0
    return float(np.percentile(np.asarray(ring, np.float64), q))


def _on_stream(device: torch.device):
    """A context that makes the calling thread's current CUDA stream the
    one current here, on this thread (a no-op off the card)."""
    if device.type != "cuda":
        return contextlib.nullcontext
    stream = torch.cuda.current_stream(device)
    return lambda: torch.cuda.stream(stream)


class BatchingEngine:
    """Continuous-batching front end over a compiled ServingSession.

    ``session``: a :class:`~repro_torch.api.session.ServingSession` (LM),
    or a :class:`~repro_torch.runtime.serving.ServingSupervisor` wrapping
    one -- the engine then runs the supervisor's instrumented entry points
    (fault points + numeric-integrity checks fire per step), shares its
    :class:`ServeStats`, and degrades its health state on restarts.

    ``max_seq``: the pool's cache length (default ``cfg.max_seq``).
    ``max_queue``: bound on queued requests (None = unbounded).
    ``step_timeout_s``: decode-watchdog deadline per step (None = no
    watchdog). ``overload_window_s``: how long after the last overload
    event (shed / rejection / deadline expiry / restart) the engine-local
    health stays ``degraded`` before recovering. ``audit_rate``: the
    share of completed requests the shadow auditor replays on the
    ``torch_ref`` oracle (0 = no auditor), writing divergence bundles to
    ``audit_bundle_dir``; a request whose stream began before the latest
    weight swap is not audited. ``integrity_every``: re-verify the weight
    fingerprint every N steps (None/0 = off); ``heal_dir``: the checkpoint
    directory a violation self-heals from (None = fail loudly).
    """

    def __init__(self, session, *, max_batch: int = 8,
                 max_seq: int | None = None, max_restarts: int = 2,
                 prefill_retries: int = 2, backoff_s: float = 0.02,
                 max_queue: int | None = None,
                 step_timeout_s: float | None = None,
                 overload_window_s: float = 5.0,
                 audit_rate: float = 0.0,
                 audit_bundle_dir: str = "audit_bundles",
                 integrity_every: int | None = None,
                 heal_dir: str | None = None):
        from repro_torch.runtime import serving
        if isinstance(session, serving.ServingSupervisor):
            self.supervisor = session
            self.stats = session.stats
        else:
            self.supervisor = None
            self.stats = serving.ServeStats()
            self._bare_session = session
        if self.session._decode is None:
            raise ValueError(f"{self.session.cfg.name}: not an LM session "
                             f"(the batching engine serves decode loops)")
        self.max_batch = int(max_batch)
        self.max_restarts = int(max_restarts)
        self.prefill_retries = int(prefill_retries)
        self.backoff_s = float(backoff_s)
        self.step_timeout_s = step_timeout_s
        self.overload_window_s = float(overload_window_s)
        self.scheduler = FCFSScheduler(max_queue)
        self.pool = KVPool(self.session, self.max_batch, max_seq)
        self.max_seq = self.pool.max_seq
        self.active: dict[int, Request] = {}
        self.state = ACCEPTING
        self.last_drain_s = 0.0
        self._tok = np.zeros(self.max_batch, np.int32)
        self._pos = np.zeros(self.max_batch, np.int32)
        self._watchdog: concurrent.futures.ThreadPoolExecutor | None = None
        self._n_decode_steps = 0
        self._occ_sum = 0
        # The serving window of tokens/s: the first step's start to the
        # latest step's end (monotonic clock), time between steps included.
        self._first_step_t: float | None = None
        self._last_step_end_t = 0.0
        self._n_streamed = 0
        self._n_restarts = 0
        self._consec_restarts = 0
        self._last_overload_t = -float("inf")
        self._lat_sum = 0.0
        self._lat_n = 0
        self._lat_ring: deque[float] = deque(maxlen=_LATENCY_RING)
        self._wait_ring: deque[float] = deque(maxlen=_LATENCY_RING)
        # audit_rate > 0 attaches a ShadowAuditor replaying over the pool's
        # cache length; audit_rate == 0 builds NOTHING.
        self.auditor = None
        if audit_rate > 0.0:
            from repro_torch.runtime.audit import ShadowAuditor
            self.auditor = ShadowAuditor(rate=audit_rate,
                                         bundle_dir=audit_bundle_dir,
                                         max_seq=self.max_seq)
        self.integrity_every = None if integrity_every in (None, 0) \
            else int(integrity_every)
        self.heal_dir = heal_dir
        self._step_idx = 0

    @property
    def session(self):
        """The serving session (the supervisor's instrumented one when
        composed -- so a rebuilt/degraded session is picked up live)."""
        if self.supervisor is not None:
            return self.supervisor.session
        return self._bare_session

    @property
    def max_queue(self) -> int | None:
        return self.scheduler.max_queue

    @property
    def n_decode_steps(self) -> int:
        """Batched decode steps run so far (restarted ones excluded)."""
        return self._n_decode_steps

    # -- public surface ------------------------------------------------------

    def submit(self, prompt, gen_len: int, *, deadline_s: float | None = None,
               block: bool = False,
               timeout: float | None = None) -> streams.StreamHandle:
        """Enqueue one request; returns its stream immediately.

        ``deadline_s``: per-request TTL -- expired-while-queued requests
        are shed before prefill, in-flight requests past deadline retire
        at the next step boundary (typed ``RequestTimeoutError`` either
        way; partial tokens stay on the stream). ``block``/``timeout``:
        wait up to ``timeout`` seconds for a queue slot instead of
        raising ``QueueFullError`` immediately when the bounded queue is
        full (the engine must be stepping on another thread for a slot
        to free).
        """
        if self.state != ACCEPTING:
            raise guards.EngineClosedError(
                f"engine is {self.state}: not accepting new requests")
        try:
            req = self.scheduler.submit(prompt, gen_len,
                                        deadline_s=deadline_s,
                                        block=block, timeout=timeout)
        except guards.QueueFullError:
            self.stats.n_rejected += 1
            self._note_overload()
            raise
        self.stats.n_requests += 1
        self.stats.queue_depth = self.scheduler.depth
        return req.stream

    def step(self) -> bool:
        """One engine step (retire + admit + one batched decode). Returns
        True while there is work left (active slots or queued requests).
        An unexpected (non-healable) exception fails every live stream
        with the typed cause before propagating -- streams never hang on
        a dead engine."""
        try:
            return self._step_inner()
        except Exception as exc:  # noqa: BLE001 -- healable faults already
            #                       handled inside; anything here is fatal
            self._fail_all(exc)
            self._stop()
            raise

    def _step_inner(self) -> bool:
        with tracing.span("engine.step"):
            t0 = time.monotonic()
            if self._first_step_t is None:
                self._first_step_t = t0
            self._integrity_tick()
            self._retire_cancelled()
            self._retire_expired(t0)
            self._admit(t0)
            if self.active:
                self._decode_once()
            self._audit_tick()
            self._last_step_end_t = time.monotonic()
            self._feed_stats()
            return bool(self.active) or self.scheduler.depth > 0

    def run(self, max_steps: int | None = None) -> None:
        """Drive :meth:`step` until the queue and the batch drain."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps "
                    f"({len(self.active)} active, "
                    f"{self.scheduler.depth} queued)")

    # -- lifecycle: accepting -> draining -> stopped -------------------------

    def drain(self, max_steps: int | None = None) -> None:
        """Stop admissions, finish every queued + in-flight request, then
        stop. Terminal state: ``engine.state == "stopped"`` -- submits
        afterwards raise a typed ``EngineClosedError``."""
        if self.state == STOPPED:
            return
        self.state = DRAINING
        t0 = time.monotonic()
        self.run(max_steps=max_steps)
        self.last_drain_s = time.monotonic() - t0
        self._stop()

    def shutdown(self, timeout: float) -> dict:
        """Drain with a wall-clock bound; fail residual streams loudly.

        Steps the engine until it drains or ``timeout`` seconds elapse;
        any request still live at the bound is failed with a typed
        ``EngineClosedError`` (partial tokens stay on its stream).
        Returns ``{"drained", "n_failed_residual", "elapsed_s"}``.
        """
        if self.state == STOPPED:
            return {"drained": True, "n_failed_residual": 0, "elapsed_s": 0.0}
        self.state = DRAINING
        t0 = time.monotonic()
        deadline = t0 + float(timeout)
        drained = False
        while time.monotonic() < deadline:
            if not self.step():
                drained = True
                break
        n_residual = 0
        if not drained:
            exc = guards.EngineClosedError(
                f"engine shut down after {timeout}s with work in flight")
            n_residual = self._fail_all(exc)
        self.last_drain_s = time.monotonic() - t0
        self._stop()
        return {"drained": drained, "n_failed_residual": n_residual,
                "elapsed_s": self.last_drain_s}

    def _stop(self) -> None:
        self.state = STOPPED
        if self._watchdog is not None:
            # cancel_futures + no join: an abandoned (stalled) decode
            # cannot be interrupted; its worker exits once it drains.
            self._watchdog.shutdown(wait=False, cancel_futures=True)
            self._watchdog = None

    def _fail_all(self, exc: BaseException) -> int:
        """Fail every live stream (active + queued) with the typed cause
        so ``result()``/iterators never block on a dead engine."""
        n = 0
        for req in [self.active[s] for s in sorted(self.active)]:
            self._retire(req, streams.FAILED, exc)
            n += 1
        for req in self.scheduler.drain_queue():
            if req.stream.cancel_requested:
                req.stream._finish(streams.CANCELLED)
            else:
                req.stream._finish(streams.FAILED, exc)
                n += 1
        self.stats.queue_depth = 0
        self.state = STOPPED
        return n

    def health(self) -> dict:
        """Supervisor health when composed, else an engine-local view:
        ``degraded`` while a restart has ever happened or an overload
        event (shed / rejection / deadline expiry) is within
        ``overload_window_s``; recovers to ``healthy`` once the window
        passes with clean serving; a quarantine keeps it ``degraded``
        (the quarantine is sticky)."""
        if self.supervisor is not None:
            h = self.supervisor.health()
            h["engine_state"] = self.state
            return h
        from repro_torch.runtime import serving
        overloaded = (time.monotonic() - self._last_overload_t
                      < self.overload_window_s)
        state = serving.DEGRADED if (self._n_restarts or overloaded
                                     or self.stats.n_quarantines) \
            else serving.HEALTHY
        plan = self.session.plan
        return {"state": state, "backend": plan.backend.name,
                "engine_state": self.state,
                "fallbacks": plan.fallback_report(),
                "stats": dataclasses.asdict(self.stats)}

    # -- request lifecycle ---------------------------------------------------

    def _note_overload(self) -> None:
        self._last_overload_t = time.monotonic()

    def _retire(self, req: Request, state: str,
                error: BaseException | None = None) -> None:
        if req.slot in self.active:
            del self.active[req.slot]
            self.pool.free(req.slot)
        req.stream._finish(state, error)
        if state == streams.DONE:
            self.stats.n_ok += 1
            lat = time.monotonic() - req.submit_t
            self._lat_sum += lat
            self._lat_n += 1
            self._lat_ring.append(lat)
            # A stream begun before the latest swap holds the old
            # weights' prefix: no replay under the new ones can match it.
            if self.auditor is not None \
                    and req.weights_gen == self.stats.n_reloads:
                self.auditor.observe(req)
        elif state == streams.FAILED:
            self.stats.n_failed += 1
            self.stats.last_error = f"{type(error).__name__}: {error}"

    def _retire_cancelled(self) -> None:
        for req in [r for r in self.active.values()
                    if r.stream.cancel_requested]:
            self._retire(req, streams.CANCELLED)

    def _retire_expired(self, now: float) -> None:
        """In-flight requests past deadline retire at this step boundary;
        partial tokens stay available on the stream."""
        for req in [r for r in self.active.values() if r.expired(now)]:
            self.stats.n_deadline_expired += 1
            self._note_overload()
            del self.active[req.slot]
            self.pool.free(req.slot)
            req.stream._finish(streams.FAILED, guards.RequestTimeoutError(
                f"request {req.request_id}: deadline exceeded in flight "
                f"after {req.n_emitted}/{req.gen_len} tokens (partial "
                f"tokens retained on the stream)"))

    def _admit(self, now: float | None = None) -> None:
        admitted, dropped, expired = self.scheduler.assemble(
            self.pool.n_free, now)
        for req in dropped:
            req.stream._finish(streams.CANCELLED)
        for req in expired:
            self.stats.n_shed += 1
            self._note_overload()
            req.stream._finish(streams.FAILED, guards.RequestTimeoutError(
                f"request {req.request_id}: deadline exceeded while queued "
                f"-- shed before prefill"))
        for req in admitted:
            self._wait_ring.append(time.monotonic() - req.submit_t)
            self._place(req)
        if admitted or dropped or expired:
            self.stats.queue_depth = self.scheduler.depth

    def _place(self, req: Request) -> None:
        """Prefill ``req`` into a free slot (bounded per-request retries);
        a prefill that cannot heal fails ONLY this request's stream."""
        slot = self.pool.alloc()
        req.slot = slot
        if req.n_emitted == 0:       # the stream begins under these weights
            req.weights_gen = self.stats.n_reloads
        req.stream._set_state(streams.PREFILLING)
        try:
            self._prefill_into(req)
        except Exception as exc:  # noqa: BLE001 -- typed/classified upstream
            self.pool.free(slot)
            req.slot = -1
            self._retire(req, streams.FAILED, exc)
            return
        self.active[slot] = req
        self._tok[slot] = req.token
        self._pos[slot] = req.pos
        req.stream._set_state(streams.DECODING)
        if req.finished:           # gen_len == 1: the prefill token is all
            self._retire(req, streams.DONE)

    def _prefill_into(self, req: Request) -> None:
        s = int(req.prompt.shape[0])
        if s + req.gen_len > self.max_seq:
            raise ValueError(
                f"request {req.request_id}: prompt_len {s} + gen_len "
                f"{req.gen_len} exceeds the pool's max_seq {self.max_seq}")
        tokens = torch.from_numpy(req.prompt[None, :])
        attempt = 0
        with tracing.span("engine.prefill", req=req.request_id,
                          prompt_len=s):
            while True:
                try:
                    cache1 = self.session.init_cache(1, self.max_seq)
                    logits, cache1 = self.session.prefill(tokens,
                                                          cache=cache1)
                    tok0 = torch.argmax(logits[:, 0], dim=-1)[0]
                    with tracing.span("engine.to_host"):
                        tok0 = int(tok0)
                    break
                except _retryable() as exc:
                    if attempt >= self.prefill_retries:
                        raise
                    attempt += 1
                    self.stats.n_retries += 1
                    self._degrade(exc)
                    time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            self.pool.scatter_prefill(req.slot, cache1)
        req.pos = s
        self._emit(req, tok0)

    def _emit(self, req: Request, token: int) -> None:
        if req.emit(token):
            self._n_streamed += 1
            self.stats.n_tokens_streamed = self._n_streamed

    # -- the batched decode step ---------------------------------------------

    def _watched_decode(self) -> np.ndarray:
        """One batched decode, optionally under the watchdog's per-step
        deadline; returns the argmax tokens on the host. The watched call
        is the SAME computation either way (fault-free numerics are
        byte-identical with or without the watchdog); a step that exceeds
        ``step_timeout_s`` surfaces as a typed ``StepStallError``. The
        abandoned call may still write the pool it was given, so the
        caller routes into restart-and-replay, which allocates a new one."""
        session = self.session
        tok = self._tok.copy()     # the call owns its inputs: a restart
        pos = self._pos.copy()     # resets the engine's own arrays
        cache = self.pool.cache

        def call():
            faults.fire("engine.step_stall", detail="decode")
            logits, _ = session.decode(tok, pos, cache)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            with tracing.span("engine.to_host"):
                return toks.cpu().numpy()

        if self.step_timeout_s is None:
            return call()
        if self._watchdog is None:
            # >1 worker so the step after an abandoned stall is not
            # queued behind the still-draining stalled call.
            self._watchdog = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="engine-watchdog")
        on_stream = _on_stream(session.device)

        def watched():
            with on_stream():
                return call()

        fut = self._watchdog.submit(watched)
        try:
            return fut.result(timeout=self.step_timeout_s)
        except concurrent.futures.TimeoutError:
            # The stalled call cannot be cancelled; its worker drains in
            # the background. The STEP times out, with a typed error.
            raise guards.StepStallError(
                f"decode step exceeded step_timeout_s="
                f"{self.step_timeout_s}") from None

    def _decode_once(self) -> None:
        try:
            toks = self._watched_decode()
        except _retryable() as exc:
            self._restart(exc)
            return
        self._consec_restarts = 0
        self._n_decode_steps += 1
        self._occ_sum += len(self.active)
        for slot in sorted(self.active):
            req = self.active[slot]
            self._emit(req, int(toks[slot]))
            req.pos += 1
            self._tok[slot] = req.token
            self._pos[slot] = req.pos
            if req.finished:
                self._retire(req, streams.DONE)
            elif req.stream.cancel_requested:
                self._retire(req, streams.CANCELLED)

    # -- silent-corruption defense (integrity cadence + shadow audit) ---------

    def _integrity_tick(self) -> None:
        """Every ``integrity_every`` steps: re-verify the weight CRC32
        fingerprint (+ pass-law plan metadata). A violation (e.g. the
        ``weights.bitflip`` chaos point, applied right here so the
        corrupted planes NEVER serve a decode undetected) self-heals
        through the CRC-verified :meth:`reload_checkpoint` path when
        ``heal_dir`` is configured, else fails the engine loudly --
        corrupt weights are never served silently either way."""
        if self.integrity_every is None \
                or self.session.fingerprint is None:
            return
        tick = self._step_idx % self.integrity_every == 0
        self._step_idx += 1
        if not tick:
            return
        if faults.take("weights.bitflip"):
            from repro_torch.core import integrity as integ
            self.session.params, leaf = integ.flip_one_bit(
                self.session.params)
            warnings.warn(f"[chaos] weights.bitflip: flipped one bit of "
                          f"leaf {leaf!r}", RuntimeWarning, stacklevel=2)
        self.stats.n_integrity_checks += 1
        try:
            self.session.verify_integrity("engine integrity tick")
        except guards.WeightIntegrityError as exc:
            self._note_overload()
            self._degrade(exc)
            if self.heal_dir is None:
                raise
            warnings.warn(
                f"[engine] weight integrity violation -- self-healing from "
                f"the last good checkpoint in {self.heal_dir!r} ({exc})",
                RuntimeWarning, stacklevel=2)
            self.reload_checkpoint(self.heal_dir)

    def _audit_tick(self) -> None:
        """Drain the shadow auditor's sampled requests (off the hot path:
        after the batched decode, never inside it). Any divergence
        quarantines the serving backend once and counts in the stats; the
        repro bundle was already written by the auditor."""
        if self.auditor is None or not self.auditor.n_pending:
            return
        n, results = self.auditor.drain(self.session)
        self.stats.n_audits += n
        failures = [r for r in results if not r.ok]
        if failures:
            self.stats.n_divergences += len(failures)
            self._quarantine(failures[0].error)

    def _quarantine(self, exc: BaseException) -> None:
        """Silent divergence response: sticky-demote the serving backend
        along the chain usable on the session's device
        (``GuardedBackend.quarantine``; on the card that chain ends at the
        kernels, so nothing is demoted), refresh the session's entry
        points and replay the survivors -- off the card their suffix
        comes from the trusted substrate. Unguarded sessions, and the
        card, cannot demote a backend; health still degrades and the
        divergence stays counted + bundled."""
        self.stats.n_quarantines += 1
        self._note_overload()
        self._degrade(exc)
        be = self.session.plan.backend
        if hasattr(be, "quarantine"):
            be.quarantine(str(exc), device=self.session.device)
        self._rejit_session()
        self._replay_survivors()

    def _rejit_session(self) -> None:
        """Swap in fresh entry points for the current session (same
        cfg/plan/params) -- re-instrumented when supervised, so the fault
        points and numeric-integrity checks stay attached."""
        fresh = self.session.rejit()
        if self.supervisor is not None:
            self.supervisor._session = self.supervisor._instrument(fresh)
        else:
            self._bare_session = fresh

    # -- restart-and-replay ----------------------------------------------------

    def _degrade(self, exc: BaseException) -> None:
        self.stats.last_error = f"{type(exc).__name__}: {exc}"
        if self.supervisor is not None:
            from repro_torch.runtime import serving
            if self.supervisor.state == serving.HEALTHY:
                self.supervisor.state = serving.DEGRADED

    def _clear_pool(self, exc: BaseException | None) -> list[Request]:
        """Take the active requests out of their slots; returns them in
        slot order. After a stall the abandoned call may still write the
        pool, so a new one is allocated, the old one dropped first (the
        abandoned call holds it until it ends). After any other fault
        nothing writes the pool any more: its free list is reset and the
        half-written rows are rewritten whole by the replays'
        :meth:`KVPool.scatter_prefill`, so no second pool is held."""
        survivors = [self.active[s] for s in sorted(self.active)]
        self.active.clear()
        self._tok[:] = 0
        self._pos[:] = 0
        if not isinstance(exc, guards.StepStallError):
            self.pool.reset()
            return survivors
        self.pool = None
        try:
            self.pool = KVPool(self.session, self.max_batch, self.max_seq)
        except Exception as alloc_exc:
            for req in survivors:      # out of the pool: fail them here
                req.slot = -1
                self._retire(req, streams.FAILED, alloc_exc)
            raise
        return survivors

    def _restart(self, exc: BaseException) -> None:
        """A decode step faulted: clear the pool and REPLAY every active
        request from its prompt, suppressing already-delivered tokens
        (deterministic regeneration => the suppressed prefix is
        byte-identical to what the streams already saw). Past
        ``max_restarts`` consecutive failures the active streams fail
        loudly with the cause, and the queue serves on."""
        self._consec_restarts += 1
        self._n_restarts += 1
        self.stats.n_engine_restarts = self._n_restarts
        self._note_overload()
        self._degrade(exc)
        survivors = self._clear_pool(exc)
        if self._consec_restarts > self.max_restarts:
            from repro_torch.runtime import serving
            if self.supervisor is not None:
                self.supervisor.state = serving.FAILED
            for req in survivors:
                req.slot = -1
                self._retire(req, streams.FAILED, exc)
            return
        self._replay(survivors)

    def _replay(self, survivors: list[Request]) -> None:
        """Re-prefill ``survivors`` into the (cleared) pool; their streams
        suppress the tokens they already received."""
        for req in survivors:
            req.n_generated = 0
            req.token = 0
            req.pos = 0
            self._place(req)

    def _replay_survivors(self) -> None:
        """Take every active request out of the pool (reused: the replays
        rewrite their rows whole) and REPLAY it from its prompt --
        deterministic regeneration => the suppressed prefix is
        byte-identical to what the streams already saw under unchanged
        weights; after a hot swap the suffix is the new checkpoint's
        stream."""
        self._replay(self._clear_pool(None))

    # -- hot checkpoint swap ---------------------------------------------------

    def reload(self, params) -> None:
        """Hot-swap serving weights between steps (no engine restart).

        ``params``: a DENSE-layout param tree (tensors or numpy arrays, as
        ``model.init_params`` makes it or ``ckpt.restore_checkpoint``
        restores it, the reference's trees through ``interop``); it is
        put on the session's device, run through the serving conversion
        ``compile`` uses, validated against the compiled plan (tree
        structure, per-leaf shape/dtype, and -- when the plan recorded
        pack-time weight-group counts -- count equality) and only then
        swapped in. Survivors are re-prefilled under the new weights:
        every token emitted after the swap is byte-identical to what a
        fresh engine started on the new checkpoint would emit at that
        position. A typed ``ReloadMismatchError`` leaves the engine
        serving the old weights untouched.
        """
        from repro_torch import interop
        from repro_torch.api.session import _SERVING_MODES
        from repro_torch.models import model as M
        if self.state == STOPPED:
            raise guards.EngineClosedError("engine is stopped: cannot reload")
        sess = self.session
        plan = sess.plan
        converted = interop.params_from_numpy(params, sess.device)
        if plan.mode in _SERVING_MODES:
            try:
                converted = M.convert_params_for_serving(
                    converted, plan.policy, plan.mode)
            except Exception as exc:  # noqa: BLE001 -- conversion rejects
                raise guards.ReloadMismatchError(
                    f"new param tree failed the serving conversion for "
                    f"mode={plan.mode!r}: {type(exc).__name__}: {exc}"
                ) from exc
        self._validate_swap(converted)
        self._check_weight_groups(converted)
        sess.params = converted
        # The swap is intentional: re-anchor the integrity fingerprint to
        # the new weights, and drop the auditor's reference session +
        # pending records (they were produced by the old weights).
        if sess.fingerprint is not None:
            sess.refingerprint()
        if self.auditor is not None:
            self.auditor.invalidate_reference()
        self.stats.n_reloads += 1
        self._replay_survivors()

    def reload_checkpoint(self, ckpt_dir: str, step: int | None = None) -> int:
        """Hot-swap from an on-disk checkpoint (either package's):
        CRC/shape/dtype-verified restore onto the session's device (the
        manifest; corrupt steps fall back to the previous good one),
        followed by :meth:`reload`. The restore's ``like`` tree is
        ``model.param_skeleton``: shapes and dtypes, nothing drawn.
        Returns the step actually loaded."""
        from repro_torch.ckpt import checkpoint as ckpt
        from repro_torch.models import model as M
        skel = M.param_skeleton(self.session.cfg)
        device = self.session.device
        if step is None:
            params, got = ckpt.restore_latest(ckpt_dir, skel, device=device)
            if params is None:
                raise guards.ReloadMismatchError(
                    f"no checkpoints found in {ckpt_dir!r}")
        else:
            params, got = ckpt.restore_checkpoint(ckpt_dir, step, skel,
                                                  device=device)
        self.reload(params)
        return got

    def _validate_swap(self, converted) -> None:
        """The new tree must match the compiled plan's param tree exactly
        in structure, per-leaf shape and dtype."""
        from repro_torch import interop
        cur = interop.flatten_with_paths(self.session.params)
        new = interop.flatten_with_paths(converted)
        if list(cur) != list(new):
            raise guards.ReloadMismatchError(
                "new param tree structure does not match the compiled "
                "plan's (different layers/keys) -- recompile instead of "
                "hot-swapping")
        for key, c in cur.items():
            n = new[key]
            if tuple(n.shape) != tuple(c.shape):
                raise guards.ReloadMismatchError(
                    f"leaf {key!r}: shape {tuple(n.shape)} != plan's "
                    f"{tuple(c.shape)}")
            if n.dtype != c.dtype:
                raise guards.ReloadMismatchError(
                    f"leaf {key!r}: dtype {n.dtype} != plan's {c.dtype}")

    def _check_weight_groups(self, converted) -> None:
        """Pack-time weight-group counts are plan constants -- a swap that
        changes them silently would execute the wrong plane partitions.
        Recompute from the new packed tree and require equality; a
        mismatch means the new checkpoint needs a recompile, not a hot
        swap."""
        from repro_torch.api.plan import counted_weights
        plan = self.session.plan
        new = plan.weight_group_counts(
            counted_weights(self.session.cfg, converted))
        for (name, kind), counts in new.items():
            want = plan.layers[(name, kind)].w_group_counts
            if counts != want:
                raise guards.ReloadMismatchError(
                    f"layer {name!r} ({kind}): packed weight-group counts "
                    f"{counts} != the plan's {want} -- the new checkpoint "
                    f"changes the execution plan; recompile instead of "
                    f"hot-swapping")

    # -- metrics ---------------------------------------------------------------

    def _feed_stats(self) -> None:
        occ = self._occ_sum / max(1, self._n_decode_steps)
        self.stats.note_serving(
            queue_depth=self.scheduler.depth,
            batch_occupancy=occ,
            tokens_per_s=self._n_streamed / max(
                self._last_step_end_t - self._first_step_t, 1e-9),
            mean_request_latency_s=self._lat_sum / max(1, self._lat_n),
            n_tokens_streamed=self._n_streamed,
            n_engine_restarts=self._n_restarts,
            p50_request_latency_s=_pct(self._lat_ring, 50),
            p95_request_latency_s=_pct(self._lat_ring, 95),
            p50_queue_wait_s=_pct(self._wait_ring, 50),
            p95_queue_wait_s=_pct(self._wait_ring, 95),
            p95_audit_lag_s=self.auditor.lag_p95()
            if self.auditor is not None else 0.0)
