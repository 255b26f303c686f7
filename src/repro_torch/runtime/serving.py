"""Serving supervisor: retries, timeouts, health, numeric integrity.

PyTorch-port counterpart of ``repro/runtime/serving.py``. It grows
request-level fault handling around a
:class:`repro_torch.api.session.ServingSession`, the request path the
batching engine sits on:

    session = repro_torch.compile(cfg, policy, mode="serve_packed",
                                  guarded=True)
    sup = ServingSupervisor(session, max_retries=2, timeout_s=30.0)
    gen = sup.generate(tokens, gen_len=16)     # retried / degraded / typed
    sup.health()    # {"state": "healthy", "stats": {...}, "fallbacks": {}}

Per request, the supervisor:

  * runs the session entry point on a worker thread with a per-request
    timeout (a wedged step surfaces as a typed
    :class:`~repro_torch.api.guards.RequestTimeoutError`, not a hang);
  * retries *transient* faults (``TransientWorkerError``, backend
    transients, timeouts, numeric poisoning) with bounded exponential
    backoff -- the session is deterministic, so a healed retry reproduces
    the uninterrupted token stream byte-identically;
  * on a *permanent* backend fault (compile/resource), degrades the whole
    session down ``FALLBACK_BACKENDS`` via the ``rebuild`` hook (when
    provided) and retries once per remaining backend -- off the card
    only: a session on the card fails loudly instead, since the plain
    version does not stand in for a kernel there;
  * checks that every output's logits are finite
    (:func:`repro_torch.api.guards.check_finite`, one bool to the host):
    NaN/Inf logits raise a typed error instead of argmax-ing garbage into
    a silent wrong answer.

A worker thread starts with PyTorch's default stream and without
``inference_mode`` (both are per thread): the session's entry points set
``inference_mode`` themselves, and the kernel wrappers launch on the
thread's current stream, so a request on a worker runs the same kernels
on the same operands.

Health state machine (exposed for the batching front end):

    healthy   all requests clean, no fallbacks recorded
    degraded  at least one retry/fallback was needed but serving works
    failed    a request exhausted its retries / hit a non-healable fault

``failed`` is sticky until a request completes cleanly end-to-end, which
moves the state back to ``degraded`` (never silently back to healthy).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import time
import warnings

import torch

from repro_torch.api import guards
from repro_torch.runtime import faults
from repro_torch.runtime.supervisor import StepMonitor, TransientWorkerError

HEALTHY, DEGRADED, FAILED = "healthy", "degraded", "failed"

# The backends a degraded session is rebuilt on, in order.
FALLBACK_BACKENDS = ("torch_ref",)

# Faults a plain (same-session) retry may heal.
_RETRYABLE = (TransientWorkerError, guards.BackendTransientError,
              guards.RequestTimeoutError, guards.NumericIntegrityError,
              TimeoutError, ConnectionError)


@dataclasses.dataclass
class ServeStats:
    """Counters + gauges the health report exposes.

    The ``n_*`` counters are monotone. The serving-metric gauges below
    them are fed by the continuous-batching engine
    (:class:`repro_torch.runtime.batching.BatchingEngine` calls
    :meth:`note_serving` after every step) and reflect the current or
    most recent engine run."""

    n_requests: int = 0
    n_ok: int = 0
    n_retries: int = 0
    n_timeouts: int = 0
    n_numeric_faults: int = 0
    n_session_fallbacks: int = 0
    n_failed: int = 0
    n_slow_requests: int = 0
    last_error: str = ""
    # -- engine-fed serving metrics -----------------------------------------
    n_tokens_streamed: int = 0          # monotone: tokens delivered
    n_engine_restarts: int = 0          # monotone: restart-and-replay count
    n_rejected: int = 0                 # monotone: QueueFullError admissions
    n_shed: int = 0                     # monotone: expired while queued
    n_deadline_expired: int = 0         # monotone: expired in flight
    n_reloads: int = 0                  # monotone: hot checkpoint swaps
    # -- silent-corruption defense ------------------------------------------
    n_audits: int = 0                   # monotone: shadow-audit replays run
    n_divergences: int = 0              # monotone: audits that diverged
    n_integrity_checks: int = 0         # monotone: weight-fingerprint checks
    n_quarantines: int = 0              # monotone: backends quarantined
    p95_audit_lag_s: float = 0.0        # gauge: completion -> audit verdict
    queue_depth: int = 0                # requests waiting for a slot
    batch_occupancy: float = 0.0        # mean active slots per decode step
    # tokens streamed over the wall time from the engine's first step to
    # its latest step's end, the time between steps included
    tokens_per_s: float = 0.0
    mean_request_latency_s: float = 0.0  # submit -> done, completed requests
    # request-latency / queue-wait percentiles over a bounded ring buffer
    # (the last ~512 completions/admissions)
    p50_request_latency_s: float = 0.0
    p95_request_latency_s: float = 0.0
    p50_queue_wait_s: float = 0.0
    p95_queue_wait_s: float = 0.0

    def note_serving(self, *, queue_depth: int, batch_occupancy: float,
                     tokens_per_s: float, mean_request_latency_s: float,
                     n_tokens_streamed: int, n_engine_restarts: int,
                     p50_request_latency_s: float = 0.0,
                     p95_request_latency_s: float = 0.0,
                     p50_queue_wait_s: float = 0.0,
                     p95_queue_wait_s: float = 0.0,
                     p95_audit_lag_s: float = 0.0) -> None:
        """Engine hook: overwrite the serving gauges in one call."""
        self.queue_depth = queue_depth
        self.batch_occupancy = batch_occupancy
        self.tokens_per_s = tokens_per_s
        self.mean_request_latency_s = mean_request_latency_s
        self.n_tokens_streamed = n_tokens_streamed
        self.n_engine_restarts = n_engine_restarts
        self.p50_request_latency_s = p50_request_latency_s
        self.p95_request_latency_s = p95_request_latency_s
        self.p50_queue_wait_s = p50_queue_wait_s
        self.p95_queue_wait_s = p95_queue_wait_s
        self.p95_audit_lag_s = p95_audit_lag_s


class ServingSupervisor:
    """Wraps ServingSession entry points with retry/timeout/health.

    ``session``: a compiled :class:`~repro_torch.api.session.ServingSession`.
    ``max_retries``: transient-fault retries per request (beyond the
    first attempt). ``backoff_s``: base of the exponential backoff.
    ``timeout_s``: per-request wall-clock budget (None = unbounded).
    ``rebuild``: optional ``rebuild(backend_name) -> ServingSession`` hook
    enabling whole-session degradation on permanent faults of a session
    off the card, walked down ``FALLBACK_BACKENDS``. Every output's
    logits are checked finite (bit-transparent: values are never
    modified).
    """

    def __init__(self, session, *, max_retries: int = 2,
                 backoff_s: float = 0.02, timeout_s: float | None = None,
                 rebuild=None):
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.rebuild = rebuild
        self.fallback_backends = list(FALLBACK_BACKENDS)   # still to try
        self.state = HEALTHY
        self.stats = ServeStats()
        self.monitor = StepMonitor()        # request-latency straggler EMA
        self._executor: concurrent.futures.ThreadPoolExecutor | None = None
        self._session = self._instrument(session)

    # -- session instrumentation -------------------------------------------

    def _instrument(self, session):
        """Shallow-copy the session with every entry point wrapped: fault
        point -> call -> NaN poisoning point -> integrity check. The value
        path is untouched, so a fault-free supervised run is
        byte-identical to the bare session."""
        def wrap(fn, what):
            if fn is None:
                return None

            def stepped(*args, **kwargs):
                faults.fire("serve.step", detail=what)
                out = fn(*args, **kwargs)
                logits = out[0] if isinstance(out, tuple) else out
                if faults.take("serve.nan_poison", detail=what):
                    # Chaos: corrupt the logits for real -- without the
                    # integrity check below this WOULD be a silent wrong
                    # answer (argmax over NaN).
                    logits = torch.full_like(logits, float("nan"))
                    out = (logits,) + tuple(out[1:]) \
                        if isinstance(out, tuple) else logits
                guards.check_finite(logits, f"{what} logits")
                return out
            return stepped

        return dataclasses.replace(
            session,
            _prefill=wrap(session._prefill, "prefill"),
            _decode=wrap(session._decode, "decode"),
            _classify=wrap(session._classify, "classify"))

    # -- public request surface --------------------------------------------

    @property
    def session(self):
        """The (instrumented) session currently serving requests."""
        return self._session

    def generate(self, tokens, gen_len: int):
        return self._request(lambda s: s.generate(tokens, gen_len))

    def classify(self, x):
        return self._request(lambda s: s.classify(x))

    def health(self) -> dict:
        """Health snapshot for the batching front end / dashboards."""
        plan = self._session.plan
        return {"state": self.state,
                "backend": plan.backend.name,
                "fallbacks": plan.fallback_report(),
                "stats": dataclasses.asdict(self.stats)}

    def close(self):
        """Release the timeout executor. Waits for worker threads to
        drain; ``cancel_futures`` drops requests that never started -- a
        wedged in-flight call still has to drain, but nothing new is
        admitted behind it."""
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
            self._executor = None

    # -- request engine -----------------------------------------------------

    def _run_with_timeout(self, fn):
        if self.timeout_s is None:
            return fn(self._session)
        if self._executor is None:
            # >1 worker so a retry is not queued behind a wedged request
            # that is still draining (a launched computation cannot be
            # cancelled; the request times out, the thread drains).
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="serve-supervisor")
        fut = self._executor.submit(fn, self._session)
        try:
            return fut.result(timeout=self.timeout_s)
        except concurrent.futures.TimeoutError:
            raise guards.RequestTimeoutError(
                f"request exceeded timeout_s={self.timeout_s}") from None

    def _degrade_session(self, cause: Exception) -> bool:
        """Rebuild the session on the next fallback backend. True on
        success; False when no rebuild hook / chain exhausted, or when the
        session is on the card (its plain version does not stand in for
        a kernel there)."""
        if self.rebuild is None or self._session.device.type == "cuda":
            return False
        current = self._session.plan.backend.name
        names = [n for n in self.fallback_backends
                 if n != current and not current.endswith(f":{n}")]
        if not names:
            return False
        nxt = names[0]
        self.fallback_backends = names[1:]
        warnings.warn(
            f"[supervisor] session on backend {current!r} hit a permanent "
            f"fault ({type(cause).__name__}: {cause}) -- rebuilding on "
            f"{nxt!r}", RuntimeWarning, stacklevel=3)
        self._session = self._instrument(self.rebuild(nxt))
        self.stats.n_session_fallbacks += 1
        self.state = DEGRADED
        return True

    def _note_ok(self, degraded_run: bool):
        self.stats.n_ok += 1
        if degraded_run or self._session.plan.fallback_report():
            self.state = DEGRADED
        elif self.state == FAILED:
            # A clean request after failure: serving works again, but the
            # episode stays visible -- never silently back to healthy.
            self.state = DEGRADED

    def _request(self, fn):
        self.stats.n_requests += 1
        attempt = 0
        degraded_run = False
        while True:
            t0 = time.monotonic()
            try:
                out = self._run_with_timeout(fn)
            except _RETRYABLE as exc:
                self.stats.last_error = f"{type(exc).__name__}: {exc}"
                if isinstance(exc, guards.RequestTimeoutError):
                    self.stats.n_timeouts += 1
                if isinstance(exc, guards.NumericIntegrityError):
                    self.stats.n_numeric_faults += 1
                if attempt >= self.max_retries:
                    self.stats.n_failed += 1
                    self.state = FAILED
                    raise
                self.stats.n_retries += 1
                degraded_run = True
                time.sleep(self.backoff_s * (2 ** attempt))
                attempt += 1
                continue
            except Exception as exc:  # noqa: BLE001 -- classified below
                self.stats.last_error = f"{type(exc).__name__}: {exc}"
                kind = guards.classify_error(exc)
                if kind in (guards.COMPILE, guards.RESOURCE) \
                        and self._degrade_session(exc):
                    degraded_run = True
                    continue
                self.stats.n_failed += 1
                self.state = FAILED
                raise
            if self.monitor.observe(time.monotonic() - t0):
                self.stats.n_slow_requests += 1
            self._note_ok(degraded_run)
            return out
