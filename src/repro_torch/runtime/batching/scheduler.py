"""FCFS request queue + dynamic batch assembly for the batching engine.

PyTorch-port counterpart of ``repro/runtime/batching/scheduler.py`` (pure
Python, unchanged in behaviour).

Admission policy is deliberately simple and deterministic: first come,
first served, one request per free slot, assembled at decode-step
boundaries. Requests join a running batch the step after a slot frees
(no drain barrier: in-flight requests never wait for the newcomer's
prefill beyond the step it is admitted in) and retire the step they
emit their last token. Cancellation is honored lazily — a cancelled
request still in the queue is dropped at assembly time (or purged early
when a full bounded queue needs its slot back).

Overload protection: the queue is optionally BOUNDED
(``max_queue``). A submit against a full queue first purges cancelled
tenants (a cancel-while-queued must free its slot), then either raises
a typed :class:`~repro_torch.api.guards.QueueFullError` immediately or — in
blocking mode — waits up to ``timeout`` seconds for assembly to free a
slot. Requests may carry a deadline; :meth:`assemble` sheds queued
requests whose deadline already passed WITHOUT letting them consume an
admission slot, so an expired head never blocks the live request behind
it. All queue mutation happens under one condition variable: submitters
on caller threads and the engine's step loop compose safely.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque

import numpy as np

from repro_torch.api import guards
from repro_torch.runtime.batching import streams


@dataclasses.dataclass
class Request:
    """One request's engine-side bookkeeping."""

    request_id: int
    prompt: np.ndarray            # [S] int32
    gen_len: int
    stream: streams.StreamHandle
    submit_t: float
    deadline_t: float | None = None  # monotonic deadline (None = unbounded)
    slot: int = -1
    token: int = 0                # last generated token (next decode input)
    pos: int = 0                  # absolute position the next decode writes
    n_generated: int = 0          # tokens generated THIS incarnation
    n_emitted: int = 0            # tokens delivered to the stream (monotone)
    weights_gen: int = 0          # engine weight swaps before its 1st token

    def emit(self, token: int) -> bool:
        """Record one generated token; deliver it unless a restart replay
        already delivered it (replays regenerate deterministically, so
        suppressed tokens are byte-identical to the originals). Returns
        True when the token reached the stream."""
        self.n_generated += 1
        self.token = int(token)
        if self.n_generated > self.n_emitted:
            self.stream._put(token)
            self.n_emitted = self.n_generated
            return True
        return False

    @property
    def finished(self) -> bool:
        return self.n_generated >= self.gen_len

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now >= self.deadline_t


class FCFSScheduler:
    """First-come-first-served queue with step-boundary batch assembly.

    ``max_queue``: bound on queued (not yet admitted) requests; None
    keeps the historical unbounded behavior.
    """

    def __init__(self, max_queue: int | None = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self._queue: deque[Request] = deque()
        self._ids = itertools.count()
        self._cond = threading.Condition()

    def submit(self, prompt, gen_len: int, *, deadline_s: float | None = None,
               block: bool = False, timeout: float | None = None) -> Request:
        """Enqueue one request; typed backpressure when the queue is full.

        ``deadline_s``: seconds from now after which the request is shed
        (queued) or retired (in-flight) instead of served. ``block``:
        wait up to ``timeout`` seconds for a queue slot before raising
        :class:`~repro_torch.api.guards.QueueFullError` (non-blocking submit
        raises immediately).
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if gen_len < 1:
            raise ValueError(f"gen_len must be >= 1, got {gen_len}")
        with self._cond:
            if not self._has_space_locked():
                if not block:
                    raise guards.QueueFullError(
                        f"queue full ({self.max_queue} queued); shed load "
                        f"or submit(block=True, timeout=...)")
                ok = self._cond.wait_for(self._has_space_locked,
                                         timeout=timeout)
                if not ok:
                    raise guards.QueueFullError(
                        f"queue still full ({self.max_queue} queued) after "
                        f"blocking {timeout}s for a slot")
            now = time.monotonic()
            rid = next(self._ids)
            req = Request(request_id=rid, prompt=prompt,
                          gen_len=int(gen_len),
                          stream=streams.StreamHandle(rid),
                          submit_t=now,
                          deadline_t=None if deadline_s is None
                          else now + float(deadline_s))
            self._queue.append(req)
            return req

    def _has_space_locked(self) -> bool:
        """Queue has room (cancelled tenants are purged first — a
        cancel-while-queued frees its slot for new admissions)."""
        if self.max_queue is None or len(self._queue) < self.max_queue:
            return True
        live = [r for r in self._queue if not r.stream.cancel_requested]
        if len(live) < len(self._queue):
            for r in self._queue:
                if r.stream.cancel_requested:
                    r.stream._finish(streams.CANCELLED)
            self._queue = deque(live)
        return len(self._queue) < self.max_queue

    @property
    def depth(self) -> int:
        """Queued (not yet admitted) requests, cancelled ones included —
        they are only dropped at assembly/purge time."""
        with self._cond:
            return len(self._queue)

    def assemble(self, n_slots: int, now: float | None = None
                 ) -> tuple[list[Request], list[Request], list[Request]]:
        """Take up to ``n_slots`` admissible requests, FCFS.

        Returns ``(admitted, dropped, expired)``: ``dropped`` are
        requests cancelled while still queued, ``expired`` are requests
        whose deadline passed while queued — the caller finishes their
        streams (cancelled / typed timeout). Neither consumes an
        admission slot, so a dead request at the head never blocks the
        live one behind it. With a full pool (``n_slots == 0``) and an
        empty queue this is a no-op.
        """
        now = time.monotonic() if now is None else now
        admitted: list[Request] = []
        dropped: list[Request] = []
        expired: list[Request] = []
        with self._cond:
            while self._queue and len(admitted) < n_slots:
                req = self._queue.popleft()
                if req.stream.cancel_requested:
                    dropped.append(req)
                elif req.expired(now):
                    expired.append(req)
                else:
                    admitted.append(req)
            if dropped or expired or admitted:
                self._cond.notify_all()
        return admitted, dropped, expired

    def drain_queue(self) -> list[Request]:
        """Remove and return every queued request (engine shutdown —
        the caller fails their streams loudly)."""
        with self._cond:
            out = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        return out
