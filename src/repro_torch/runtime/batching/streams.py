"""Per-request token streams for the continuous-batching engine.

PyTorch-port counterpart of ``repro/runtime/batching/streams.py`` (pure
Python, unchanged in behaviour).

A :class:`StreamHandle` is the caller's view of one in-flight request:
an iterator that yields tokens as the engine emits them, a ``cancel()``
switch the engine honors at the next decode-step boundary, and a
done-future (:meth:`result`) that blocks until the request finishes and
returns the full token array (or raises the request's typed error).

States walk the engine's request machine::

    queued -> prefilling -> decoding -> done | cancelled | failed

All mutation happens under one condition variable so a driver thread
can run the engine while callers iterate streams concurrently.
"""
from __future__ import annotations

import threading

import numpy as np

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"

_TERMINAL = (DONE, CANCELLED, FAILED)


class StreamCancelled(RuntimeError):
    """``result()`` on a stream the caller cancelled."""


class StreamHandle:
    """One request's token stream. Produced by ``BatchingEngine.submit``."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self.state = QUEUED
        self._tokens: list[int] = []
        self._error: BaseException | None = None
        self._cancel_requested = False
        self._cond = threading.Condition()

    # -- engine side --------------------------------------------------------

    def _set_state(self, state: str) -> None:
        with self._cond:
            self.state = state
            self._cond.notify_all()

    def _put(self, token: int) -> None:
        with self._cond:
            self._tokens.append(int(token))
            self._cond.notify_all()

    def _finish(self, state: str, error: BaseException | None = None) -> None:
        with self._cond:
            self.state = state
            self._error = error
            self._cond.notify_all()

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_requested

    # -- caller side --------------------------------------------------------

    def cancel(self) -> None:
        """Ask the engine to retire this request at the next step
        boundary. Tokens already emitted stay available."""
        with self._cond:
            self._cancel_requested = True
            self._cond.notify_all()

    @property
    def done(self) -> bool:
        return self.state in _TERMINAL

    @property
    def n_tokens(self) -> int:
        with self._cond:
            return len(self._tokens)

    def tokens_so_far(self) -> np.ndarray:
        with self._cond:
            return np.asarray(self._tokens, np.int32)

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block until the request finishes; return its int32 tokens.

        Raises the request's error on FAILED, :class:`StreamCancelled`
        on CANCELLED, TimeoutError if ``timeout`` elapses first."""
        with self._cond:
            ok = self._cond.wait_for(lambda: self.state in _TERMINAL,
                                     timeout=timeout)
            if not ok:
                raise TimeoutError(
                    f"request {self.request_id}: no terminal state within "
                    f"{timeout}s (state={self.state})")
            if self.state == FAILED:
                raise self._error
            if self.state == CANCELLED:
                raise StreamCancelled(
                    f"request {self.request_id} was cancelled after "
                    f"{len(self._tokens)} tokens")
            return np.asarray(self._tokens, np.int32)

    def __iter__(self):
        """Yield tokens as they arrive; stop when the stream ends (for a
        FAILED stream, the error raises after the emitted tokens)."""
        i = 0
        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: len(self._tokens) > i or self.state in _TERMINAL)
                if len(self._tokens) > i:
                    tok = self._tokens[i]
                else:  # terminal, fully drained
                    if self.state == FAILED:
                        raise self._error
                    return
            yield tok
            i += 1

    def __repr__(self):
        return (f"StreamHandle(id={self.request_id}, state={self.state}, "
                f"n_tokens={self.n_tokens})")
