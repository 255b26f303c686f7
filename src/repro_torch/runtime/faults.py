"""Deterministic fault injection: first-class chaos for the serving stack.

PyTorch-port counterpart of ``repro/runtime/faults.py``, with the same
registry. Faults are *injectable at named points*, so chaos tests are
deterministic pytest cases (``-m chaos``):

    from repro_torch.runtime import faults

    with faults.inject("serve.step", exc=TransientWorkerError("kill"),
                       times=1):
        out = supervisor.generate(tokens, gen_len=8)   # retries, heals

Each fault point is *registered* (``FAULT_POINTS``) so a typo'd injection
fails immediately instead of silently never firing. Instrumented code
calls :func:`fire` (count + optional sleep + optional raise) or
:func:`take` (count only, returns whether the fault is live -- for
effects the injection site applies itself, e.g. byte corruption). A
fault fires at most ``times`` times (``times=None`` = every call), so a
transient fault heals on retry by construction.

Registered points, each with its site:

    backend.op         entry of every GuardedBackend op dispatch
                       (``api/backend.py``; detail = "<op>:<backend name>")
    serve.step         every supervised prefill/decode/classify call
                       (``runtime/serving.py``; exc => worker kill;
                       delay => slow step)
    serve.nan_poison   poisons supervised logits with NaN
                       (``runtime/serving.py``; the numeric-integrity
                       guard must catch it)
    engine.step_stall  entry of every batching-engine decode step
                       (``runtime/batching/engine.py``; delay => stuck
                       step; the watchdog's per-step deadline must trip
                       and restart-and-replay)
    ckpt.leaf_corrupt  flips a byte of one leaf file inside a checkpoint
                       save (``ckpt/checkpoint.py``; CRC verification must
                       reject it on restore, or at save with verify=True)
    ckpt.crash_rename  raises just before the atomic rename
                       (``ckpt/checkpoint.py``; a torn save must never
                       shadow the previous good checkpoint)
    weights.bitflip    flips one bit of an in-memory packed weight plane
                       at the engine's integrity tick
                       (``runtime/batching/engine.py``; the CRC
                       fingerprint check must detect it within one
                       cadence and self-heal via reload_checkpoint)
    backend.silent_corrupt
                       perturbs a GuardedBackend op's output WITHOUT
                       raising (``api/backend.py``; detail = "<op>:<backend
                       name>") -- the silent half of the fault model; only
                       the shadow auditor (``runtime/audit.py``) can catch
                       it

The registry matches the reference's point for point. One difference by
design: the port runs eagerly, so ``backend.silent_corrupt`` corrupts the
dispatches it fires on and no others (in the reference it fires while a
jitted step traces and stays baked into the cache until a re-jit): arm it
with ``match`` on the inner backend's name and enough ``times`` to cover
the request.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

FAULT_POINTS = frozenset({
    "backend.op",
    "serve.step",
    "serve.nan_poison",
    "engine.step_stall",
    "ckpt.leaf_corrupt",
    "ckpt.crash_rename",
    "weights.bitflip",
    "backend.silent_corrupt",
})


class UnknownFaultPoint(ValueError):
    """Injection at a name that is not in ``FAULT_POINTS``."""


@dataclasses.dataclass
class Fault:
    """One active injection: what to do, at which point, how many times."""

    point: str
    exc: BaseException | type | None = None
    times: int | None = 1          # None = fire on every matching call
    delay: float = 0.0             # seconds to sleep when firing
    match: str | None = None       # substring filter on the site's detail
    fired: int = 0                 # how many times it actually fired

    def _matches(self, detail: str) -> bool:
        return self.match is None or self.match in detail


_ACTIVE: dict[str, Fault] = {}
_LOCK = threading.Lock()


def _check_point(point: str) -> None:
    if point not in FAULT_POINTS:
        raise UnknownFaultPoint(
            f"unknown fault point {point!r}; registered: "
            f"{sorted(FAULT_POINTS)}")


@contextlib.contextmanager
def inject(point: str, *, exc: BaseException | type | None = None,
           times: int | None = 1, delay: float = 0.0,
           match: str | None = None):
    """Activate a fault at ``point`` for the duration of the block.

    ``exc``: exception instance or class raised when the fault fires.
    ``times``: fire on the first N matching calls (None = always).
    ``delay``: sleep this long when firing (slow-step simulation).
    ``match``: only fire when the site's detail string contains this.
    Yields the :class:`Fault` so tests can assert ``fault.fired``.
    """
    _check_point(point)
    fault = Fault(point=point, exc=exc, times=times, delay=delay,
                  match=match)
    with _LOCK:
        _ACTIVE[point] = fault
    try:
        yield fault
    finally:
        with _LOCK:
            if _ACTIVE.get(point) is fault:
                del _ACTIVE[point]


def active(point: str) -> Fault | None:
    """The live fault at ``point``, or None."""
    _check_point(point)
    return _ACTIVE.get(point)


def active_points() -> tuple[str, ...]:
    """Names of every point with a live fault (test-hygiene check: the
    port's autouse test fixtures fail a test that leaks one)."""
    with _LOCK:
        return tuple(sorted(_ACTIVE))


def take(point: str, detail: str = "") -> bool:
    """Count a firing at ``point``; True when the site must apply the
    fault's effect itself (byte corruption etc.). Never raises/sleeps."""
    _check_point(point)
    with _LOCK:
        fault = _ACTIVE.get(point)
        if fault is None or not fault._matches(detail):
            return False
        if fault.times is not None and fault.fired >= fault.times:
            return False
        fault.fired += 1
        return True


def fire(point: str, detail: str = "") -> None:
    """Fault-point hook: sleep ``delay`` and/or raise ``exc`` when a
    matching fault is live. A no-op (one dict lookup) otherwise."""
    if not _ACTIVE:          # fast path: nothing injected anywhere
        _check_point(point)
        return
    if not take(point, detail):
        return
    fault = _ACTIVE.get(point)
    if fault is None:        # raced with exit; effect already counted
        return
    if fault.delay:
        time.sleep(fault.delay)
    if fault.exc is not None:
        exc = fault.exc() if isinstance(fault.exc, type) else fault.exc
        raise exc


def reset() -> None:
    """Deactivate every fault (test teardown safety net)."""
    with _LOCK:
        _ACTIVE.clear()
