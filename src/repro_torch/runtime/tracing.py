"""Spans and counters inside the serving path, kept in memory.

Off by default, and then free of effects: :func:`span` hands back one
shared no-op context and :func:`count` returns at once, so no record is
made, no ``record_function`` is entered, no tensor is touched and nothing
is synchronised. A caller that wants to see where a step's time goes
turns it on around the work and takes the record afterwards:

    from repro_torch.runtime import tracing

    tracing.enable()
    session = repro_torch.compile(cfg, policy, mode="serve_packed")
    ...                                  # serve
    rec = tracing.collect()              # spans and summed counters
    tracing.disable()

On, each span records its name, start and end on ``time.perf_counter``,
its parent (the innermost span open on the same thread, or None) and its
attrs. While a ``torch.profiler`` is recording, each span also opens
``torch.profiler.record_function(name)``, so it sits in the profiler's
trace as a user annotation on the profiler's own clock, beside the
device operations launched inside it. A counter keeps each value as
given, a device tensor included, and sums them only in :func:`collect`,
so counting on the hot path never synchronises. Nothing is exported.

Every name is registered (``SPANS``, ``COUNTERS``), so a typo raises at
once instead of recording under a name no reader looks for. Each with its
site:

    session.classify, session.prefill, session.decode
                       each public entry point of ``ServingSession``
                       (``api/session.py``), inputs to the device included
    compile.fingerprint
                       the CRC32 fingerprint of the packed weights that
                       ``compile`` takes (``api/session.py``)
    engine.step        one batching-engine step: retire, admit, the
                       batched decode (``runtime/batching/engine.py``)
    engine.prefill     one admission: cache set-up, prefill, first token
                       on the host, scatter into the pool; attrs ``req``
                       (the request id) and ``prompt_len``
    engine.to_host     the engine's two device-to-host transfers: the
                       prefill's first token and the decode's tokens (on
                       the watchdog's worker thread when the step is
                       watched, where it and its ``session.decode`` have
                       no parent)
    moe.unpack         the per-call unpack of packed expert weights
                       (``models/moe.py`` ``_expert_weight``)
    ops.quantize       activation quantization with its int8 cast, in the
                       four serve routes of ``kernels/ops.py``
    ops.dequantize     the final dequantizing cast of those routes
    cnn.relu_pool      the ReLU and max-pool after each conv
                       (``models/cnn.py``)
    trim.counts        the OR-tree plane counts of the dynamic routes
                       (``kernels/ops.py``)
    trim.dense_weights the dense weight operand of the dynamic routes,
                       rebuilt on every call (``api/backend.py``)
    trim.pack_activations
                       the dynamic linear's activations packed at run time
                       (``kernels/ops.py``)

    moe.prefill_choices, moe.prefill_dropped
                       expert choices of a prefill (a row of more than one
                       token) and those past their expert's capacity
                       (``models/moe.py`` ``apply_train``)
    trim.a_planes, trim.a_static_planes
                       activation planes the dynamic routes hand their
                       kernels, and the static planes of the same groups
                       (``kernels/ops.py``)
"""
from __future__ import annotations

import dataclasses
import threading
import time

SPANS = frozenset({
    "session.classify", "session.prefill", "session.decode",
    "compile.fingerprint",
    "engine.step", "engine.prefill", "engine.to_host",
    "moe.unpack",
    "ops.quantize", "ops.dequantize",
    "cnn.relu_pool",
    "trim.counts", "trim.dense_weights", "trim.pack_activations",
})

COUNTERS = frozenset({
    "moe.prefill_choices", "moe.prefill_dropped",
    "trim.a_planes", "trim.a_static_planes",
})


class UnknownTraceName(ValueError):
    """A span or counter whose name is not registered."""


@dataclasses.dataclass
class Span:
    """One closed span; ``parent`` is the span it ran inside, or None."""

    name: str
    start: float
    end: float
    parent: Span | None
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Record:
    """What :func:`collect` hands back: the closed spans in the order they
    closed, and each counter's values summed."""

    spans: list
    counters: dict

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


_on = False
_spans: list = []
_counts: dict = {}
_lock = threading.Lock()
_local = threading.local()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _profiler_recording() -> bool:
    import torch
    return torch._C._autograd._profiler_enabled()


class _Live:
    """An open span: pushed on this thread's stack on entry, recorded and
    popped on exit (also when the body raises)."""

    __slots__ = ("span", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.span = Span(name, 0.0, 0.0, None, attrs)
        self._rf = None

    def __enter__(self):
        stack = _stack()
        self.span.parent = stack[-1] if stack else None
        stack.append(self.span)
        if _profiler_recording():
            import torch
            self._rf = torch.profiler.record_function(self.span.name)
            self._rf.__enter__()
        self.span.start = time.perf_counter()
        return self.span

    def __exit__(self, *exc):
        self.span.end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack().pop()
        with _lock:
            _spans.append(self.span)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A context around one piece of work: a no-op while tracing is off,
    else a :class:`Span` recorded when the block ends."""
    if name not in SPANS:
        raise UnknownTraceName(f"unknown span {name!r}; registered: "
                               f"{sorted(SPANS)}")
    if not _on:
        return _NOOP
    return _Live(name, attrs)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor whose elements are summed when
    read) to counter ``name``; nothing while tracing is off."""
    if name not in COUNTERS:
        raise UnknownTraceName(f"unknown counter {name!r}; registered: "
                               f"{sorted(COUNTERS)}")
    if not _on:
        return
    with _lock:
        _counts.setdefault(name, []).append(value)


def enabled() -> bool:
    """Whether spans and counters are being recorded (a site that must
    compute a counter's value asks first)."""
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def _total(values: list):
    out = 0
    for v in values:
        if hasattr(v, "sum"):
            s = v.sum()
            v = s.item() if s.is_floating_point() else int(s)
        out += v
    return out


def collect() -> Record:
    """The spans closed and the counters' sums since the last call, and
    clear them (whether tracing is on or off). Reading a device tensor's
    count synchronises, here and nowhere else."""
    with _lock:
        spans, counts = list(_spans), dict(_counts)
        _spans.clear()
        _counts.clear()
    return Record(spans, {k: _total(v) for k, v in counts.items()})
