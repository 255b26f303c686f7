"""Spans and counters that the benchmark records around its calls into
the program's layers, kept in memory for the run's metric readers.

A span is (name, start, end, attrs) on the host's monotonic clock
(``time.perf_counter``); spans of one request share ``attrs["req"]``.
Counters are plain integers or floats by name.
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    """The run's spans and counters."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict = {}

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def add(self, name: str, start: float, end: float, **attrs) -> Span:
        span = Span(name, start, end, attrs)
        self.spans.append(span)
        return span

    @contextmanager
    def span(self, name: str, **attrs):
        start = self.now()
        rec = {}
        try:
            yield rec
        finally:
            self.add(name, start, self.now(), **attrs, **rec)

    def count(self, name: str, value=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def named(self, name: str, since: float = float("-inf"),
              until: float = float("inf")) -> list:
        """Spans called ``name`` that start in [since, until)."""
        return [s for s in self.spans
                if s.name == name and since <= s.start < until]
