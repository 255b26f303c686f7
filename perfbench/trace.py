"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a
bounded stretch of the window, reduced to device intervals by name.

Device events are every activity the profiler records on the card
(kernels, copies, sets). ``busy_s`` is the length of their union;
``window_s`` the host clock's length of the traced stretch, which ends
with the device synchronised, so every operation launched in it is in
the trace.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


class DeviceTrace:
    """Device intervals ``(name, start_ns, end_ns)`` and host operations
    ``(name, start_ns, end_ns)`` of one traced stretch."""

    def __init__(self, device_ops: list, host_ops: list, window_s: float):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.window_s = window_s

    def intervals(self) -> list:
        """The union of the device intervals, merged, in order."""
        merged = []
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) * 1e-9

    def kernel_s(self, substring: str) -> tuple:
        """(seconds, launches) of the device operations whose name holds
        ``substring``."""
        hits = [b - a for name, a, b in self.device_ops if substring in name]
        return sum(hits) * 1e-9, len(hits)

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device operations that took the most time, by name."""
        by = defaultdict(int)
        for name, a, b in self.device_ops:
            by[name] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device operations, each named by
        the longest host operation running at its middle."""
        iv = self.intervals()
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            host = [(e - s, name) for name, s, e in self.host_ops
                    if s <= mid <= e]
            label = max(host)[1] if host else "host: no operation"
            out.append([label[:120], (b - a) * 1e-9])
        return out


class Profiler:
    """Starts and stops ``torch.profiler`` around the traced stretch."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        dev, host = [], []
        for e in self._prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append(span)
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                host.append(span)
        self._prof = None
        return DeviceTrace(dev, host, window_s)
