"""A cell run with the program's own tracer on (``repro_torch.runtime.
tracing``), its spans read beside the traced stretch's device trace.

    python3 perfbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--spans 0|1]

Runs the cell as ``run.py`` does, with the tracer enabled before
``compile`` (``--spans 1``, the default) or left off, and prints the
same ``[counter]`` lines and last line, its ``metrics`` holding also,
with ``--trace 1``, the readings below and the breakdown's idle gaps
labelled by the program span open at each gap's middle
(``engine.step > host: no operation``). The benchmark's own runs do not
run it: the drivers do not turn the tracer on.

Each device operation is credited to the innermost program span open at
its launch: its CUDA runtime call's host time (same correlation id), else
the host time of the operation that launched it (its linked correlation
id). The profiler draws each span on the card's timeline too
(``gpu_user_annotation``); those ranges are not device work and are left
out of the device operations, so ``busy_s``, the idle share, ``top_ops``
and ``kernel_s`` read what ``trace.py`` reads without the spans.

The readings (:func:`readings`):

    expert_unpack_share.lm   device time credited to ``moe.unpack``, over
                             the traced stretch's busy time, in percent
    float_pass_share.cnn     to ``ops.quantize``, ``ops.dequantize`` and
                             ``cnn.relu_pool``
    trim_overhead_share.cnn  to ``trim.counts``, ``trim.dense_weights``
                             and ``trim.pack_activations``
    step_host_ms_p50.lm      median over the engine steps after the
                             traced stretch of the step's time less its
                             ``engine.to_host`` spans: the host's own time
    prefill_ms_p50.lm        median ``engine.prefill`` span after the
                             traced stretch
    fingerprint_s            the ``compile.fingerprint`` span

A share reads 0 where the stretch ran device work but none of its spans.
The program's counters over the stretch the harness watches its own
(``_Drops``, ``_PlaneCounts``) are printed as ``program.<name>``.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import readings as rd  # noqa: E402
from perfbench import trace  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402

RUNTIME = ("cuda", "cu")     # CUDA runtime and driver calls, by name
SHARES = {
    "expert_unpack_share.lm": ("moe.unpack",),
    "float_pass_share.cnn": ("ops.quantize", "ops.dequantize",
                             "cnn.relu_pool"),
    "trim_overhead_share.cnn": ("trim.counts", "trim.dense_weights",
                                "trim.pack_activations"),
}


class ProgramTrace(trace.DeviceTrace):
    """A :class:`trace.DeviceTrace` whose device operations leave out the
    profiler's annotation ranges, with each operation's launch time on the
    host and the program's spans as the profiler saw them."""

    def __init__(self, device_ops, host_ops, window_s, launches, spans):
        super().__init__(device_ops, host_ops, window_s)
        self.launches = launches      # host ns of each device op's launch
        self.spans = sorted(spans, key=lambda s: s[1])   # (name, a, b)
        self._starts = [s[1] for s in self.spans]

    @classmethod
    def from_events(cls, events, window_s: float) -> "ProgramTrace":
        """From the profiler's events (kineto's: ``name()``,
        ``start_ns()``, ``duration_ns()``, ``device_type()``,
        ``is_user_annotation()``, ``correlation_id()``,
        ``linked_correlation_id()``). The profiler's drawing of a span on
        the card's timeline is a user annotation of the device."""
        import torch
        names = tracing.SPANS
        cuda, cpu = torch.autograd.DeviceType.CUDA, \
            torch.autograd.DeviceType.CPU
        dev, host, spans, runtime, ops = [], [], [], {}, {}
        links = []
        for e in events:
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            marked = e.is_user_annotation() if hasattr(
                e, "is_user_annotation") else span[0] in names
            if e.device_type() == cuda:
                if marked:
                    continue
                dev.append(span)
                links.append((e.correlation_id(),
                              e.linked_correlation_id()))
            elif e.device_type() == cpu:
                if marked and span[0] in names:
                    spans.append(span)
                    ops.setdefault(e.correlation_id(), span[1])
                    continue
                host.append(span)
                if span[0].startswith(RUNTIME):
                    runtime[e.correlation_id()] = span[1]
                else:
                    ops.setdefault(e.correlation_id(), span[1])
        launches = [runtime.get(c, ops.get(link)) for c, link in links]
        return cls(dev, host, window_s, launches, spans)

    def span_at(self, t_ns) -> str | None:
        """The innermost program span open at host time ``t_ns``: of the
        spans that cover it, the one that began last."""
        if t_ns is None:
            return None
        i = bisect.bisect_right(self._starts, t_ns) - 1
        while i >= 0:
            name, a, b = self.spans[i]
            if b >= t_ns:
                return name
            i -= 1
        return None

    def device_s_by_span(self) -> dict:
        """Device seconds credited to each innermost program span (None:
        launched outside any)."""
        by = defaultdict(int)
        for (_, a, b), t in zip(self.device_ops, self.launches):
            by[self.span_at(t)] += b - a
        return {k: v * 1e-9 for k, v in by.items()}

    def cuda_calls(self, n: int = 8) -> list:
        """Where the host sat in CUDA calls (a transfer's or a sync's wait,
        a launch blocked on a full queue, an allocation): the ``n``
        (program span > ATen op > CUDA call) triples that took the most
        host time, with their seconds and count."""
        aten = sorted((s, e, name) for name, s, e in self.host_ops
                      if name.startswith("aten::"))
        starts = [a for a, _, _ in aten]
        by = defaultdict(lambda: [0, 0])
        for name, a, b in self.host_ops:
            if not name.startswith(RUNTIME):
                continue
            i = bisect.bisect_right(starts, a) - 1
            while i >= 0 and aten[i][1] < a:
                i -= 1
            op = aten[i][2] if i >= 0 else "-"
            key = f"{self.span_at(a)} > {op} > {name}"
            by[key][0] += b - a
            by[key][1] += 1
        top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
        return [[k, ns * 1e-9, c] for k, (ns, c) in top]

    def idle_gaps(self, n: int = 10) -> list:
        """``trace.DeviceTrace.idle_gaps``, each label led by the program
        span open at the gap's middle, where one is."""
        out = []
        for label, seconds, mid in self._gaps(n):
            span = self.span_at(mid)
            out.append([f"{span} > {label}"[:120] if span else label,
                        seconds])
        return out

    def _gaps(self, n: int) -> list:
        iv = self.intervals()
        gaps = [(iv[i][1], iv[i + 1][0]) for i in range(len(iv) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            host = [(e - s, name) for name, s, e in self.host_ops
                    if s <= mid <= e]
            label = max(host)[1] if host else "host: no operation"
            out.append((label[:120], (b - a) * 1e-9, mid))
        return out


class Profiler(trace.Profiler):
    """``trace.Profiler`` whose stretch comes back as a
    :class:`ProgramTrace`; ``on_start`` runs as the stretch begins."""

    def __init__(self, device, on_start=None):
        super().__init__(device)
        self.on_start = on_start

    def start(self) -> None:
        if self.on_start is not None:
            self.on_start()
        super().start()

    def stop(self) -> ProgramTrace:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        out = ProgramTrace.from_events(
            self._prof.profiler.kineto_results.events(), window_s)
        self._prof = None
        return out


class Taken:
    """The tracer's record over a run, taken in parts: every span, and the
    counters of the part between the stretch's start and the moment the
    harness reads its own counts."""

    def __init__(self):
        self.spans: list = []
        self.watched: dict = {}

    def take(self) -> dict:
        rec = tracing.collect()
        self.spans += rec.spans
        return rec.counters

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]


def drive(run, session=None, t_process: float = 0.0,
          spans: bool = True) -> Taken:
    """The cell's driver on ``run``, the program's tracer on over the whole
    run when ``spans``. The counters the program kept from the stretch's
    start to the harness's own reading (``_Drops.finish``,
    ``_PlaneCounts.finish``) land in ``Taken.watched``."""
    from perfbench import harness
    driver = harness.piece("drivers", run.cell["driver"])
    taken = Taken()
    watchers = [c for c in (getattr(driver, "_Drops", None),
                            getattr(driver, "_PlaneCounts", None)) if c]
    originals = {c: c.finish for c in watchers}

    def watched(cls):
        def finish(self):
            taken.watched = taken.take()
            return originals[cls](self)
        return finish

    for c in watchers:
        c.finish = watched(c)
    tracing.collect()
    if spans:
        tracing.enable()
    try:
        profiler = Profiler(run.device, on_start=taken.take) \
            if run.trace else None
        driver.drive(run, session=session, t_process=t_process,
                     profiler=profiler)
    finally:
        tracing.disable()
        for c, f in originals.items():
            c.finish = f
    taken.take()
    return taken


def share_of(traced: ProgramTrace, names) -> float | None:
    """Device time credited to ``names`` over the stretch's busy time, in
    percent; 0 where the stretch ran device work but none of them."""
    if traced is None or not isinstance(traced, ProgramTrace):
        return None
    by = traced.device_s_by_span()
    return rd.share(sum(by.get(n, 0.0) for n in names), traced.busy_s)


def host_ms_less_transfers(taken: Taken, since: float,
                           until: float) -> list:
    """Per ``engine.step`` span in [since, until]: its milliseconds less
    those of the ``engine.to_host`` spans inside it."""
    steps = [s for s in taken.named("engine.step")
             if since <= s.start and s.end <= until]
    moves = sorted((s.start, s.end) for s in taken.named("engine.to_host"))
    out = []
    for st in steps:
        inside = sum(b - a for a, b in moves
                     if st.start <= a and b <= st.end)
        out.append(1e3 * (st.seconds - inside))
    return out


def host_s_by_span(taken: Taken, since: float, until: float) -> dict:
    """Host seconds of each span name in [since, until] less those of the
    spans open inside it: where the host's own time went."""
    spans = [s for s in taken.spans if since <= s.start and s.end <= until]
    inside = {id(s) for s in spans}
    out = defaultdict(float)
    for s in spans:
        out[s.name] += s.seconds
        if id(s.parent) in inside:
            out[s.parent.name] -= s.seconds
    return dict(out)


def readings(run, taken: Taken) -> dict:
    """The six readings of a run (those that have something to read)."""
    lm = "engine" in run.cell
    out = {}
    if run.trace:
        for name, spans in SHARES.items():
            if name.endswith(".lm") == lm and (
                    name != "trim_overhead_share.cnn"
                    or run.cell["policy"]["dynamic_a"]):
                out[name] = share_of(run.traced, spans)
    if lm:
        steady = (run.steady_from, run.t_end)
        host = host_ms_less_transfers(taken, *steady)
        pre = [1e3 * s.seconds for s in taken.named("engine.prefill")
               if steady[0] <= s.start and s.end <= steady[1]]
        out["step_host_ms_p50.lm"] = statistics.median(host) \
            if host else None
        out["prefill_ms_p50.lm"] = statistics.median(pre) if pre else None
    fp = taken.named("compile.fingerprint")
    out["fingerprint_s"] = fp[0].seconds if fp else None
    return {k: v for k, v in out.items() if v is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, run as run_mod
    cell = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"[card] {run_mod.card_info()}", flush=True)
    run = harness.Run(args.workload, cell, harness.config(cell["config"]),
                      args.seed, args.seconds, bool(args.trace), device)
    taken = drive(run, t_process=T_PROCESS, spans=bool(args.spans))
    print(f"[time] setup_s {run.setup_s:.3f} window_s {run.seconds} "
          f"process_s {time.perf_counter() - T_PROCESS:.3f} spans "
          f"{len(taken.spans)}", flush=True)
    metrics = run_mod.read_metrics(run, harness.benchmark())
    if args.spans:
        for name, value in readings(run, taken).items():
            metrics[name] = {"value": value, "unit": "s" if name ==
                             "fingerprint_s" else "ms" if "_ms_" in name
                             else "%"}
    for k, v in taken.watched.items():
        run.rec.counters[f"program.{k}"] = v
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    breakdown = None
    if run.trace:
        t = run.traced
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        breakdown = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps(),
                     "device_s_by_span": sorted(
                         ([str(k), v] for k, v in
                          t.device_s_by_span().items()),
                         key=lambda kv: -kv[1]),
                     "cuda_calls": t.cuda_calls(),
                     "host_s_by_span": sorted(
                         ([k, v] for k, v in host_s_by_span(
                             taken, run.steady_from, run.t_end).items()),
                         key=lambda kv: -kv[1]),
                     "launches_found": sum(x is not None
                                           for x in t.launches),
                     "device_op_count": len(t.device_ops)}
    for k, v in sorted(run.rec.counters.items()):
        if isinstance(v, (int, float)):
            print(f"[counter] {k} {v}")
    print(json.dumps(run_mod.result(run, metrics, dev, breakdown)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
