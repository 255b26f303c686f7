"""``program_trace.py`` on the CPU: a kineto-like event list with the
program's annotations reads as the same device trace as without them,
its idle gaps labelled by the program's spans and its device time
credited to them; the program's counters equal the harness's own counts
on the smoke cells; the host-clock readings from the program's spans."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import program_trace as pt
from perfbench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    """One event as kineto's result list hands it out."""

    def __init__(self, name, start, end, device, kind, corr=0, link=0):
        self._v = (name, start, end - start, device, kind, corr, link)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4] in ("user_annotation", "gpu_user_annotation")

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _events(annotated: bool) -> list:
    """A decode step: the unpack kernel launched inside ``moe.unpack``, K1
    inside ``session.decode``, a copy launched by an ATen op inside it, a
    kernel after ``session.decode`` inside ``engine.step``, and one outside
    every span. With ``annotated``, the program's spans on the host and the
    profiler's ranges of them on the card."""
    ev = [Ev("cudaLaunchKernel", 250, 300, CPU, "cuda_runtime", corr=1),
          Ev("cudaLaunchKernel", 3500, 3600, CPU, "cuda_runtime", corr=2),
          Ev("aten::copy_", 5000, 5400, CPU, "cpu_op", corr=77),
          Ev("cudaLaunchKernel", 9000, 9050, CPU, "cuda_runtime", corr=4),
          Ev("aten::item", 9900, 11500, CPU, "cpu_op", corr=78),
          Ev("cudaLaunchKernel", 11000, 11050, CPU, "cuda_runtime", corr=5),
          Ev("unpack_elementwise", 1000, 4000, CUDA, "kernel", corr=1),
          Ev("void mm::k1_kernel<C>", 4500, 6000, CUDA, "kernel", corr=2),
          Ev("Memcpy DtoD", 6500, 7000, CUDA, "gpu_memcpy", corr=3,
             link=77),
          Ev("argmax_kernel", 9500, 9800, CUDA, "kernel", corr=4),
          Ev("reduce_kernel", 12000, 12500, CUDA, "kernel", corr=5)]
    if annotated:
        ev += [Ev("engine.step", 0, 10000, CPU, "user_annotation", corr=70),
               Ev("session.decode", 100, 8000, CPU, "user_annotation",
                  corr=71),
               Ev("moe.unpack", 200, 3000, CPU, "user_annotation", corr=72),
               Ev("engine.step", 1000, 9800, CUDA, "gpu_user_annotation"),
               Ev("session.decode", 1000, 7000, CUDA,
                  "gpu_user_annotation"),
               Ev("moe.unpack", 1000, 4000, CUDA, "gpu_user_annotation")]
    return ev


def _legacy(events) -> trace.DeviceTrace:
    """What ``trace.Profiler.stop`` makes of the same events."""
    dev, host = [], []
    for e in events:
        span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        (dev if e.device_type() == CUDA else host).append(span)
    return trace.DeviceTrace(dev, host, 13e-6)


def test_annotations_leave_the_device_trace_as_it_was():
    got = pt.ProgramTrace.from_events(_events(True), 13e-6)
    plain = _legacy(_events(False))
    assert got.busy_s == pytest.approx(plain.busy_s) == pytest.approx(
        5800e-9)
    assert got.top_ops() == plain.top_ops()
    assert got.kernel_s("k1_kernel") == plain.kernel_s("k1_kernel")
    assert got.window_s - got.busy_s == plain.window_s - plain.busy_s
    # read as device work, the ranges would close the step's gaps
    assert _legacy(_events(True)).busy_s > plain.busy_s
    assert [g[1] for g in got.idle_gaps()] == \
        [g[1] for g in plain.idle_gaps()]


def test_gaps_are_labelled_by_the_program_span_at_their_middle():
    got = dict((round(s * 1e9), label) for label, s in
               pt.ProgramTrace.from_events(_events(True), 13e-6).idle_gaps())
    plain = dict((round(s * 1e9), label) for label, s in
                 _legacy(_events(False)).idle_gaps())
    assert got[2500] == "engine.step > host: no operation"
    assert got[500] == "session.decode > host: no operation"
    assert got[2200] == plain[2200] == "aten::item"      # outside every span


def test_device_time_credited_to_the_innermost_span_at_launch():
    t = pt.ProgramTrace.from_events(_events(True), 13e-6)
    by = {k: round(v * 1e9) for k, v in t.device_s_by_span().items()}
    assert by == {"moe.unpack": 3000, "session.decode": 2000,
                  "engine.step": 300, None: 500}
    assert t.launches[2] == 5000          # the copy: its ATen op's start
    assert pt.share_of(t, ("moe.unpack",)) == pytest.approx(
        100 * 3000 / 5800)
    assert pt.share_of(t, pt.SHARES["float_pass_share.cnn"]) == 0.0
    assert pt.share_of(_legacy(_events(False)), ("moe.unpack",)) is None


def test_cuda_calls_name_the_span_and_op_that_waited():
    ev = _events(True) + [
        Ev("cudaMemcpyAsync", 10100, 11500, CPU, "cuda_runtime", corr=9),
        Ev("cudaStreamSynchronize", 5100, 5300, CPU, "cuda_runtime",
           corr=8)]
    got = pt.ProgramTrace.from_events(ev, 13e-6).cuda_calls(3)
    assert [[k, round(s * 1e9), c] for k, s, c in got] == [
        ["None > aten::item > cudaMemcpyAsync", 1400, 1],
        ["session.decode > aten::copy_ > cudaStreamSynchronize", 200, 1],
        ["session.decode > - > cudaLaunchKernel", 100, 1]]


def _span(name, a, b, parent=None):
    from repro_torch.runtime.tracing import Span
    return Span(name, a, b, parent, {})


def test_host_time_by_span_less_the_spans_inside():
    taken = pt.Taken()
    step = _span("engine.step", 1.0, 2.0)
    dec = _span("session.decode", 1.1, 1.8, step)
    taken.spans = [_span("moe.unpack", 1.2, 1.5, dec), dec, step,
                   _span("engine.to_host", 1.8, 1.9, step),
                   _span("engine.step", 0.0, 0.5)]          # before
    taken.spans.append(_span("ops.quantize", 2.5, 2.6, taken.spans[-1]))
    got = pt.host_s_by_span(taken, 1.0, 3.0)
    assert got == pytest.approx({"engine.step": 0.2, "session.decode": 0.4,
                                 "moe.unpack": 0.3, "engine.to_host": 0.1,
                                 "ops.quantize": 0.1})


def test_host_readings_from_the_program_spans(smoke):
    run, _ = smoke["lm_run"]()
    run.t_start, run.t_end = 10.0, 20.0
    taken = pt.Taken()
    taken.spans = [_span("compile.fingerprint", 1.0, 1.5),
                   _span("engine.step", 9.0, 9.5),             # before
                   _span("engine.step", 11.0, 11.3),
                   _span("engine.to_host", 11.2, 11.25),
                   _span("engine.prefill", 12.0, 12.2),
                   _span("engine.to_host", 12.15, 12.2),
                   _span("engine.step", 12.0, 12.4),
                   _span("engine.step", 13.0, 13.1)]
    got = pt.readings(run, taken)
    assert got["fingerprint_s"] == pytest.approx(0.5)
    assert got["prefill_ms_p50.lm"] == pytest.approx(200)
    assert got["step_host_ms_p50.lm"] == pytest.approx(250)   # 250, 350, 100
    assert set(got) == {"fingerprint_s", "prefill_ms_p50.lm",
                        "step_host_ms_p50.lm"}


@pytest.mark.parametrize("spans", [False, True])
@pytest.mark.parametrize("cell", ["dsmoe-chat-c32", "vgg19-dyn-b256"])
def test_program_counters_equal_the_harness_counts(cell, spans, smoke):
    """The program's counters over the stretch the harness watches its own
    equal them exactly; the run's outputs hold either way."""
    if cell.startswith("dsmoe"):
        run, sess = smoke["lm_run"](cell, trace=True)
    else:
        run, sess = smoke["cnn_run"](cell, trace=True)
    taken = pt.drive(run, session=sess, t_process=time.perf_counter(),
                     spans=spans)
    assert run.correct and isinstance(run.traced, pt.ProgramTrace)
    c = run.rec.counters
    if not spans:
        assert taken.spans == [] and taken.watched == {}
        return
    if cell.startswith("dsmoe"):
        assert c["prefill_choices"] > 0
        assert taken.watched == {
            "moe.prefill_choices": c["prefill_choices"],
            "moe.prefill_dropped": c["prefill_choices_dropped"]}
        got = pt.readings(run, taken)
        assert got["step_host_ms_p50.lm"] > 0 and got["prefill_ms_p50.lm"] > 0
        assert {s.name for s in taken.spans} >= {
            "engine.step", "engine.prefill", "session.decode", "moe.unpack"}
    else:
        assert c["a_planes"] > 0
        assert taken.watched == {"trim.a_planes": c["a_planes"],
                                 "trim.a_static_planes": c[
                                     "a_static_planes"]}
        names = {s.name for s in taken.spans}
        assert names >= {"session.classify", "trim.counts",
                         "trim.dense_weights", "cnn.relu_pool"}
