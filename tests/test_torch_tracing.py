"""PyTorch port, the tracer (``repro_torch.runtime.tracing``): off by default
and then free of effects; on, the span tree of a smoke engine run and of
smoke classify requests, the counters, and served tokens and logits equal
to a run with it off. The engine's ``ServeStats.tokens_per_s`` against a
hand count."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import threading
import types

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.core.policy import uniform_policy
from repro_torch.models.cnn import CNNConfig
from repro_torch.runtime import tracing
from repro_torch.runtime.batching import BatchingEngine
from repro_torch.runtime.batching import engine as enginelib

POLICIES = {"static": uniform_policy(8, 8),
            "dynamic_a": uniform_policy(8, 8, dynamic_a=True)}


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts and ends with the tracer off and its record empty."""
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


@functools.lru_cache(maxsize=None)
def _lm_session(policy: str = "static"):
    cfg = configs.get("deepseek-moe-16b", smoke=True)
    return repro_torch.compile(cfg, POLICIES[policy], mode="serve_packed",
                               device="cpu")


@functools.lru_cache(maxsize=None)
def _cnn_session(policy: str = "static"):
    return repro_torch.compile(CNNConfig(), POLICIES[policy],
                               mode="serve_packed", device="cpu")


def _prompts(n: int = 3, seed: int = 5) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=(6 + 3 * j,)).astype(np.int32)
            for j in range(n)]


def _images(seed: int = 3) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, 32, 32, 3), generator=g)


def _serve(sess, **engine_kw) -> list:
    """Three requests through an engine of two slots: each stream's
    tokens."""
    eng = BatchingEngine(sess, max_batch=2, max_seq=64, **engine_kw)
    handles = [eng.submit(p, 4) for p in _prompts()]
    eng.run(max_steps=50)
    return [h.tokens_so_far() for h in handles]


def _parents(rec) -> dict:
    """name -> the set of its spans' parents' names (None for a root)."""
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, set()).add(
            s.parent.name if s.parent is not None else None)
    return out


# -- off: no effect ------------------------------------------------------------

def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    """With the tracer off, under a running profiler: no span object is
    made, ``record_function`` is never entered, nothing is recorded."""
    def refuse(*a, **k):
        raise AssertionError("entered while tracing is off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(tracing, "_Live", refuse)
    monkeypatch.setattr(tracing, "Span", refuse)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(_lm_session("dynamic_a"))
        _cnn_session("dynamic_a").classify(_images())
    rec = tracing.collect()
    assert rec.spans == [] and rec.counters == {}
    assert tracing.span("moe.unpack") is tracing.span("engine.step")


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("kind", ["span", "count"])
def test_unregistered_name_raises(kind, on):
    if on:
        tracing.enable()
    with pytest.raises(tracing.UnknownTraceName):
        if kind == "span":
            tracing.span("moe.unpak")
        else:
            tracing.count("trim.planes", 1)
    assert tracing.collect().spans == []


# -- on: the span tree ---------------------------------------------------------

def test_engine_run_gives_the_span_tree():
    sess = _lm_session()
    tracing.enable()
    _serve(sess)
    rec = tracing.collect()
    assert {s.name for s in rec.spans} <= tracing.SPANS
    parents = _parents(rec)
    assert parents["engine.step"] == {None}
    assert parents["engine.prefill"] == {"engine.step"}
    assert parents["session.prefill"] == {"engine.prefill"}
    assert parents["session.decode"] == {"engine.step"}
    assert parents["engine.to_host"] == {"engine.prefill", "engine.step"}
    assert parents["moe.unpack"] == {"session.prefill", "session.decode"}
    assert parents["ops.quantize"] == {"session.prefill", "session.decode"}
    assert parents["ops.dequantize"] == parents["ops.quantize"]
    prefills = sorted(rec.named("engine.prefill"),
                      key=lambda s: s.attrs["req"])
    assert [s.attrs["prompt_len"] for s in prefills] == \
        [len(p) for p in _prompts()]
    assert len({s.attrs["req"] for s in prefills}) == 3
    for s in rec.spans:
        assert s.start <= s.end
        if s.parent is not None:
            assert s.parent.start <= s.start and s.end <= s.parent.end
    n_steps = len(rec.named("engine.step"))
    assert len(rec.named("session.decode")) == n_steps
    assert len(rec.named("engine.to_host")) == n_steps + 3


@pytest.mark.parametrize("policy", ["static", "dynamic_a"])
def test_classify_gives_the_span_tree(policy):
    sess = _cnn_session(policy)
    cfg = sess.cfg
    tracing.enable()
    sess.classify(_images())
    sess.classify(_images(4))
    rec = tracing.collect()
    parents = _parents(rec)
    assert parents["session.classify"] == {None}
    assert len(rec.named("session.classify")) == 2
    assert len(rec.named("cnn.relu_pool")) == 2 * len(cfg.convs)
    trims = {"trim.counts", "trim.dense_weights", "trim.pack_activations"}
    for name in ("cnn.relu_pool", "ops.quantize", "ops.dequantize"):
        assert parents[name] == {"session.classify"}
    n_layers = len(cfg.convs) + len(cfg.fcs)
    assert len(rec.named("ops.dequantize")) == 2 * n_layers
    if policy == "static":
        assert not trims & set(parents)
        assert len(rec.named("ops.quantize")) == 2 * n_layers
        assert rec.counters == {}
    else:
        for name in trims:
            assert parents[name] == {"session.classify"}
        assert len(rec.named("trim.counts")) == 2 * n_layers
        assert len(rec.named("trim.dense_weights")) == 2 * n_layers
        assert len(rec.named("trim.pack_activations")) == 2 * len(cfg.fcs)
        # a dynamic conv casts to int8 after its counts: two spans
        assert len(rec.named("ops.quantize")) == 2 * (2 * len(cfg.convs)
                                                      + len(cfg.fcs))
        c = rec.counters
        assert 0 < c["trim.a_planes"] <= c["trim.a_static_planes"]


def test_compile_fingerprint_span():
    tracing.enable()
    repro_torch.compile(CNNConfig(), POLICIES["static"], mode="serve_packed",
                        device="cpu")
    repro_torch.compile(CNNConfig(), POLICIES["static"], mode="dense",
                        device="cpu")
    rec = tracing.collect()
    fp = rec.named("compile.fingerprint")
    assert len(fp) == 1 and fp[0].parent is None and fp[0].seconds > 0


def test_watchdog_thread_records_its_spans():
    """Under the watchdog the decode and its transfer run on a worker
    thread, where they have no parent; the step's other spans keep
    theirs."""
    sess = _lm_session()
    tracing.enable()
    got = _serve(sess, step_timeout_s=60.0)
    rec = tracing.collect()
    tracing.disable()
    assert all(np.array_equal(a, b) for a, b in zip(got, _serve(sess)))
    parents = _parents(rec)
    assert parents["session.decode"] == {None}
    assert parents["engine.to_host"] == {None, "engine.prefill"}
    assert parents["engine.prefill"] == {"engine.step"}
    assert parents["moe.unpack"] == {"session.prefill", "session.decode"}
    n_steps = len(rec.named("engine.step"))
    assert len(rec.named("session.decode")) == n_steps


# -- on: the same results ------------------------------------------------------

@pytest.mark.parametrize("what", ["lm-static", "lm-dynamic_a", "cnn-static",
                                  "cnn-dynamic_a"])
def test_results_equal_with_tracing_on_and_off(what):
    model, policy = what.split("-")
    if model == "lm":
        sess = _lm_session(policy)
        off = _serve(sess)
        tracing.enable()
        on = _serve(sess)
        assert all(np.array_equal(a, b) for a, b in zip(off, on))
        logits_off, _ = sess.prefill(_prompts()[2][None, :])
        tracing.disable()
        logits_on, _ = sess.prefill(_prompts()[2][None, :])
        assert torch.equal(logits_off, logits_on)
    else:
        sess = _cnn_session(policy)
        off = sess.classify(_images())
        tracing.enable()
        assert torch.equal(off, sess.classify(_images()))
    assert tracing.collect().spans


# -- counters ------------------------------------------------------------------

def test_counters_keep_tensors_and_sum_when_read():
    tracing.enable()
    t = torch.tensor([1, 2, 3], dtype=torch.int32)
    tracing.count("trim.a_planes", t)
    tracing.count("trim.a_planes", 4)
    tracing.count("moe.prefill_dropped", torch.tensor([True, False, True]))
    assert tracing._counts["trim.a_planes"][0] is t
    rec = tracing.collect()
    assert rec.counters == {"trim.a_planes": 10, "moe.prefill_dropped": 2}
    assert tracing.collect().counters == {}


def test_moe_counters_count_prefill_rows_only():
    """The prefills' expert choices: every prompt token's top-k in every
    MoE layer; decode steps count none."""
    sess = _lm_session()
    cfg = sess.cfg
    n_moe = sum(p.ffn == "moe" for p in cfg.pattern)
    tracing.enable()
    _serve(sess)
    c = tracing.collect().counters
    assert c["moe.prefill_choices"] == sum(
        len(p) for p in _prompts()) * n_moe * cfg.moe.top_k
    assert 0 <= c["moe.prefill_dropped"] < c["moe.prefill_choices"]


def test_profiler_sees_each_span_as_an_annotation():
    """On, under a recording profiler, each span is a user annotation of
    the same name in the profiler's events; off, none is."""
    from torch.profiler import ProfilerActivity, profile
    sess = _cnn_session()
    names = []
    for on in (False, True):
        if on:
            tracing.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            sess.classify(_images())
        names.append([e.name() for e in prof.profiler.kineto_results.events()
                      if e.is_user_annotation()])
    assert names[0] == []
    rec = tracing.collect()
    assert sorted(names[1]) == sorted(s.name for s in rec.spans)


# -- the engine's tokens/s -----------------------------------------------------

def test_serve_stats_tokens_per_s_counts_the_time_between_steps(monkeypatch):
    """Tokens streamed over the first step's start to the latest step's
    end, gaps between steps included: two requests of 3 tokens in two
    steps, each prefill and decode 1 s of a hand clock, 2 s between the
    steps: 6 tokens over 6 s (the steps' own time alone is 4 s)."""
    clock = types.SimpleNamespace(t=100.0)
    monkeypatch.setattr(enginelib, "time", types.SimpleNamespace(
        monotonic=lambda: clock.t, sleep=lambda s: None))
    sess = _lm_session()

    def timed(fn):
        def call(*a, **k):
            clock.t += 1.0
            return fn(*a, **k)
        return call

    sess = dataclasses.replace(sess)
    sess.prefill = timed(sess.prefill)
    sess.decode = timed(sess.decode)
    eng = BatchingEngine(sess, max_batch=2, max_seq=64)
    handles = [eng.submit(p, 3) for p in _prompts(2)]
    assert eng.step()
    clock.t += 2.0
    assert not eng.step()
    assert all(len(h.tokens_so_far()) == 3 for h in handles)
    assert eng.stats.n_tokens_streamed == 6
    assert eng.stats.tokens_per_s == pytest.approx(6 / 6.0)


def test_tracer_threads_keep_their_own_stacks():
    tracing.enable()
    seen = {}

    def worker():
        with tracing.span("engine.to_host") as s:
            seen["worker"] = s
    with tracing.span("engine.step") as outer:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with tracing.span("engine.prefill", req=7, prompt_len=3) as inner:
            pass
    assert seen["worker"].parent is None
    assert inner.parent is outer and inner.attrs == {"req": 7,
                                                     "prompt_len": 3}
    rec = tracing.collect()
    assert [s.name for s in rec.spans] == ["engine.to_host",
                                           "engine.prefill", "engine.step"]
