"""What the metric readers share: the window's requests, tokens and steps
from the run's spans, and the least time of the Loom kernels that the
traced stretch ran, from the yardstick in ``work.py``."""
from __future__ import annotations

from perfbench import work


def requests(run) -> list:
    """The LM driver's requests (``drivers/engine.py``'s ``Req``)."""
    return run.rec.counters.get("requests", [])


def token_times(run) -> list:
    """Arrival times of the tokens delivered in the window."""
    return [t for r in requests(run) for t in r.times
            if run.t_start <= t <= run.t_end]


def closed_window(run, name: str) -> tuple:
    """(the ``name`` spans that began in the window, where the window
    closes): the end of the last of them, so that the step or request
    running when the window's seconds are up is counted whole, its work
    and its time. (spans, None) where none began."""
    spans = run.rec.named(name, run.t_start, run.t_end)
    return spans, (max(s.end for s in spans) if spans else None)


def steps(run, since: float, until: float) -> list:
    """``engine.step`` spans that start at or after ``since`` and end at or
    before ``until``."""
    return [s for s in run.rec.named("engine.step", since)
            if s.end <= until]


def classify_spans(run, since: float, until: float) -> list:
    return [s for s in run.rec.named("session.classify", since)
            if s.end <= until and s.attrs["images"]]


def traced_steps(run) -> list:
    return steps(run, run.t_start, run.traced_until)


def k1_least_s(run, spans: list) -> tuple:
    """(least seconds, calls) of the K1 calls the LM steps ``spans`` made:
    per admitted prompt of S tokens every linear at M = S but the head at
    M = 1; per batched decode every linear at M = the pool's width."""
    cfg = run.config["sizes"]
    lin = work.lm_linears(cfg)
    rows = run.cell["engine"]["max_batch"]
    bits = run.cell["policy"]["w_bits"]
    total, calls = 0.0, 0
    for s in spans:
        passes = [(S, 1) for S in s.attrs["prefill_lens"]]
        if s.attrs["decode_ctx"]:
            passes.append((rows, rows))
        for m, m_head in passes:
            for name, k, n in lin:
                mm = m_head if name == "head" else m
                total += work.least_s(*work.k1_work(mm, k, n, bits))
                calls += 1
    return total, calls


def conv_least_s(run, n_requests: int) -> tuple:
    """(least seconds, calls) of the convs of ``n_requests`` requests: K2
    on the static route, K5 on the trimming route."""
    cfg = run.config["sizes"]
    images = run.cell["traffic"]["images"]
    dynamic = run.cell["policy"]["dynamic_a"]
    total = 0.0
    for b, h, w, c, n, k, stride in work.conv_shapes(cfg, images):
        if dynamic:
            wins = work.conv_out_side(h, stride) * work.conv_out_side(
                w, stride)
            groups = -(-wins // min(run.cell["policy"]["group_size"],
                                    -(-wins // 8) * 8))
            nbytes, ops = work.k5_work(b, h, w, c, n, k, stride, groups)
        else:
            nbytes, ops = work.k2_work(b, h, w, c, n, k, stride,
                                       run.cell["policy"]["w_bits"])
        total += work.least_s(nbytes, ops)
    return total * n_requests, len(cfg["convs"]) * n_requests


def share(part: float, whole: float) -> float | None:
    """``part`` over ``whole`` in percent; None where there is no whole."""
    return None if not whole else 100.0 * part / whole
