"""LM serving on the port: a closed loop of ``clients`` clients through
``BatchingEngine``; each client submits its next request once its last
one is done. The engine is stepped on this thread; what each step
delivered is read on the host at the step's end.

Set-up: the dense weights drawn on the device from the seed,
``repro_torch.compile`` in the cell's mode and policy, the engine, the
pool filled with one request per client and ``warmup_steps`` steps of
the loop. Spans: ``engine.submit`` per request; ``engine.step`` per step
(``admitted``: the requests it admitted, each with a batch-1 prefill;
``prefill_lens`` their prompt lengths; ``decode_ctx`` the context length
of each token its batched decode delivered); each request's token
arrival times. After the window no request is submitted; the engine runs
on until every request submitted in the window has its first token.

The output check (``token_gap``): the program's state is freed, the
weights drawn again, and a sample of the requests finished in the window
(drawn from the seed, the longest among them, about ``sample_tokens``
served tokens) run through the plain reference over the prompt and the
served tokens; at each served token, the reference's largest logit less
the served token's logit, the widest over the sample. The reference
follows the port where the configuration file's ``served`` says the
port departs from the published model (:func:`served_sizes`).

In a traced run the program's capacity dispatch is watched over the
whole window: the expert choices of prompt tokens that it kept and
dropped (counters ``prefill_choices``, ``prefill_choices_dropped``).
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.reference import moe_lm, quant


def served_sizes(cfg: dict) -> dict:
    """The published sizes with the port's departures that change the
    result (``served``: its gate renormalisation and capacity dispatch),
    as the reference and the port's config take them."""
    return dict(cfg["sizes"], **cfg.get("served", {}))


def port_config(cfg: dict, max_seq: int):
    """The port's LM config cut to the file's depth, held to the file's
    sizes."""
    from repro_torch import configs
    full = configs.get(cfg["port_arch"])
    s = served_sizes(cfg)
    n = s["num_hidden_layers"]
    port = dataclasses.replace(full, n_layers=n, pattern=full.pattern[:n],
                               max_seq=max_seq)
    moe = port.moe
    n_dense = next(i for i, p in enumerate(port.pattern) if p.ffn == "moe")
    got = {"hidden_size": port.d_model, "vocab_size": port.vocab,
           "num_attention_heads": port.n_heads,
           "num_key_value_heads": port.n_kv_heads, "head_dim": port.d_head,
           "intermediate_size": port.d_ff, "rope_theta": port.rope_theta,
           "hidden_act": port.activation,
           "moe_intermediate_size": moe.d_ff,
           "n_routed_experts": moe.n_experts,
           "num_experts_per_tok": moe.top_k,
           "n_shared_experts": moe.n_shared,
           "capacity_factor": moe.capacity_factor,
           "first_k_dense_replace": n_dense,
           "num_hidden_layers": port.n_layers}
    want = {k: s[k] for k in got}
    if got != want or moe.shared_d_ff != s["n_shared_experts"] * s[
            "moe_intermediate_size"]:
        raise ValueError(f"{cfg['name']}: the port's config {got} is not "
                         f"the file's {want}")
    if any(p.kind != "attn" or p.window for p in port.pattern) \
            or port.qk_norm:
        raise ValueError(f"{cfg['name']}: not full attention throughout")
    return port


@dataclasses.dataclass
class Req:
    i: int
    prompt: np.ndarray
    gen_len: int
    handle: object
    submit_t: float
    admit_t: float | None = None
    times: list = dataclasses.field(default_factory=list)
    tokens: np.ndarray | None = None     # what was served, once done
    done_t: float | None = None
    ok: bool = False
    error: str = ""


class Loop:
    """The clients, the engine and the record of what each step did."""

    def __init__(self, run: harness.Run, engine, requests, fault=None):
        self.run, self.engine, self.requests = run, engine, requests
        self.fault = fault
        self.live: list[Req] = []
        self.all: list[Req] = []
        self.next_i = 0
        self.submitting = True

    def submit(self) -> None:
        rec = self.run.rec
        prompt, gen_len = self.requests[self.next_i]
        t0 = rec.now()
        handle = self.engine.submit(prompt, gen_len)
        r = Req(self.next_i, prompt, gen_len, handle, t0)
        rec.add("engine.submit", t0, rec.now(), req=self.next_i)
        self.next_i += 1
        self.live.append(r)
        self.all.append(r)

    def step(self) -> None:
        from repro_torch.runtime.batching import streams
        rec = self.run.rec
        queued = [r for r in self.live if r.handle.state == streams.QUEUED]
        t0 = rec.now()
        self.engine.step()
        t1 = rec.now()
        admitted = [r for r in queued if r.handle.state != streams.QUEUED]
        prefill, ctx = [], []
        for r in admitted:
            r.admit_t = t0
        for r in self.live:
            n = r.handle.n_tokens
            for j in range(len(r.times), n):
                r.times.append(t1)
                if j == 0:
                    prefill.append(len(r.prompt))
                else:
                    ctx.append(len(r.prompt) + j)
        rec.add("engine.step", t0, t1, admitted=len(admitted),
                prefill_lens=prefill, decode_ctx=ctx)
        for r in [r for r in self.live if r.handle.done]:
            self.live.remove(r)
            r.done_t = t1
            r.ok = (r.handle.state == streams.DONE
                    and r.handle.n_tokens == r.gen_len)
            r.tokens = r.handle.tokens_so_far()
            if r.ok and self.fault is not None:
                r.tokens = self.fault(r)
            if not r.ok:
                err = r.handle._error
                r.error = repr(err) if err else f"state {r.handle.state}"
            if self.submitting:
                self.submit()


def drive(run: harness.Run, session=None, t_process: float = 0.0,
          profiler=None, fault=None) -> None:
    """Set-up, the window and the output check. ``session``: a compiled
    session to use instead of compiling one (tests). ``fault``: called
    as ``fault(req)`` on each request that finished, its return taken as
    the tokens served (the control)."""
    from repro_torch.runtime.batching import BatchingEngine
    from repro_torch.kernels import bitserial_matmul as bm
    cfg, rec, cell = run.config["sizes"], run.rec, run.cell
    eng = cell["engine"]
    traffic = harness.piece("traffic", cell["traffic"]["generator"])
    if session is None:
        session = compile_session(run, port_config(run.config,
                                                   eng["max_seq"]))
    engine = BatchingEngine(session, max_batch=eng["max_batch"],
                            max_seq=eng["max_seq"])
    loop = Loop(run, engine, traffic.make(cell["traffic"], cfg, run.seed),
                fault)
    for _ in range(cell["clients"]):
        loop.submit()
    while engine.scheduler.depth:
        loop.step()
    for _ in range(cell["warmup_steps"]):
        loop.step()
    harness.sync(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    if run.trace:
        launches = bm.bitserial_matmul.launches
        drops = _Drops()
        profiler.start()
    run.t_start = rec.now()
    run.setup_s = run.t_start - t_process
    run.t_end = run.t_start + run.seconds
    first_window = len(loop.all)
    n_steps = 0
    while rec.now() < run.t_end:
        loop.step()
        n_steps += 1
        if run.trace and n_steps == cell["profile_steps"]:
            run.traced = profiler.stop()
            run.traced_until = rec.now()
            rec.counters["k1_launches"] = \
                bm.bitserial_matmul.launches - launches
    if run.trace and run.traced is None:
        run.traced = profiler.stop()
        run.traced_until = rec.now()
        rec.counters["k1_launches"] = bm.bitserial_matmul.launches - launches
    if run.trace:
        rec.counters.update(drops.finish())
    loop.submitting = False
    window = [r for r in loop.all[first_window:]
              if r.submit_t < run.t_end]
    t_wait = rec.now() + cell["first_token_wait_s"]
    while any(not r.times and r.done_t is None for r in window) \
            and rec.now() < t_wait:
        loop.step()
    run.attempted = len(window)
    bad = [r for r in window
           if (r.done_t is not None and not r.ok) or not r.times]
    run.failed = len(bad)
    for r in bad[:3]:
        print(f"[failed] request {r.i}: {r.error or 'no first token'}",
              file=sys.stderr)
    rec.counters["requests"] = loop.all
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    loop.engine = None
    del engine, session
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = rec.now()
    check(run, loop.all)
    rec.counters["check_s"] = rec.now() - t_check


def compile_session(run: harness.Run, port_cfg):
    import repro_torch
    from repro_torch.core.policy import uniform_policy
    pol = run.cell["policy"]
    params = weights.lm_params(run.config["sizes"], run.seed, run.device)
    return repro_torch.compile(
        port_cfg, uniform_policy(pol["a_bits"], pol["w_bits"],
                                 dynamic_a=pol["dynamic_a"]),
        mode=run.cell["mode"], params=params, device=run.device)


def sample(run: harness.Run, reqs: list) -> list:
    """Finished requests of the window (of the whole run where the window
    finished none), the longest first, then others drawn from the seed
    until ``sample_tokens`` served tokens."""
    done = [r for r in reqs if r.ok and run.t_start <= r.done_t <= run.t_end]
    done = done or [r for r in reqs if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.gen_len, r.i))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(weights.subseed(run.seed, "sample")) \
        .permutation(len(rest))
    out, n = [longest], longest.gen_len
    for j in order:
        if n >= run.cell["sample_tokens"]:
            break
        out.append(rest[j])
        n += rest[j].gen_len
    return out


def served_logits(params: dict, cfg: dict, r: Req, a_bits: int,
                  w_bits: int) -> tuple:
    """(reference logits float32 [G, V] at each served token's position,
    served tokens [G]) of a finished request."""
    served = torch.as_tensor(r.tokens.astype(np.int64))
    seq = torch.cat([torch.as_tensor(r.prompt.astype(np.int64)),
                     served[:-1]])
    dev = params["head"]["w"].device
    logits = moe_lm.forward(params, cfg, seq.to(dev), len(r.prompt),
                            len(r.prompt) - 1, a_bits, w_bits)
    return logits, served.to(dev)


def gap(logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which ``tokens``' logits lie below each row's
    largest."""
    picked = logits.gather(1, tokens[:, None])[:, 0]
    return float((logits.max(-1).values - picked).max())


def check(run: harness.Run, reqs: list) -> None:
    pol = run.cell["policy"]
    pick = sample(run, reqs)
    quant.full_float32()
    params = weights.lm_params(run.config["sizes"], run.seed, run.device)
    cfg = served_sizes(run.config)
    worst = float("inf") if not pick else 0.0
    with torch.inference_mode():
        for r in pick:
            logits, served = served_logits(params, cfg, r, pol["a_bits"],
                                           pol["w_bits"])
            worst = max(worst, gap(logits, served))
    run.rec.counters["checked_tokens"] = sum(r.gen_len for r in pick)
    run.check("token_gap", worst)


def control_fault(run: harness.Run, bits: int):
    """The control: in the program's place, at each position of a
    finished request's prompt and served tokens, the token that the plain
    reference at ``bits`` puts first (weights drawn again from the
    seed)."""
    params = weights.lm_params(run.config["sizes"], run.seed, run.device)
    cfg = served_sizes(run.config)

    def fault(r: Req) -> np.ndarray:
        quant.full_float32()
        with torch.inference_mode():
            low, _ = served_logits(params, cfg, r, bits, bits)
        return low.argmax(-1).cpu().numpy().astype(r.tokens.dtype)
    return fault


class _Drops:
    """The program's capacity dispatch (``models/moe.py``'s ``dispatch``)
    watched: the expert choices of each prefill (a row of more than one
    token) and those past their expert's capacity, kept on the device
    while the window runs and summed after it."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.dispatch
        self.kept: list = []
        self.choices = 0

        def watched(ids, cfg, cap):
            slot, keep = self.orig(ids, cfg, cap)
            if ids.shape[1] > 1:
                self.choices += keep.numel()
                self.kept.append(keep.sum())
            return slot, keep
        moe.dispatch = watched

    def finish(self) -> dict:
        self.moe.dispatch = self.orig
        kept = sum(int(k) for k in self.kept)
        return {"prefill_choices": self.choices,
                "prefill_choices_dropped": self.choices - kept}
