"""Batch classification on the port: a closed loop of one client calling
``ServingSession.classify`` on a request of images and sending the next
request once the last one's logits are on the host.

Set-up: the dense weights drawn on the device from the seed,
``repro_torch.compile`` in the cell's mode and policy, the bank of
requests made, and ``warmup`` requests served. Spans: one
``session.classify`` per request, submit to logits on the host. After
the window the program's state is freed and the logits of ``sample``
requests of the window, drawn from the seed, are held against the plain
reference's on the same weights and images (``logit_abs_diff``: the
largest absolute difference of any logit).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from perfbench import harness, weights
from perfbench.reference import cnn as ref_cnn
from perfbench.reference import quant


def port_config(cfg: dict):
    """The port's CNN config, built from the configuration file's name
    and sizes."""
    from repro_torch.models.cnn import CNNConfig, ConvSpec
    s = cfg["sizes"]
    return CNNConfig(
        name=cfg["name"], in_ch=s["in_channels"], img=s["image_size"],
        convs=tuple(ConvSpec(c["name"], c["filters"], c["kernel"],
                             c["stride"], c["pool"]) for c in s["convs"]),
        fcs=tuple(s["fcs"]))


def compile_session(run: harness.Run, params: dict, port_cfg):
    import repro_torch
    from repro_torch.core.policy import uniform_policy
    pol = run.cell["policy"]
    return repro_torch.compile(
        port_cfg, uniform_policy(pol["a_bits"], pol["w_bits"],
                                 dynamic_a=pol["dynamic_a"]),
        mode=run.cell["mode"], params=params, device=run.device)


def drive(run: harness.Run, session=None, t_process: float = 0.0,
          profiler=None, fault=None) -> None:
    """Set-up, the window and the output check. ``session``: a compiled
    session to use instead of compiling one (tests). ``fault``: called as
    ``fault(i, images, logits)`` on each request's host logits, its
    return taken as the timed path's output (the control and the tests'
    planted faults)."""
    cfg, rec = run.config["sizes"], run.rec
    traffic = harness.piece("traffic", run.cell["traffic"]["generator"])
    params = weights.cnn_params(cfg, run.seed, run.device)
    if session is None:
        session = compile_session(run, params, port_config(run.config))
    bank = traffic.make(run.cell["traffic"], cfg, run.seed, run.device)
    for i in range(run.cell["warmup"]):
        session.classify(bank[i % len(bank)]).cpu()
    harness.sync(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    counts = _PlaneCounts(session) if run.trace else None
    if run.trace:
        profiler.start()
    run.t_start = rec.now()
    run.setup_s = run.t_start - t_process
    run.t_end = run.t_start + run.seconds
    n_images = run.cell["traffic"]["images"]
    logits, i = [], 0
    while rec.now() < run.t_end:
        t0 = rec.now()
        try:
            out = session.classify(bank[i % len(bank)]).cpu()
        except Exception as exc:   # noqa: BLE001 -- a failed request
            rec.add("session.classify", t0, rec.now(), req=i, images=0)
            if not run.failed:
                print(f"[failed] request {i}: {exc!r}", file=sys.stderr)
            run.failed += 1
            logits.append(None)
            i += 1
            continue
        if fault is not None:
            out = fault(i, bank[i % len(bank)], out)
        rec.add("session.classify", t0, rec.now(), req=i, images=n_images)
        logits.append(out)
        i += 1
        if run.trace and i == run.cell["profile_requests"]:
            run.traced = profiler.stop()
            run.traced_until = rec.now()
            rec.counters.update(counts.finish())
    if run.trace and run.traced is None:
        run.traced = profiler.stop()
        run.traced_until = rec.now()
        rec.counters.update(counts.finish())
    run.attempted = i
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    del session
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = rec.now()
    check(run, params, bank, logits)
    rec.counters["check_s"] = rec.now() - t_check


def check(run: harness.Run, params: dict, bank: list, logits: list) -> None:
    """``logit_abs_diff`` over a sample of the window's requests."""
    pol = run.cell["policy"]
    done = [i for i, x in enumerate(logits) if x is not None]
    rng = np.random.default_rng(weights.subseed(run.seed, "sample"))
    pick = rng.choice(done, size=min(run.cell["sample"], len(done)),
                      replace=False) if done else []
    quant.full_float32()
    worst = float("inf") if not done else 0.0
    with torch.inference_mode():
        for i in sorted(int(j) for j in pick):
            x = bank[i % len(bank)]
            want = ref_cnn.forward(params, ref_config(run), x,
                                   pol["a_bits"], pol["w_bits"]).cpu()
            worst = max(worst, float((logits[i] - want).abs().max()))
    run.check("logit_abs_diff", worst)


def control_fault(run: harness.Run, bits: int):
    """The control: the plain reference at ``bits`` in the program's
    place, on the run's own weights and images (drawn again from the
    seed)."""
    params = weights.cnn_params(run.config["sizes"], run.seed, run.device)

    def fault(i, images, logits):
        quant.full_float32()
        with torch.inference_mode():
            return ref_cnn.forward(params, ref_config(run), images, bits,
                                   bits).cpu()
    return fault


def ref_config(run: harness.Run) -> dict:
    return dict(run.config["sizes"], trim_group=run.cell["policy"].get(
        "group_size", 256))


class _PlaneCounts:
    """In a traced run, the activation plane counts that the program's
    trimming route hands its kernels (``conv_planes_dynamic``,
    ``matmul_planes_dynamic`` of the plan's backend), kept on the device
    while the traced stretch runs and summed after it."""

    def __init__(self, session):
        self.backend = session.plan.backend
        self.a_bits = min(session.plan.policy.default.a_bits, 8)
        self.seen: list = []
        self.orig = {}
        for name, pos in (("conv_planes_dynamic", 2),
                          ("matmul_planes_dynamic", 2)):
            fn = getattr(self.backend, name)
            self.orig[name] = fn
            setattr(self.backend, name, self._wrap(fn, pos))

    def _wrap(self, fn, pos):
        def wrapped(*args, **kw):
            self.seen.append(args[pos])
            return fn(*args, **kw)
        return wrapped

    def finish(self) -> dict:
        for name in self.orig:
            delattr(self.backend, name)
        if not self.seen:
            return {}
        planes = sum(int(c.clamp(max=self.a_bits).sum()) for c in self.seen)
        groups = sum(c.numel() for c in self.seen)
        return {"a_planes": planes, "a_static_planes": groups * self.a_bits}
