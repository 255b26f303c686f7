"""Run one cell of the port's benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads, warms up, measures for ``--seconds`` seconds, checks the outputs
against the plain reference and prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each number compared, beside its limit; also the last lines
of standard error). Exits non-zero, printing no result, without a CUDA
card, without as many cards as the cell asks for, or where JAX or the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's or the JAX package's, compared whole (``repro_torch``, the port,
    is allowed)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def result(run, metrics: dict, device: dict, breakdown=None) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = run.checks
    return out


def execute(args, device, t_process: float):
    """Drive one run of the cell on ``device``; returns the Run."""
    from perfbench import harness, trace
    cell = harness.cell(args.workload)
    run = harness.Run(args.workload, cell, harness.config(cell["config"]),
                      args.seed, float(args.seconds), bool(args.trace),
                      device)
    driver = harness.piece("drivers", cell["driver"])
    driver.drive(run, t_process=t_process,
                 profiler=trace.Profiler(device) if run.trace else None)
    return run


def read_metrics(run, bench: dict) -> dict:
    from perfbench import harness
    out = {}
    for m in harness.metrics_of(bench, run.cell_name, run.trace):
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            value = harness.piece("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, work
    cell = harness.cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"[card] {card_info()}", flush=True)
    print(f"[peaks] {json.dumps(work.PEAKS)}", flush=True)

    run = execute(args, device, T_PROCESS)
    print(f"[time] setup_s {run.setup_s:.3f} window_s {run.seconds} "
          f"process_s {time.perf_counter() - T_PROCESS:.3f}", flush=True)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3

    bench = harness.benchmark()
    metrics = read_metrics(run, bench)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak_bytes}
    breakdown = None
    if run.trace:
        dev["busy_s"] = run.traced.busy_s
        dev["window_s"] = run.traced.window_s
        breakdown = {"device_ops": run.traced.top_ops(),
                     "idle_gaps": run.traced.idle_gaps()}
    for k, v in sorted(run.rec.counters.items()):
        if isinstance(v, (int, float)):
            print(f"[counter] {k} {v}")
    for name, c in run.checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result(run, metrics, dev, breakdown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
