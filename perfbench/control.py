"""The control of a cell's output check, on the card at the cell's size:
for each seed, one short run of the cell as the benchmark runs it (the
program's reading of each check) and one with the plain reference,
computed in the next precision below the configuration's (int4 for its
int8), put in the program's place on the timed path (the driver's
``control_fault``), read by the same check, which has to come out not
correct.

    python3 perfbench/control.py --workload <cell> --seconds 15 \
        --seeds 11 12 13

Prints per seed and side: ``[control] <cell> seed <n> <side> <check>
<reading> limit <limit> correct <bool>``. The benchmark's own runs do not
run it.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

CONTROL_BITS = 4


def readings(cell_name: str, seed: int, seconds: float, device) -> dict:
    """``{"program": Run, "control": Run}`` of one seed."""
    from perfbench import harness
    cell = harness.cell(cell_name)
    driver = harness.piece("drivers", cell["driver"])
    out = {}
    for side in ("program", "control"):
        run = harness.Run(cell_name, cell, harness.config(cell["config"]),
                          seed, seconds, False, device)
        fault = driver.control_fault(run, CONTROL_BITS) \
            if side == "control" else None
        driver.drive(run, t_process=time.perf_counter(), fault=fault)
        out[side] = run
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for side, run in readings(args.workload, seed, args.seconds,
                                  device).items():
            for name, c in run.checks.items():
                print(f"[control] {args.workload} seed {seed} {side} {name} "
                      f"{c['value']!r} limit {c['limit']!r} correct "
                      f"{run.correct} attempted {run.attempted} failed "
                      f"{run.failed}", flush=True)
        print(f"[control] {args.workload} seed {seed} seconds "
              f"{time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
