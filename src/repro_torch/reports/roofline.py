"""Roofline report: aggregates the port's dry-run records
(``results/dryrun_torch/*.json``, written by ``python -m
repro_torch.launch.dryrun``) into one table per mesh (per arch x shape:
three terms, dominant bottleneck, roofline fraction, MODEL_FLOPS ratio),
and the fleet summary of the optimized records under
``results/opt_torch/`` (``dryrun --opt ... --out-dir results/opt_torch``).

PyTorch-port counterpart of ``benchmarks/roofline.py``. Every time here
is the dry run's: MODELED on the H100 SXM's datasheet constants, not
measured. Run: ``python -m repro_torch.reports roofline``.
"""
from __future__ import annotations

import glob
import json
import math
import os

_RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "results")
RESULTS = os.path.join(_RESULTS, "dryrun_torch")   # launch.dryrun.RESULTS_DIR
OPT_RESULTS = os.path.join(_RESULTS, "opt_torch")
MODELED = ("(MODELED: the dry run's seconds per rank on the H100 SXM's "
           "datasheet constants, not measured)")


def load(results_dir=RESULTS) -> list:
    recs = []
    for p in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_ms(s) -> str:
    return f"{s * 1e3:.1f}"


def table(recs, *, mesh="single", weights="dense", tag="") -> str:
    rows = []
    hdr = (f"| arch | shape | compute ms | memory ms | collective ms | "
           f"dominant | ideal ms | roofline frac | useful FLOP ratio |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for r in recs:
        if r.get("skipped") or r.get("mesh") != mesh \
                or r.get("weights") != weights or r.get("tag", "") != tag:
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(r['t_compute_s'])} "
            f"| {fmt_ms(r['t_memory_s'])} | {fmt_ms(r['t_collective_s'])} "
            f"| {r['dominant']} | {fmt_ms(r['ideal_bound_s'])} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {r.get('useful_flop_ratio', 0):.2f} |")
    return "\n".join(rows)


def main(results_dir=RESULTS, opt_dir=OPT_RESULTS) -> list:
    """Prints the report over ``results_dir``'s records (and
    ``opt_dir``'s); returns the records."""
    recs = load(results_dir)
    if not recs:
        print("== roofline: no dry-run results yet "
              "(run python -m repro_torch.launch.dryrun) ==")
        return recs
    done = [r for r in recs if not r.get("skipped")]
    skipped = [r for r in recs if r.get("skipped")]
    print(MODELED)
    print(f"== roofline: {len(done)} compiled cells, "
          f"{len(skipped)} inapplicable ==")
    print(table(recs, mesh="single"))
    multi = [r for r in done if r.get("mesh") == "multi"]
    if multi:
        print(f"-- multi-pod (512 chips): {len(multi)} cells compiled OK --")
    # fleet-optimized summary
    opts = load(opt_dir)
    if opts:
        base = {(r["arch"], r["shape"]): r for r in done
                if r["mesh"] == "single" and not r.get("tag")}
        best = {}
        for r in opts:
            if r.get("skipped"):
                continue
            k = (r["arch"], r["shape"])
            if k not in best or r["bound_s"] < best[k]["bound_s"]:
                best[k] = r
        sp = [max(base[k]["bound_s"] / best[k]["bound_s"], 1.0)
              for k in best if k in base]
        if sp:
            gm = math.exp(sum(math.log(x) for x in sp) / len(sp))
            print(f"-- fleet-optimized ({len(sp)} cells, §Perf opt sets): "
                  f"geomean bound speedup {gm:.2f}x over the dense "
                  f"baseline --")
    return recs
