"""Paper Table 4: all-layers-combined speedup & efficiency with the Table 3
per-group effective weight precisions (the paper's headline: LM_1b 4.38x
perf, 3.54x efficiency).

PyTorch-port counterpart of ``benchmarks/table4.py``. Run:
``python -m repro_torch.reports table4``.
"""
from __future__ import annotations

from repro_torch.core import cyclemodel as cm, policy as P
from repro_torch.reports import MODELED

DESIGNS = ("lm1b", "lm2b", "lm4b")


def rows() -> list:
    out = []
    for net in sorted(cm.NETWORKS):
        row = {"network": net}
        for design in DESIGNS:
            s = cm.network_speedup(net, design, "t3", "all")
            row[design] = s
            row[design + "_eff"] = cm.efficiency(design, s)
        row["paper_lm1b"] = P.PAPER_PER_NETWORK.get(net, {}).get(
            ("t3", "all", "lm1b"))
        out.append(row)
    g = {}
    for design in DESIGNS:
        g[design] = cm.geomean_speedup(design, "t3", "all")
        g[design + "_eff"] = cm.efficiency(design, g[design])
    out.append({"network": "GEOMEAN", **g,
                "paper_lm1b": P.PAPER_GEOMEANS[("t3", "all", "lm1b")][0]})
    return out


def main() -> None:
    print(MODELED)
    print("== Table 4: all layers, Table-3 effective weight precisions ==")
    print(f"{'network':11s}{'lm1b':>7s}{'paper':>7s}{'eff':>7s}"
          f"{'lm2b':>7s}{'eff':>7s}{'lm4b':>7s}{'eff':>7s}")
    for r in rows():
        paper = r.get("paper_lm1b") or float("nan")
        print(f"{r['network']:11s}{r['lm1b']:7.2f}{paper:7.2f}"
              f"{r['lm1b_eff']:7.2f}{r['lm2b']:7.2f}{r['lm2b_eff']:7.2f}"
              f"{r['lm4b']:7.2f}{r['lm4b_eff']:7.2f}")
