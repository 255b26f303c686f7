"""Paper Table 2: per-network speedup & energy efficiency of Stripes and
LM_{1,2,4}b over DPNN, for FCLs and CVLs, 100% and 99% profiles.

PyTorch-port counterpart of ``benchmarks/table2.py``. Run:
``python -m repro_torch.reports table2``.
"""
from __future__ import annotations

from repro_torch.core import cyclemodel as cm, policy as P
from repro_torch.reports import MODELED

DESIGNS = ("stripes", "lm1b", "lm2b", "lm4b")


def rows() -> list:
    """One row per (profile, network) with every (kind, design)'s speedup
    and efficiency (NaN where the model has no such layers), then one
    GEOMEAN row per (profile, kind, design) beside the paper's."""
    out = []
    for profile in ("100", "99"):
        for net in sorted(cm.NETWORKS):
            row = {"profile": profile, "network": net}
            for kind in ("fcl", "cvl"):
                for design in DESIGNS:
                    s = cm.network_speedup(net, design, profile, kind)
                    row[f"{kind}_{design}_perf"] = s
                    row[f"{kind}_{design}_eff"] = (
                        cm.efficiency(design, s) if s == s else float("nan"))
            out.append(row)
        for kind in ("fcl", "cvl"):
            for design in DESIGNS:
                g = cm.geomean_speedup(design, profile, kind)
                paper = P.PAPER_GEOMEANS.get((profile, kind, design))
                out.append({"profile": profile, "network": "GEOMEAN",
                            "kind": kind, "design": design, "ours": g,
                            "paper": paper[0] if paper else None,
                            "ours_eff": cm.efficiency(design, g),
                            "paper_eff": paper[1] if paper else None})
    return out


def main() -> None:
    """Prints the geomeans and the per-network LM_1b columns."""
    print(MODELED)
    print("== Table 2: speedup / energy efficiency vs DPNN ==")
    print(f"{'profile':8s}{'network':11s}{'kind':5s}{'design':8s}"
          f"{'perf(ours)':>11s}{'perf(paper)':>12s}{'eff(ours)':>10s}"
          f"{'eff(paper)':>11s}")
    for r in rows():
        if r["network"] != "GEOMEAN":
            continue
        print(f"{r['profile']:8s}{r['network']:11s}{r['kind']:5s}"
              f"{r['design']:8s}{r['ours']:11.2f}"
              f"{(r['paper'] if r['paper'] else float('nan')):12.2f}"
              f"{r['ours_eff']:10.2f}"
              f"{(r['paper_eff'] if r['paper_eff'] else float('nan')):11.2f}")
    # per-network LM_1b CVL (the paper's headline columns)
    print("-- per-network LM_1b (100% profile) --")
    for net in sorted(cm.NETWORKS):
        cvl = cm.network_speedup(net, "lm1b", "100", "cvl")
        fcl = cm.network_speedup(net, "lm1b", "100", "fcl")
        pp = P.PAPER_PER_NETWORK.get(net, {})
        print(f"  {net:10s} CVL {cvl:5.2f} (paper "
              f"{pp.get(('100', 'cvl', 'lm1b'), float('nan')):5.2f})   "
              f"FCL {fcl:5.2f} (paper "
              f"{pp.get(('100', 'fcl', 'lm1b'), float('nan')):5.2f})")
