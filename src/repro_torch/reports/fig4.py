"""Paper Fig 4: performance and energy efficiency of Loom/Stripes relative
to DPNN, all layers combined, 100% accuracy profiles.

PyTorch-port counterpart of ``benchmarks/fig4.py``. Run:
``python -m repro_torch.reports fig4``.
"""
from __future__ import annotations

from repro_torch.core import cyclemodel as cm
from repro_torch.reports import MODELED

DESIGNS = ("stripes", "lm1b", "lm2b", "lm4b")


def main() -> None:
    print(MODELED)
    print("== Fig 4: all-layers perf / efficiency vs DPNN (100% profiles) ==")
    print(f"{'network':11s}" + "".join(f"{d:>14s}" for d in DESIGNS))
    for net in sorted(cm.NETWORKS):
        vals = []
        for d in DESIGNS:
            s = cm.network_speedup(net, d, "100", "all")
            e = cm.efficiency(d, s)
            vals.append(f"{s:5.2f}/{e:5.2f}")
        print(f"{net:11s}" + "".join(f"{v:>14s}" for v in vals))
    print("(speedup/efficiency; paper Fig 4a/4b: LM_1b avg >3x perf, "
          ">2.5x efficiency; LM_4b most energy-efficient)")
