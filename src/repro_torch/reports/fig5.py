"""Paper Fig 5: scaling of LM_1b speedup vs DPNN as the equivalent peak
compute bandwidth grows 32 -> 512 MACs/cycle (under-utilization growth).

PyTorch-port counterpart of ``benchmarks/fig5.py``. Run:
``python -m repro_torch.reports fig5``.
"""
from __future__ import annotations

from repro_torch.core import cyclemodel as cm
from repro_torch.reports import MODELED


def main() -> None:
    print(MODELED)
    print("== Fig 5: LM_1b speedup vs equivalent DPNN peak bandwidth ==")
    curve = cm.scaling_curve("lm1b", "100")
    prev = None
    for macs, s in sorted(curve.items()):
        note = ""
        if prev is not None and s < prev:
            note = "  (under-utilization growing, as in the paper)"
        print(f"  {macs:4d} MACs/cyc  speedup {s:5.2f}{note}")
        prev = s
    if not curve[128] > curve[512]:
        raise AssertionError("paper: relative advantage drops at 512")
