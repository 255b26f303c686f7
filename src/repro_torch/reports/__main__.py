"""Run the paper's reports, each under a banner with its seconds::

    python -m repro_torch.reports                        # every report
    python -m repro_torch.reports table2 fig5            # some
    python -m repro_torch.reports table1 --device cpu    # Table 1 on the CPU

PyTorch-port counterpart of ``benchmarks/run.py``. Table 1 runs on
``--device`` (default ``cuda``, which needs a card); the others are host
arithmetic over the cycle model or the dry run's records.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.reports import fig4, fig5, roofline, table1, table2, table4

ALL = {
    "table1": table1.main,     # precision profiling methodology, live
    "table2": table2.main,     # FCL/CVL speedups vs paper
    "table4": table4.main,     # all-layers, per-group weight precisions
    "fig4": fig4.main,         # perf/eff per network
    "fig5": fig5.main,         # scaling 32->512 equiv MACs
    "roofline": roofline.main,        # dry-run roofline aggregation
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", choices=list(ALL), metavar="report",
                    help=f"any of {', '.join(ALL)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="Table 1's device (default cuda)")
    args = ap.parse_args(argv)
    for name in args.names or list(ALL):
        t0 = time.time()
        print(f"\n##### {name} " + "#" * (60 - len(name)))
        if name == "table1":
            table1.main(device=args.device)
        else:
            ALL[name]()
        print(f"##### {name} done in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
