#!/usr/bin/env python3
"""Plant faults in K7's bf16 tensor-core kernel (``tc_kernel`` in
``csrc/flash_attention.cu``) and check that the K7 checks of
``chip_smoke.py`` catch each one.

    python3 chip_k7_faults.py WORK_DIR

For each fault: copy ``src/`` and ``chip_smoke.py`` into WORK_DIR/<fault>,
edit the kernel source there, and run chip_smoke's K7 phases in that copy
(build, ``phase_k7``, then the long shapes of ``phase_attention_timing``)
in a subprocess. A fault is caught when that run stops at a K7 check; its
line gives the check's max abs err and whether the JAX tests' bf16
tolerance (0.05) would have held. Needs one CUDA device. Exits non-zero
when a fault is not caught. The checkout itself is never edited.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL = "src/repro_torch/kernels/csrc/flash_attention.cu"
# Anchors in the bf16 tensor-core kernel (`tc_kernel`), the route every
# bf16 check of chip_smoke runs.
FIRST = "const int t0 = lo / BK;"
COUNT = "const int nt = (hi + BK - 1) / BK - t0;"
STORE = "__float2bfloat16_rn(acc[4 * j + e] * inv[e >> 1])"
NORM = "inv[r] = 1.0f / fmaxf(l[r], 1e-30f);"

# fault -> (text of the kernel source, its replacement)
FAULTS = {
    # the window's first key tile skipped
    "window_tile": (FIRST, "const int t0 = lo > 0 ? lo / BK + 1 : 0;"),
    # without causal, the last key tile skipped (S = 1000: 40 keys)
    "last_tile": (COUNT, "const int nt = (hi + BK - 1) / BK - t0 - "
                         "(causal ? 0 : 1);"),
    # rows from 20000 (32000) on written as zeros (S = 32768 only)
    "zeros_20000": (STORE, "__float2bfloat16_rn(qi >= 20000 ? 0.0f : "
                           "acc[4 * j + e] * inv[e >> 1])"),
    "zeros_32000": (STORE, "__float2bfloat16_rn(qi >= 32000 ? 0.0f : "
                           "acc[4 * j + e] * inv[e >> 1])"),
    # every output 1% too large
    "scale_1.01": (NORM, "inv[r] = 1.01f / fmaxf(l[r], 1e-30f);"),
}

RUN = ("import chip_smoke as c\n"
       "errs = {k: 0 for k in c.KERNELS}\n"
       "c.phase_build()\n"
       "c.phase_k7(errs)\n"
       "c.phase_attention_timing(errs)\n")


def plant(work: Path, name: str) -> Path:
    """A copy of the checkout's ``src/`` and ``chip_smoke.py`` under
    ``work/name`` with the fault written into the kernel source."""
    old, new = FAULTS[name]
    copy = work / name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "src", copy / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", copy)
    path = copy / KERNEL
    text = path.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: the kernel source no longer holds {old!r}")
    path.write_text(text.replace(old, new))
    return copy


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    work = Path(sys.argv[1]).resolve()
    missed = []
    for name in FAULTS:
        run = subprocess.run([sys.executable, "-c", RUN], cwd=plant(work, name),
                             capture_output=True, text=True)
        why = [line for line in run.stderr.splitlines()
               if line.startswith("RuntimeError: chip_smoke: flash_attention")]
        if run.returncode and why:
            print(f"[faults] {name}: caught: {why[-1]}")
        else:
            missed.append(name)
            tail = (run.stderr.strip().splitlines() or ["(no error)"])[-1]
            print(f"[faults] {name}: NOT caught (exit {run.returncode}): "
                  f"{tail}")
    print(f"[faults] {len(FAULTS) - len(missed)} of {len(FAULTS)} planted "
          f"faults caught by chip_smoke's K7 checks")
    sys.exit(1 if missed else 0)


if __name__ == "__main__":
    main()
