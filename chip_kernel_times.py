#!/usr/bin/env python3
"""Time the port's kernels K1-K6 at the CNN paths' and the ops path's
shapes, from one source tree, on one CUDA device.

    python3 chip_kernel_times.py [SRC_DIR]

SRC_DIR (default: this checkout's ``src``) holds the ``repro_torch``
package to time; its kernels are built there at first use. Each time is
the mean of 50 launches between CUDA events after 10 warm-up launches,
on operands made from seed 0. To compare two versions of the port, unpack
the other one (``git archive <commit> src | tar -x -C DIR``) and run this
script on each tree in turns, on one card: old, new, new, old. Prints the
card's name and power limit, then one JSON object {label: ms}.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SRC = Path(sys.argv[1] if len(sys.argv) > 1 else
           Path(__file__).resolve().parent / "src").resolve()
sys.path.insert(0, str(SRC))

import torch  # noqa: E402

from repro_torch.core import bitpack  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bitserial_conv import (  # noqa: E402
    bitserial_conv, bitserial_conv_dynamic, bitserial_conv_wgroup)
from repro_torch.kernels.bitserial_matmul import (  # noqa: E402
    bitserial_matmul, bitserial_matmul_dynamic)
from repro_torch.kernels.dynamic_quant import dynamic_quant  # noqa: E402

BATCH = 256


def cuda_ms(fn, iters: int = 50, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_kernel_times: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build()
    g = torch.Generator().manual_seed(0)

    def ints(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype).cuda()

    def packed(k, n):
        return bitpack.pack_weights(ints(-128, 128, (k, n), torch.int32), 8)

    times = {}
    for label, m, k, n in [("fc0", BATCH, 2048, 256), ("fc1", BATCH, 256, 10)]:
        x, wp = ints(-128, 128, (m, k)), packed(k, n)
        times[f"K1 {label}"] = cuda_ms(
            lambda: bitserial_matmul(x, wp, w_bits=8))
    # K3 as path D calls it: transposed, the packed operand being the
    # activations (one row group of 256).
    for label, m, k in [("fc0^T", 256, 2048), ("fc1^T", 10, 256)]:
        x, wp = ints(-128, 128, (m, k)), packed(k, BATCH)
        counts = torch.full((1,), 8, dtype=torch.int32, device="cuda")
        times[f"K3 {label}"] = cuda_ms(
            lambda: bitserial_matmul_dynamic(x, wp, counts, w_bits=8, bn=256))
    for label, h, c, n in [("conv1", 32, 3, 32), ("conv2", 16, 32, 64),
                           ("conv3", 8, 64, 128)]:
        x, wp = ints(-128, 128, (BATCH, h, h, c)), packed(9 * c, n)
        counts = torch.tensor([8, 4] * n, dtype=torch.int32,
                              device="cuda")[:-(-n // 16)]
        w8 = ints(-128, 128, (-(-9 * c // 8) * 8, n))
        group = 256 if h > 8 else 64
        wcounts = ints(1, 9, (BATCH, -(-h * h // group)), torch.int32)
        times[f"K2 {label}"] = cuda_ms(lambda: bitserial_conv(
            x, wp, kernel=3, stride=1, w_bits=8))
        times[f"K4 {label}"] = cuda_ms(lambda: bitserial_conv_wgroup(
            x, wp, counts, kernel=3, stride=1, w_bits=8))
        times[f"K5 {label}"] = cuda_ms(lambda: bitserial_conv_dynamic(
            x, w8, wcounts, kernel=3, stride=1, group_size=group))
    for m, k in [(1024, 2048), (1024, 6144)]:
        xf = torch.randn((m, k), generator=g).cuda()
        times[f"K6 [{m}, {k}]"] = cuda_ms(
            lambda: dynamic_quant(xf, group_size=256, bits=8))
    print(json.dumps({"src": str(SRC), "ms": times}))


if __name__ == "__main__":
    main()
