#!/usr/bin/env python3
"""Time the port's kernels K1-K6 at the CNN paths' and the ops path's
shapes, and K3 at the qwen3-1.7b ``dynamic_a`` prefill's, from one source
tree, on one CUDA device.

    python3 chip_kernel_times.py [SRC_DIR]

SRC_DIR (default: this checkout's ``src``) holds the ``repro_torch``
package to time; its kernels are built there at first use. Each time is
the mean of 50 launches between CUDA events after 10 warm-up launches
(10 after 2 at the LM's shapes), on operands made from seed 0, taken two
ways: launched from Python one by one ("eager": a call of tens of
microseconds then waits on the host's launch cost), and replayed from a
CUDA graph that captured the same launches ("graph": the device's time
alone). To compare two versions of the port, unpack
the other one (``git archive <commit> src | tar -x -C DIR``) and run this
script on each tree in turns, on one card: old, new, new, old. Prints the
card's name and power limit, then one JSON object {"eager": {label: ms},
"graph": {label: ms}}.
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


def graph_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Mean device time of ``fn`` per call: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


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

    eager, graph = {}, {}

    def measure(label, fn, lm=False):
        eager[label] = cuda_ms(fn, iters=10, warmup=2) if lm else cuda_ms(fn)
        graph[label] = graph_ms(fn, iters=10 if lm else 50)

    for label, m, k, n in [("fc0", BATCH, 2048, 256), ("fc1", BATCH, 256, 10)]:
        x, wp = ints(-128, 128, (m, k)), packed(k, n)
        measure(f"K1 {label}", lambda: bitserial_matmul(x, wp, w_bits=8))
    # K3 as path D calls it: transposed, the packed operand being the
    # activations (one row group of 256); and as path W calls it on fc0
    # (filter groups of 16, every other one at 4 planes).
    for label, m, k in [("fc0^T", 256, 2048), ("fc1^T", 10, 256)]:
        x, wp = ints(-128, 128, (m, k)), packed(k, BATCH)
        counts = torch.full((1,), 8, dtype=torch.int32, device="cuda")
        measure(f"K3 {label}", lambda: bitserial_matmul_dynamic(
            x, wp, counts, w_bits=8, bn=256))
    x, wp = ints(-128, 128, (BATCH, 2048)), packed(2048, 256)
    counts = torch.tensor([8, 4] * 8, dtype=torch.int32, device="cuda")
    measure("K3 fc0 bn16", lambda: bitserial_matmul_dynamic(
        x, wp, counts, w_bits=8, bn=16))
    # K3 as the LM's dynamic_a prefill calls it: each linear transposed,
    # the weights [N_out, K] against the activations packed at Pa = 8: 2 x
    # 512 rows (four row groups of 256) at layer 0's seven linears (q, k,
    # v, o, gate, up, down), the last position's 2 rows (one group, padded
    # to 8) at the head; per prefill 28 layers and the head.
    lm = [("q", 2048, 2048, 1024), ("k", 1024, 2048, 1024),
          ("v", 1024, 2048, 1024), ("o", 2048, 2048, 1024),
          ("gate", 6144, 2048, 1024), ("up", 6144, 2048, 1024),
          ("down", 2048, 6144, 1024), ("head", 151936, 2048, 8)]
    for label, m, k, rows in lm:
        x, wp = ints(-128, 128, (m, k)), packed(k, rows)
        bn = min(256, rows)
        counts = torch.full((rows // bn,), 8, dtype=torch.int32,
                            device="cuda")
        measure(f"K3 LM {label}^T", lambda: bitserial_matmul_dynamic(
            x, wp, counts, w_bits=8, bn=bn), lm=True)
        del x, wp
    for times in (eager, graph):
        times["K3 LM dynamic_a prefill (28 x layer 0 + head)"] = sum(
            times[f"K3 LM {label}^T"] * (1 if label == "head" else 28)
            for label, _, _, _ in lm)
    for label, h, c, n in [("conv1", 32, 3, 32), ("conv2", 16, 32, 64),
                           ("conv3", 8, 64, 128)]:
        x, wp = ints(-128, 128, (BATCH, h, h, c)), packed(9 * c, n)
        counts = torch.tensor([8, 4] * n, dtype=torch.int32,
                              device="cuda")[:-(-n // 16)]
        w8 = ints(-128, 128, (-(-9 * c // 8) * 8, n))
        group = 256 if h > 8 else 64
        wcounts = ints(1, 9, (BATCH, -(-h * h // group)), torch.int32)
        measure(f"K2 {label}", lambda: bitserial_conv(
            x, wp, kernel=3, stride=1, w_bits=8))
        measure(f"K4 {label}", lambda: bitserial_conv_wgroup(
            x, wp, counts, kernel=3, stride=1, w_bits=8))
        measure(f"K5 {label}", lambda: bitserial_conv_dynamic(
            x, w8, wcounts, kernel=3, stride=1, group_size=group))
    for m, k in [(1024, 2048), (1024, 6144)]:
        xf = torch.randn((m, k), generator=g).cuda()
        measure(f"K6 [{m}, {k}]", lambda: dynamic_quant(
            xf, group_size=256, bits=8))
    print(json.dumps({"src": str(SRC), "eager": eager, "graph": graph}))


if __name__ == "__main__":
    main()
