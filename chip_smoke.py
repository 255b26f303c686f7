#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold its
kernels against their plain versions.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- the card's name, count and nvidia-smi power limit; no CUDA
              device means exit 1.
2. build   -- compile every kernel from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, in parallel) and print ptxas usage.
3. kernels -- K1 ``bitserial_matmul`` and K2 ``bitserial_conv`` against
              their plain versions on the card, exact (``torch.equal``), at
              the paper CNN's shapes (batch 256) and at ragged, banded,
              strided and K-padded shapes.
4. serve   -- ``repro_torch.compile(paper_cnn, uniform_policy(8, 8),
              mode="serve_packed", backend="cuda")`` serves REQUESTS batches
              of BATCH images; the launch counts (reset just before) must
              show every kernel on the path, and the logits must equal a
              ``torch_ref`` session's on the same card bit for bit, and a
              CPU session's on a small batch. Then LATENCY_SAMPLES requests
              one at a time give the latency's median and p90.
5. timing  -- each kernel at the operands the main path gave it (CUDA
              events), beside its plain version, one PyTorch library call
              computing the same function, and its bound: the larger of
              bytes / 3.35 TB/s and operations / 1979 TOP/s (H100 SXM
              int8 peak).
6. profile -- device time by kernel over a few requests (torch.profiler)
              and the device's idle share of the request time.

The second-to-last line is one JSON object ``{"kernels": [...]}`` with per
-request totals (ms per classify of BATCH images); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api.backend import CudaBackend  # noqa: E402
from repro_torch.core import bitpack, quantize as q  # noqa: E402
from repro_torch.core.policy import uniform_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bitserial_conv import (  # noqa: E402
    bitserial_conv, bitserial_conv_plain)
from repro_torch.kernels.bitserial_matmul import (  # noqa: E402
    bitserial_matmul, bitserial_matmul_plain)
from repro_torch.kernels.ops import conv_accum_fits_f32  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

BATCH = 256
REQUESTS = 8
LATENCY_SAMPLES = 100
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak

KERNELS = {
    "bitserial_matmul": dict(
        fn=bitserial_matmul,
        source="src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        replaces="src/repro/kernels/bitserial_matmul.py:72"),
    "bitserial_conv": dict(
        fn=bitserial_conv,
        source="src/repro_torch/kernels/csrc/bitserial_conv.cu",
        replaces="src/repro/kernels/bitserial_conv.py:195"),
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` by CUDA events over ``iters`` calls."""
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def operands(x_shape, k: int, n: int, w_bits: int, seed: int,
             a_bits: int = 8):
    """Random int8 activations and packed weights on the card, from a seed."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(q.qmin(a_bits), q.qmax(a_bits) + 1, x_shape,
                      generator=g, dtype=torch.int8)
    wq = torch.randint(q.qmin(w_bits), q.qmax(w_bits) + 1, (k, n),
                       generator=g, dtype=torch.int32)
    return x.cuda(), bitpack.pack_weights(wq.cuda(), w_bits)


def phase_device() -> tuple[str, int]:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()
    print(f"[device] {name}, {count} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi[0].strip())
    return name, count


def phase_build() -> None:
    nvcc = _build.nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    print(f"[build] {version.splitlines()[-1]}")
    secs = _build.build()
    print(f"[build] {len(_build.SOURCES)} libraries for sm_90a in "
          f"{secs:.1f} s ({' '.join(_build.NVCC_FLAGS)})")
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            print(f"[build] {name}: {line.strip()}")


def phase_kernels(errs: dict) -> None:
    cases = 0
    for label, m, k, n in [("fc0", BATCH, 2048, 256), ("fc1", BATCH, 256, 10),
                           ("ragged", 7, 40, 10)]:
        for w_bits in (1, 8, 11, 16):
            x, wp = operands((m, k), k, n, w_bits, seed=m + k + w_bits)
            got = bitserial_matmul(x, wp, w_bits=w_bits)
            torch.cuda.synchronize()
            want = bitserial_matmul_plain(x, wp, w_bits)
            errs["bitserial_matmul"] = max(errs["bitserial_matmul"],
                                           max_err(got, want))
            check(torch.equal(got, want),
                  f"K1 {label} M={m} K={k} N={n} Pw={w_bits} differs")
            cases += 1
    print(f"[kernels] K1 bitserial_matmul == plain in {cases} cases "
          f"(fc0, fc1 at M={BATCH}; ragged 7x40x10; Pw 1/8/11/16)")
    cases = 0
    for label, b, h, c, n, kernel, stride in [
            ("conv1", BATCH, 32, 3, 32, 3, 1), ("conv2", BATCH, 16, 32, 64, 3, 1),
            ("conv3", BATCH, 8, 64, 128, 3, 1), ("k1", 8, 9, 5, 16, 1, 1),
            ("k5", 8, 9, 5, 16, 5, 1), ("k3s2", 8, 9, 5, 40, 3, 2),
            ("k5s2", 8, 9, 5, 40, 5, 2)]:
        for w_bits in (8, 11, 16):
            x, wp = operands((b, h, h, c), kernel * kernel * c, n, w_bits,
                             seed=b + h + c + kernel + w_bits)
            want = bitserial_conv_plain(x, wp, kernel=kernel, stride=stride,
                                        w_bits=w_bits)
            for rows in (None, 3):
                got = bitserial_conv(x, wp, kernel=kernel, stride=stride,
                                     w_bits=w_bits, rows_per_band=rows)
                torch.cuda.synchronize()
                errs["bitserial_conv"] = max(errs["bitserial_conv"],
                                             max_err(got, want))
                check(torch.equal(got, want),
                      f"K2 {label} {tuple(x.shape)} k={kernel} s={stride} "
                      f"Pw={w_bits} rows={rows} differs")
                cases += 1
    print(f"[kernels] K2 bitserial_conv == plain in {cases} cases (conv1-3 "
          f"at B={BATCH}; k 1/5, stride 2, C=3 K-padding; Pw 8/11/16; "
          f"one band and 3-row bands)")


class _Recording(CudaBackend):
    """The cuda backend, keeping each op's operands (for phase 5)."""

    def __init__(self):
        self.calls = []

    def matmul_planes(self, xq, w_packed, **kw):
        self.calls.append(("bitserial_matmul", xq, w_packed, kw))
        return super().matmul_planes(xq, w_packed, **kw)

    def conv_planes(self, xq, w_packed, **kw):
        self.calls.append(("bitserial_conv", xq, w_packed, kw))
        return super().conv_planes(xq, w_packed, **kw)


def phase_serve():
    cfg = configs.get("paper_cnn")
    policy = uniform_policy(8, 8)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    sess = repro_torch.compile(cfg, policy, mode="serve_packed",
                               backend="cuda", params=params, device="cuda")
    g = torch.Generator().manual_seed(1)
    requests = [torch.randn((BATCH, cfg.img, cfg.img, cfg.in_ch),
                            generator=g).cuda() for _ in range(REQUESTS)]
    sess.classify(requests[0])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    t0 = time.perf_counter()
    logits = [sess.classify(x) for x in requests]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve] {REQUESTS} requests x {BATCH} images: "
          f"{REQUESTS * BATCH / secs:.1f} images/s "
          f"({secs * 1e3 / REQUESTS:.3f} ms/request, host clock after "
          f"synchronize), peak device memory {peak / 2**20:.1f} MiB")
    print(f"[serve] launches: {launches}")
    check(launches["bitserial_conv"] == len(cfg.convs) * REQUESTS,
          f"K2 launched {launches['bitserial_conv']} times")
    check(launches["bitserial_matmul"] == len(cfg.fcs) * REQUESTS,
          f"K1 launched {launches['bitserial_matmul']} times")

    ref = repro_torch.compile(cfg, policy, mode="serve_packed",
                              backend="torch_ref", params=params,
                              device="cuda")
    for x, y in zip(requests, logits):
        check(y.shape == (BATCH, cfg.fcs[-1]) and bool(torch.isfinite(y).all()),
              f"logits {tuple(y.shape)} not finite of the expected shape")
        check(torch.equal(y, ref.classify(x)),
              "cuda logits differ from torch_ref on the card")
    small = requests[0][:4]
    cpu = repro_torch.compile(cfg, policy, mode="serve_packed",
                              backend="torch_ref", params=params,
                              device="cpu")
    check(torch.equal(sess.classify(small).cpu(), cpu.classify(small.cpu())),
          "cuda logits differ from a CPU torch_ref session on 4 images")
    agree = float((logits[0].argmax(-1) == ref.classify(requests[0])
                   .argmax(-1)).float().mean())
    print(f"[serve] logits {tuple(logits[0].shape)} finite; cuda == torch_ref "
          f"on the card for all {REQUESTS} requests (argmax agreement "
          f"{agree:.3f}); cuda == CPU torch_ref on a 4-image batch")

    lat = []
    for i in range(LATENCY_SAMPLES):
        t0 = time.perf_counter()
        sess.classify(requests[i % REQUESTS])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    median = lat[len(lat) // 2]
    print(f"[serve] latency of {LATENCY_SAMPLES} requests sent one at a "
          f"time (host clock to synchronize): median {median * 1e3:.4f} ms, "
          f"p90 {lat[int(len(lat) * 0.9)] * 1e3:.4f} ms, max "
          f"{lat[-1] * 1e3:.4f} ms")

    rec = _Recording()
    repro_torch.compile(cfg, policy, mode="serve_packed", backend=rec,
                        params=params, device="cuda").classify(requests[0])
    torch.cuda.synchronize()
    return launches, rec.calls, sess, requests[0], median


def _library(name: str, xq, wp, kw):
    """One PyTorch call computing the same function, and a check that it
    does: torch._int_mm for K1, an fp32 cuDNN conv (exact: every partial
    sum fits a float32 mantissa) for K2; None where it does not apply."""
    w_bits = wp.shape[0]
    if w_bits != 8:
        return None
    if name == "bitserial_matmul":
        n = wp.shape[2]
        w8 = bitpack.unpack_weights(wp, 8).to(torch.int8)
        w8 = F.pad(w8, (0, (-n) % 8)).contiguous()     # _int_mm: N % 8 == 0
        check(torch.equal(torch._int_mm(xq, w8)[:, :n],
                          bitserial_matmul(xq, wp, w_bits=8)),
              "torch._int_mm disagrees with K1")
        return lambda: torch._int_mm(xq, w8)
    kernel, stride, c = kw["kernel"], kw["stride"], xq.shape[3]
    if not conv_accum_fits_f32(kernel * kernel * c, 8, 8):
        return None
    xf = xq.float().permute(0, 3, 1, 2)
    wf = bitpack.unpack_weights(wp, 8, k=kernel * kernel * c).float()
    wf = wf.reshape(kernel, kernel, c, -1).permute(3, 2, 0, 1).contiguous()

    def conv():
        return F.conv2d(xf, wf, stride=stride, padding=kernel // 2)
    check(torch.equal(conv().permute(0, 2, 3, 1).to(torch.int32),
                      bitserial_conv(xq, wp, kernel=kernel, stride=stride,
                                     w_bits=8)),
          "fp32 cuDNN conv disagrees with K2")
    return conv


def phase_timing(calls: list, errs: dict) -> dict:
    rows = {name: dict(ms=0.0, plain_ms=0.0, bound_bytes_s=0.0,
                       bound_ops_s=0.0, library_ms=0.0, library=True)
            for name in KERNELS}
    for i, (name, xq, wp, kw) in enumerate(calls):
        w_bits = wp.shape[0]
        if name == "bitserial_matmul":
            def kernel(xq=xq, wp=wp, w_bits=w_bits):
                return bitserial_matmul(xq, wp, w_bits=w_bits)

            def plain(xq=xq, wp=wp, w_bits=w_bits):
                return bitserial_matmul_plain(xq, wp, w_bits)
            depth = xq.shape[1]
            shape = f"{tuple(xq.shape)} @ Pw={w_bits} [{wp.shape[1] * 8}, {wp.shape[2]}]"
        else:
            def kernel(xq=xq, wp=wp, kw=kw, w_bits=w_bits):
                return bitserial_conv(xq, wp, kernel=kw["kernel"],
                                      stride=kw["stride"], w_bits=w_bits,
                                      rows_per_band=kw["conv_tile"])

            def plain(xq=xq, wp=wp, kw=kw, w_bits=w_bits):
                return bitserial_conv_plain(xq, wp, kernel=kw["kernel"],
                                            stride=kw["stride"], w_bits=w_bits)
            depth = kw["kernel"] ** 2 * xq.shape[3]
            shape = (f"{tuple(xq.shape)} k={kw['kernel']} s={kw['stride']} "
                     f"rows/band={kw['conv_tile']} -> N={wp.shape[2]} Pw={w_bits}")
        out, want = kernel(), plain()
        errs[name] = max(errs[name], max_err(out, want))
        check(torch.equal(out, want),
              f"{name} differs from plain at main-path operands {shape}")
        nbytes = xq.numel() + wp.numel() + out.numel() * 4
        ops = 2 * out.numel() * depth
        lib = _library(name, xq, wp, kw)
        t_kernel, t_plain = cuda_ms(kernel), cuda_ms(plain, iters=10)
        t_lib = cuda_ms(lib) if lib is not None else None
        r = rows[name]
        r["ms"] += t_kernel
        r["plain_ms"] += t_plain
        r["bound_bytes_s"] += nbytes / HBM_BYTES_PER_S
        r["bound_ops_s"] += ops / INT8_OPS_PER_S
        if t_lib is None:
            r["library"] = False
        else:
            r["library_ms"] += t_lib
        bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
        print(f"[timing] call {i} {name} {shape}: kernel {t_kernel:.4f} ms, "
              f"plain {t_plain:.4f} ms, library "
              f"{'n/a' if t_lib is None else f'{t_lib:.4f} ms'}, bound "
              f"{bound:.5f} ms ({nbytes} B, {ops} op)")
    return rows


def phase_profile(sess, x, request_s: float, requests: int = 4) -> None:
    """Device time by kernel over a few requests (torch.profiler), and the
    device's idle share of the unprofiled median request latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(requests):
            sess.classify(x)
        torch.cuda.synchronize()
    # Device-side events only: an aten op's entry also carries the time of
    # the kernels it launched, which have entries of their own.
    per_kernel = sorted(
        ((e.self_device_time_total / requests, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        reverse=True)
    busy_ms = sum(t for t, _ in per_kernel) / 1e3
    if not per_kernel:
        print("[profile] the profiler recorded no device time: not measured")
        return
    print(f"[profile] device busy {busy_ms:.4f} ms per request of "
          f"{request_s * 1e3:.4f} ms (idle share "
          f"{1 - busy_ms / (request_s * 1e3):.3f}), {requests} requests")
    for t, key in per_kernel[:12]:
        print(f"[profile] {t / 1e3:.4f} ms/request  {key[:90]}")


def main() -> None:
    # The fp32 conv yardstick runs in full fp32, not TF32 (cuDNN's default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count = phase_device()
    phase_build()
    errs = {k: 0 for k in KERNELS}
    phase_kernels(errs)
    launches, calls, sess, x, request_s = phase_serve()
    rows = phase_timing(calls, errs)
    phase_profile(sess, x, request_s)
    kernels = []
    for kname, spec in KERNELS.items():
        r = rows[kname]
        by_bytes = r["bound_bytes_s"] >= r["bound_ops_s"]
        kernels.append({
            "name": kname, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bound_bytes_s"], r["bound_ops_s"]) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": r["library_ms"] if r["library"] else None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
