#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and hold its kernels
against their plain versions.

    python3 chip_smoke.py

Three paths of the paper CNN (``repro_torch.compile(paper_cnn, policy,
mode="serve_packed", backend="cuda")``, batch 256, random weights):

    static  ``uniform_policy(8, 8)``: K2 on every conv, K1 on every FC
            (random weights: every filter group's count is full);
    D       ``uniform_policy(8, 8, dynamic_a=True)``, runtime activation
            trimming: K5 on every conv, K3 (transposed) on every FC;
    W       ``uniform_policy(8, 8)`` on filter-group-skewed weights
            (every other group of 16 filters scaled by 1/32): K4 on a conv
            and K3 on an FC whose pack-time counts fall below Pw, K1/K2 on
            the rest.

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- the card's name, count and nvidia-smi power limit; no CUDA
              device means exit 1.
2. build   -- compile every kernel from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, in parallel) and print ptxas usage.
3. kernels -- K1-K5 against their plain versions on the card, exact
              (``torch.equal``), at the paths' shapes (batch 256) and at
              ragged, banded, strided and K-padded shapes; K3-K5 with
              random plane counts (forced truncation) and full counts.
4. serve   -- each path serves REQUESTS batches of BATCH images with the
              launch counts reset just before; the counts must show the
              path's kernels and no other. Static: logits equal a
              ``torch_ref`` session's on the same card and a CPU session's
              on a small batch; LATENCY_SAMPLES requests one at a time
              give the latency's median and p90. D (letterboxed images,
              the bottom half scaled by 0.02): logits equal the static
              session's and a ``torch_ref`` D session's. W: logits equal
              the same weights served untrimmed (``w_group=0``).
              Composition: D on W's weights equals the static logits.
5. timing  -- each kernel at the operands its path gave it (CUDA events),
              beside its plain version, one PyTorch library call
              computing the same function, and its bound: the larger of
              bytes / 3.35 TB/s and operations / 1979 TOP/s (H100 SXM
              int8 peak).
6. profile -- per path: the PyTorch operators one request dispatches on
              the host, device time by kernel over a few requests
              (torch.profiler), and the device's idle share of the path's
              median request latency.

The second-to-last line is one JSON object ``{"kernels": [...]}`` with per
-request totals (ms per classify of BATCH images) on each kernel's path;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.api import backend as backend_module  # noqa: E402
from repro_torch.core import bitpack, quantize as q  # noqa: E402
from repro_torch.core.policy import uniform_policy  # noqa: E402
from repro_torch.core.weightgroups import truncate_columns_grouped  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.bitserial_conv import (  # noqa: E402
    bitserial_conv, bitserial_conv_dynamic, bitserial_conv_dynamic_plain,
    bitserial_conv_plain, bitserial_conv_wgroup, bitserial_conv_wgroup_plain)
from repro_torch.kernels.bitserial_matmul import (  # noqa: E402
    bitserial_matmul, bitserial_matmul_dynamic, bitserial_matmul_dynamic_plain,
    bitserial_matmul_plain)
from repro_torch.kernels.ops import conv_accum_fits_f32  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

BATCH = 256
REQUESTS = 8
LATENCY_SAMPLES = 100
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 tensor-core peak
CSRC = "src/repro_torch/kernels/csrc"

# Each kernel's wrapper, plain version and the path whose run its JSON
# entry reports.
KERNELS = {
    "bitserial_matmul": dict(
        fn=bitserial_matmul, plain=bitserial_matmul_plain, path="static",
        source=f"{CSRC}/bitserial_matmul.cu",
        replaces="src/repro/kernels/bitserial_matmul.py:72"),
    "bitserial_conv": dict(
        fn=bitserial_conv, plain=bitserial_conv_plain, path="static",
        source=f"{CSRC}/bitserial_conv.cu",
        replaces="src/repro/kernels/bitserial_conv.py:195"),
    "bitserial_matmul_dynamic": dict(
        fn=bitserial_matmul_dynamic, plain=bitserial_matmul_dynamic_plain,
        path="D", source=f"{CSRC}/bitserial_matmul.cu",
        replaces="src/repro/kernels/bitserial_matmul.py:133"),
    "bitserial_conv_wgroup": dict(
        fn=bitserial_conv_wgroup, plain=bitserial_conv_wgroup_plain,
        path="W", source=f"{CSRC}/bitserial_conv.cu",
        replaces="src/repro/kernels/bitserial_conv.py:294"),
    "bitserial_conv_dynamic": dict(
        fn=bitserial_conv_dynamic, plain=bitserial_conv_dynamic_plain,
        path="D", source=f"{CSRC}/bitserial_conv.cu",
        replaces="src/repro/kernels/bitserial_conv.py:405"),
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


def count_cases(shape, bits: int, seed: int):
    """Random plane counts in [1, bits] (forced truncation) and full ones."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, bits + 1, shape, generator=g,
                          dtype=torch.int32).cuda(),
            torch.full(shape, bits, dtype=torch.int32, device="cuda")]


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def read_launches() -> dict:
    return {name: spec["fn"].launches for name, spec in KERNELS.items()}


@contextlib.contextmanager
def recorded_calls():
    """Yield a list that collects (kernel, args, kwargs) of every kernel
    wrapper call the backend makes inside the block (for phase 5)."""
    calls = []
    originals = {name: getattr(backend_module, name) for name in KERNELS}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call
    for name, fn in originals.items():
        setattr(backend_module, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(backend_module, name, fn)


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


def _hold(errs: dict, name: str, got, want, what: str) -> None:
    errs[name] = max(errs[name], max_err(got, want))
    check(torch.equal(got, want), f"{name} {what} differs from plain")


def phase_kernels(errs: dict) -> None:
    cases = 0
    for label, m, k, n in [("fc0", BATCH, 2048, 256), ("fc1", BATCH, 256, 10),
                           ("ragged", 7, 40, 10)]:
        for w_bits in (1, 8, 11, 16):
            x, wp = operands((m, k), k, n, w_bits, seed=m + k + w_bits)
            got = bitserial_matmul(x, wp, w_bits=w_bits)
            torch.cuda.synchronize()
            _hold(errs, "bitserial_matmul", got,
                  bitserial_matmul_plain(x, wp, w_bits),
                  f"{label} M={m} K={k} N={n} Pw={w_bits}")
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
                _hold(errs, "bitserial_conv", got, want,
                      f"{label} {tuple(x.shape)} k={kernel} s={stride} "
                      f"Pw={w_bits} rows={rows}")
                cases += 1
    print(f"[kernels] K2 bitserial_conv == plain in {cases} cases (conv1-3 "
          f"at B={BATCH}; k 1/5, stride 2, C=3 K-padding; Pw 8/11/16; "
          f"one band and 3-row bands)")

    # K3: path D's transposed FCs (weights [N_out, K8] x activations packed
    # at Pa = 8, one row group of 256), fc0 as path W calls it (bn 16),
    # and a ragged last group.
    cases = 0
    for label, m, k, n, bits_list, bn in [
            ("D fc0", 256, 2048, BATCH, (8,), 256),
            ("D fc1", 10, 256, BATCH, (8,), 256),
            ("W fc0", BATCH, 2048, 256, (8, 11, 16), 16),
            ("ragged", 7, 40, 40, (8, 11, 16), 16)]:
        for bits in bits_list:
            x, wp = operands((m, k), k, n, bits, seed=m + k + bits + bn)
            for counts in count_cases((-(-n // bn),), bits, seed=n + bits):
                got = bitserial_matmul_dynamic(x, wp, counts, w_bits=bits,
                                               bn=bn)
                torch.cuda.synchronize()
                _hold(errs, "bitserial_matmul_dynamic", got,
                      bitserial_matmul_dynamic_plain(x, wp, counts, bits, bn),
                      f"{label} M={m} K={k} N={n} P={bits} bn={bn}")
                cases += 1
    print(f"[kernels] K3 bitserial_matmul_dynamic == plain in {cases} cases "
          f"(path D fc0/fc1 transposed at bn 256; fc0 at bn 16, Pw "
          f"8/11/16; ragged N=40 at bn 16; random and full counts)")

    # K4: conv1-3 at B = 256 and a ragged last filter group (N = 40).
    cases = 0
    for label, b, h, c, n in [("conv1", BATCH, 32, 3, 32),
                              ("conv2", BATCH, 16, 32, 64),
                              ("conv3", BATCH, 8, 64, 128),
                              ("N=40", 8, 9, 5, 40)]:
        for w_bits in (8, 11, 16):
            x, wp = operands((b, h, h, c), 9 * c, n, w_bits,
                             seed=b + h + c + w_bits)
            for counts in count_cases((-(-n // 16),), w_bits, seed=n + w_bits):
                want = bitserial_conv_wgroup_plain(
                    x, wp, counts, kernel=3, stride=1, w_bits=w_bits)
                for rows in (None, 3):
                    got = bitserial_conv_wgroup(x, wp, counts, kernel=3,
                                                stride=1, w_bits=w_bits,
                                                rows_per_band=rows)
                    torch.cuda.synchronize()
                    _hold(errs, "bitserial_conv_wgroup", got, want,
                          f"{label} {tuple(x.shape)} Pw={w_bits} rows={rows}")
                    cases += 1
    print(f"[kernels] K4 bitserial_conv_wgroup == plain in {cases} cases "
          f"(conv1-3 at B={BATCH}, N=40 ragged; Pw 8/11/16; random and full "
          f"counts; one band and 3-row bands)")

    # K5: conv1-3 at B = 256 (groups of 256, 256, 64 windows), k 1 and 5,
    # stride 2, C = 3 (K8 pads 27 to 32).
    cases = 0
    for label, b, h, c, n, kernel, stride, gsz in [
            ("conv1", BATCH, 32, 3, 32, 3, 1, 256),
            ("conv2", BATCH, 16, 32, 64, 3, 1, 256),
            ("conv3", BATCH, 8, 64, 128, 3, 1, 64),
            ("k1", 8, 9, 5, 16, 1, 1, 16), ("k5s2", 8, 9, 5, 40, 5, 2, 8),
            ("k3s2c3", 8, 9, 3, 24, 3, 2, 8)]:
        g = torch.Generator().manual_seed(b + h + c + kernel)
        x = torch.randint(-128, 128, (b, h, h, c), generator=g,
                          dtype=torch.int8).cuda()
        k8 = -(-kernel * kernel * c // 8) * 8
        wq = torch.randint(-128, 128, (k8, n), generator=g,
                           dtype=torch.int8).cuda()
        nwin = (-(-h // stride)) ** 2
        for counts in count_cases((b, -(-nwin // gsz)), 8, seed=nwin + gsz):
            want = bitserial_conv_dynamic_plain(x, wq, counts, kernel=kernel,
                                                stride=stride, group_size=gsz)
            banded = ref.bitserial_conv_dynamic_banded_ref(
                x, bitpack.pack_weights(wq.to(torch.int32), 8), counts,
                kernel=kernel, stride=stride, w_bits=8, group_size=gsz,
                rows_per_band=3)
            check(torch.equal(banded, want), f"K5 {label}: the band-local "
                  f"oracle differs from the plain version")
            for rows in (None, 3):
                got = bitserial_conv_dynamic(x, wq, counts, kernel=kernel,
                                             stride=stride, group_size=gsz,
                                             rows_per_band=rows)
                torch.cuda.synchronize()
                _hold(errs, "bitserial_conv_dynamic", got, want,
                      f"{label} {tuple(x.shape)} k={kernel} s={stride} "
                      f"group={gsz} rows={rows}")
                cases += 1
    print(f"[kernels] K5 bitserial_conv_dynamic == plain (and its band-local "
          f"oracle) in {cases} cases (conv1-3 at B={BATCH}, groups "
          f"256/256/64; k 1/5, stride 2, C=3 K-padding; random and full "
          f"counts; one band and 3-row bands)")


def skewed_params(cfg):
    """Seed-0 params with every other group of 16 output filters of every
    layer scaled by 1/32: those groups pack to fewer weight planes."""
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    for p in params.values():
        for g in range(1, -(-p["w"].shape[1] // 16), 2):
            p["w"][:, g * 16:(g + 1) * 16] /= 32
    return params


def serve(label: str, sess, requests: list, expect: dict) -> tuple:
    """Serve ``requests`` with every launch count reset just before; the
    counts read just after must equal ``expect`` (per request) for every
    kernel. Returns (logits, launches, seconds)."""
    sess.classify(requests[0])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits = [sess.classify(x) for x in requests]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n = len(requests)
    print(f"[serve] path {label}: {n} requests x {BATCH} images: "
          f"{n * BATCH / secs:.1f} images/s "
          f"({secs * 1e3 / n:.3f} ms/request, host clock after "
          f"synchronize), peak device memory {peak / 2**20:.1f} MiB")
    print(f"[serve] path {label} launches: {launches}")
    for name in KERNELS:
        check(launches[name] == expect.get(name, 0) * n,
              f"path {label}: {name} launched {launches[name]} times, "
              f"expected {expect.get(name, 0) * n}")
    for y in logits:
        check(y.shape == (BATCH, 10) and bool(torch.isfinite(y).all()),
              f"path {label}: logits {tuple(y.shape)} not finite of the "
              f"expected shape")
    return logits, launches, secs


def latency(sess, requests: list, samples: int) -> float:
    lat = []
    for i in range(samples):
        t0 = time.perf_counter()
        sess.classify(requests[i % len(requests)])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    lat.sort()
    median = lat[len(lat) // 2]
    print(f"[serve] latency of {samples} requests sent one at a "
          f"time (host clock to synchronize): median {median * 1e3:.4f} ms, "
          f"p90 {lat[int(len(lat) * 0.9)] * 1e3:.4f} ms, max "
          f"{lat[-1] * 1e3:.4f} ms")
    return median


def phase_serve() -> dict:
    cfg = configs.get("paper_cnn")
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    requests = [torch.randn((BATCH, cfg.img, cfg.img, cfg.in_ch),
                            generator=g).cuda() for _ in range(REQUESTS)]
    convs, fcs = len(cfg.convs), len(cfg.fcs)
    runs, all_launches = {}, {}

    # The static path.
    sess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_packed",
                               backend="cuda", params=params, device="cuda")
    logits, all_launches["static"], _ = serve(
        "static", sess, requests,
        {"bitserial_conv": convs, "bitserial_matmul": fcs})
    ref_sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                   mode="serve_packed", backend="torch_ref",
                                   params=params, device="cuda")
    for x, y in zip(requests, logits):
        check(torch.equal(y, ref_sess.classify(x)),
              "cuda logits differ from torch_ref on the card")
    small = requests[0][:4]
    cpu = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_packed",
                              backend="torch_ref", params=params,
                              device="cpu")
    check(torch.equal(sess.classify(small).cpu(), cpu.classify(small.cpu())),
          "cuda logits differ from a CPU torch_ref session on 4 images")
    agree = float((logits[0].argmax(-1) == ref_sess.classify(requests[0])
                   .argmax(-1)).float().mean())
    print(f"[serve] logits {tuple(logits[0].shape)} finite; cuda == torch_ref "
          f"on the card for all {REQUESTS} requests (argmax agreement "
          f"{agree:.3f}); cuda == CPU torch_ref on a 4-image batch")
    runs["static"] = (sess, requests[0], latency(sess, requests,
                                                 LATENCY_SAMPLES))

    # Path D: letterboxed images, so conv window groups trim.
    boxed = [x.clone() for x in requests]
    for x in boxed:
        x[:, cfg.img // 2:] *= 0.02
    dyn = repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=True),
                              mode="serve_packed", backend="cuda",
                              params=params, device="cuda")
    logits, all_launches["D"], _ = serve(
        "D", dyn, boxed,
        {"bitserial_conv_dynamic": convs, "bitserial_matmul_dynamic": fcs})
    dyn_ref = repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=True),
                                  mode="serve_packed", backend="torch_ref",
                                  params=params, device="cuda")
    for x, y in zip(boxed, logits):
        check(torch.equal(y, sess.classify(x)),
              "path D logits differ from the static path's")
        check(torch.equal(y, dyn_ref.classify(x)),
              "path D logits differ from a torch_ref path D session's")
    with recorded_calls() as calls:
        dyn.classify(boxed[0])
    means = [f"{c.name} {float(args[2].float().mean()):.3f}"
             for c, (_, args, _) in zip(
                 cfg.convs, [k for k in calls
                             if k[0] == "bitserial_conv_dynamic"])]
    print(f"[serve] path D logits == static == torch_ref path D on all "
          f"{REQUESTS} requests; mean activation plane count per window "
          f"group (Pa = 8): {', '.join(means)}")
    runs["D"] = (dyn, boxed[0], latency(dyn, boxed, LATENCY_SAMPLES // 2))

    # Path W: filter-group-skewed weights; the launches follow the counts.
    wparams = skewed_params(cfg)
    wsess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed", backend="cuda",
                                params=wparams, device="cuda")
    expect = {}
    for (name, kind), lp in wsess.plan.layers.items():
        trimmed = min(lp.w_group_counts) < lp.w_bits
        kname = {("conv", True): "bitserial_conv_wgroup",
                 ("conv", False): "bitserial_conv",
                 ("linear", True): "bitserial_matmul_dynamic",
                 ("linear", False): "bitserial_matmul"}[kind, trimmed]
        expect[kname] = expect.get(kname, 0) + 1
        print(f"[serve] path W {name} weight plane counts per group of "
              f"{lp.w_group}: {list(lp.w_group_counts)} -> {kname}")
    check(expect == {"bitserial_conv_wgroup": 3,
                     "bitserial_matmul_dynamic": 1, "bitserial_matmul": 1},
          f"path W counts route to {expect}")
    logits, all_launches["W"], _ = serve("W", wsess, requests, expect)
    untrimmed = repro_torch.compile(cfg, uniform_policy(8, 8, w_group=0),
                                    mode="serve_packed", backend="cuda",
                                    params=wparams, device="cuda")
    for x, y in zip(requests, logits):
        check(torch.equal(y, untrimmed.classify(x)),
              "path W logits differ from the untrimmed (w_group=0) path's")
    print(f"[serve] path W logits == untrimmed static on all {REQUESTS} "
          f"requests")
    runs["W"] = (wsess, requests[0], latency(wsess, requests,
                                             LATENCY_SAMPLES // 2))

    # Composition: path D on path W's weights.
    both = repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=True),
                               mode="serve_packed", backend="cuda",
                               params=wparams, device="cuda")
    reset_launches()
    y = both.classify(boxed[0])
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["bitserial_conv_dynamic"] == convs
          and launches["bitserial_matmul_dynamic"] == fcs,
          f"composition launches {launches}")
    check(torch.equal(y, untrimmed.classify(boxed[0])),
          "path D on skewed weights differs from the static logits")
    print(f"[serve] composition (path D on path W's weights) == static "
          f"logits; launches {launches}")
    return dict(runs=runs, launches=all_launches)


def _packed_bytes(wp: torch.Tensor, counts, bn: int) -> int:
    """Bytes of the packed operand that the counts need: column j reads
    min(count, Pw) planes of K/8 bytes."""
    pw, k8, n = wp.shape
    if counts is None:
        return wp.numel()
    per_col = torch.repeat_interleave(counts.to(torch.int64).clamp(1, pw),
                                      bn)[:n]
    return int(per_col.sum().item()) * k8


def _library(name: str, args: tuple, kw: dict, out: torch.Tensor):
    """One PyTorch call computing the same function, checked equal to the
    kernel's output ``out``: torch._int_mm for K1/K3 (on the untrimmed
    operand), an fp32 cuDNN conv (exact: every partial sum fits a float32 mantissa)
    for K2/K4/K5; None where it does not apply."""
    x = args[0]
    if name in ("bitserial_matmul", "bitserial_matmul_dynamic"):
        wp = args[1]
        if wp.shape[0] > 8:
            return None
        # Untrimmed: equal to K3 where the counts are the OR-tree's.
        m, n = x.shape[0], wp.shape[2]
        w8 = bitpack.unpack_weights(wp, wp.shape[0]).to(torch.int8)
        w8 = F.pad(w8, (0, (-n) % 8)).contiguous()      # _int_mm: N % 8 == 0
        x8 = F.pad(x, (0, 0, 0, max(32, -(-m // 8) * 8) - m)).contiguous()
        check(torch.equal(torch._int_mm(x8, w8)[:m, :n], out),
              f"torch._int_mm disagrees with {name}")
        return lambda: torch._int_mm(x8, w8)
    kernel, stride, c = kw["kernel"], kw.get("stride", 1), x.shape[3]
    kkc = kernel * kernel * c
    if name == "bitserial_conv_dynamic":
        wq, bits = args[1][:kkc].to(torch.int32), 8
    else:
        wp = args[1]
        bits = wp.shape[0]
        wq = bitpack.unpack_weights(wp, bits, k=kkc)
        if name == "bitserial_conv_wgroup":
            wq = truncate_columns_grouped(wq, args[2], kw["w_group"])
    if not conv_accum_fits_f32(kkc, 8, bits):
        return None
    xf = x.float().permute(0, 3, 1, 2)
    wf = wq.float().reshape(kernel, kernel, c, -1).permute(3, 2, 0, 1)
    wf = wf.contiguous()

    def conv():
        return F.conv2d(xf, wf, stride=stride, padding=kernel // 2)
    check(torch.equal(conv().permute(0, 2, 3, 1).to(torch.int32), out),
          f"fp32 cuDNN conv disagrees with {name}")
    return conv


def _work(name: str, args: tuple, kw: dict, out: torch.Tensor) -> tuple:
    """(bytes, operations) of one call: each input read once (packed
    planes only up to the counts), the int32 output written once; one
    multiply-add (2 operations) per term."""
    x = args[0]
    if name.startswith("bitserial_matmul"):
        counts = args[2] if name.endswith("dynamic") else None
        nbytes = x.numel() + _packed_bytes(args[1], counts, kw.get("bn", 1))
        depth = x.shape[1]
    else:
        depth = kw["kernel"] ** 2 * x.shape[3]
        if name == "bitserial_conv_dynamic":
            nbytes = x.numel() + args[1].numel()
        else:
            counts = args[2] if name == "bitserial_conv_wgroup" else None
            nbytes = x.numel() + _packed_bytes(args[1], counts,
                                               kw.get("w_group", 16))
    if len(args) > 2:
        nbytes += args[2].numel() * 4                  # the counts
    return nbytes + out.numel() * 4, 2 * out.numel() * depth


def phase_timing(runs: dict, errs: dict) -> dict:
    """Per (kernel, path): kernel, plain and library ms and the bound,
    summed over the kernel's calls in one request of that path."""
    rows = {}
    for path, (sess, x, _) in runs.items():
        with recorded_calls() as calls:
            sess.classify(x)
        torch.cuda.synchronize()
        for i, (name, args, kw) in enumerate(calls):
            spec = KERNELS[name]
            plain_kw = {k: v for k, v in kw.items() if k != "rows_per_band"}

            def kernel(spec=spec, args=args, kw=kw):
                return spec["fn"](*args, **kw)

            def plain(spec=spec, args=args, kw=plain_kw):
                return spec["plain"](*args, **kw)
            out, want = kernel(), plain()
            errs[name] = max(errs[name], max_err(out, want))
            check(torch.equal(out, want),
                  f"{name} differs from plain at path {path}'s operands")
            nbytes, ops = _work(name, args, kw, out)
            lib = _library(name, args, kw, out)
            t_kernel, t_plain = cuda_ms(kernel), cuda_ms(plain, iters=10)
            t_lib = cuda_ms(lib) if lib is not None else None
            r = rows.setdefault((name, path), dict(
                ms=0.0, plain_ms=0.0, bytes_s=0.0, ops_s=0.0,
                library_ms=0.0, library=True))
            r["ms"] += t_kernel
            r["plain_ms"] += t_plain
            r["bytes_s"] += nbytes / HBM_BYTES_PER_S
            r["ops_s"] += ops / INT8_OPS_PER_S
            if t_lib is None:
                r["library"] = False
            else:
                r["library_ms"] += t_lib
            bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
            shapes = " ".join(f"{tuple(a.shape)}" for a in args)
            opts = " ".join(f"{k}={v}" for k, v in kw.items())
            print(f"[timing] path {path} call {i} {name} {shapes} {opts}: "
                  f"kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms, "
                  f"library {'n/a' if t_lib is None else f'{t_lib:.4f} ms'}, "
                  f"bound {bound:.5f} ms ({nbytes} B, {ops} op)")
    for (name, path), r in rows.items():
        print(f"[timing] path {path} {name} per request: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms'] if r['library'] else 'n/a'}, bound "
              f"{max(r['bytes_s'], r['ops_s']) * 1e3:.5f} ms")
    return rows


class _OpCount(TorchDispatchMode):
    """Counts the PyTorch operators dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def phase_profile(label: str, sess, x, request_s: float, launches: int,
                  requests: int = 4) -> None:
    """Host operators per request, device time by kernel over a few
    requests (torch.profiler), and the device's idle share of the
    unprofiled median request latency."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with _OpCount() as count:
        sess.classify(x)
    print(f"[profile] path {label}: {count.ops} PyTorch operators dispatched "
          f"per request, beside its {launches} kernel launches")
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
        print(f"[profile] path {label}: the profiler recorded no device "
              f"time: not measured")
        return
    print(f"[profile] path {label}: device busy {busy_ms:.4f} ms per request "
          f"of {request_s * 1e3:.4f} ms (idle share "
          f"{1 - busy_ms / (request_s * 1e3):.3f}), {requests} requests")
    for t, key in per_kernel[:12]:
        print(f"[profile] path {label} {t / 1e3:.4f} ms/request  {key[:90]}")


def main() -> None:
    # The fp32 conv yardstick runs in full fp32, not TF32 (cuDNN's default).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name, count = phase_device()
    phase_build()
    errs = {k: 0 for k in KERNELS}
    phase_kernels(errs)
    served = phase_serve()
    rows = phase_timing(served["runs"], errs)
    for label, (sess, x, request_s) in served["runs"].items():
        phase_profile(label, sess, x, request_s,
                      sum(served["launches"][label].values()) // REQUESTS)
    kernels = []
    for kname, spec in KERNELS.items():
        path = spec["path"]
        r = rows[kname, path]
        by_bytes = r["bytes_s"] >= r["ops_s"]
        kernels.append({
            "name": kname, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "path": path,
            "launches": served["launches"][path][kname],
            "launches_by_path": {p: n[kname]
                                 for p, n in served["launches"].items()
                                 if n[kname]},
            "max_abs_err": errs[kname], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_s"], r["ops_s"]) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": r["library_ms"] if r["library"] else None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
