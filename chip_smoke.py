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

The LM, qwen3-1.7b at full width and depth (``repro_torch.compile(qwen3,
uniform_policy(8, 8), mode="serve_packed")``, random weights from seed 0,
B = 2 prompts of S = 512 tokens from seed 1, 32 greedy tokens): K1 on every
linear, 7 per layer and the head; a ``dynamic_a`` prefill runs K3 on every
linear instead (transposed). And the op entry points of K6 and K7,
``ops.quantize_activations`` and ``ops.attention``, on the LM's own layer-0
operands (the "ops" path).

Phases (each prints its own lines; any failure raises and exits non-zero):

1. device  -- the card's name, count and nvidia-smi power limit; no CUDA
              device means exit 1.
2. build   -- compile every kernel from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, in parallel), print ptxas usage and
              the tensor-core instructions (HMMA/IMMA/HGMMA/IGMMA) in each
              kernel's SASS (``cuobjdump`` beside nvcc); fail where a
              kernel of K1-K5 has no IMMA (K2 and K4 launch the conv
              kernel's packed-plane instantiations, K5 its dense one) or
              the conv library holds another kernel, and print each one's
              registers, static shared memory and spills.
3. kernels -- K1-K6 against their plain versions on the card, exact
              (``torch.equal``), at the paths' shapes and at ragged, banded,
              strided, K-padded, chunked and odd-batch shapes; K1 on both sides of its skinny/
              tile boundary (M 1-1024) at the LM's shapes, Pw 1-16, and on
              an int32 sum that wraps; K3-K5 with random plane counts
              (forced truncation), full counts and all-1 counts; K3 on both
              routes at bn 12/16/256 and Pw 8/11/16, and on K1's wrapping
              sum; K2, K4 and K5 at conv1-3 (B 256; K4 also B 2), ragged
              N 40 and 10, stride 2, k 1/5, a chunked K of 4608 and B 3 at
              conv3 (blocks of two images, the last one short); K2 and K5
              beside their band-local oracles; the conv kernel's shared-
              memory mirror against the built kernel's own sum; K6 with
              zero, 2e-38 and subnormal groups. K7 within K7_TOL of its plain version taken
              in float32 from the same inputs (bf16: one bf16 ulp, 2^-7 of
              the value, plus 1e-4; f32: 2e-5, the JAX tests' own), bf16
              and f32 at D 32-256, S 1-4096, causal, non-causal and window
              1024, and [1, 16, 4096, 128] bf16.
4. serve   -- each CNN path serves REQUESTS batches of BATCH images with
              the launch counts reset just before; the counts must show the
              path's kernels and no other. Static: logits equal a
              ``torch_ref`` session's on the same card and a CPU session's
              on a small batch; LATENCY_SAMPLES requests one at a time
              give the latency's median and p90. D (letterboxed images,
              the bottom half scaled by 0.02): logits equal the static
              session's and a ``torch_ref`` D session's. W: logits equal
              the same weights served untrimmed (``w_group=0``).
              Composition: D on W's weights equals the static logits.
   lm      -- ``generate`` of LM_GEN tokens with the counts reset just
              before (K1 197 times per prefill and per decode step, nothing
              else); prefill and every decode step's logits equal a
              ``torch_ref`` session's bit for bit, and the tokens too;
              ``dynamic_a`` prefill (K3) equals the static one, and its
              median wall time; prefill ms, decode ms/token (a loop of
              its own after the checks),
              tokens/s and peak memory. Then the ops path on layer 0's
              operands as one ``prefill`` hands them on: K6 on the FFN's
              inputs equals its plain version, K7 on the head-repeated
              q/k/v is within K7_TOL of the port's ``chunked_attention`` in
              float32.
   int8    -- ``serve_int8`` (the bit-parallel LM_8b route: int8 weights,
              ``torch._int_mm`` per linear, ``int_conv_same`` in float32
              per conv) beside ``serve_packed``, seed-0 weights, (8, 8).
              CNN: the REQUESTS requests of BATCH images, no kernel of the
              port launched, logits equal ``serve_packed``'s and a CPU
              ``serve_int8`` session's on request 0; fused == im2col
              (``conv_route="im2col"``) in both modes on request 0, K1 at
              the im2col route's shapes == plain; images/s, latency median
              and p90, device busy and idle, operators per request, both
              modes. LM (phase_lm's prompts): prefill and all LM_GEN - 1
              decode steps' logits equal ``serve_packed``'s; prefill ms,
              decode ms/step, peak memory and weight bytes of both (their
              device busy times in phase 6).
   engine  -- the continuous-batching engine on the full LM (phase_lm's
              ``cuda`` and ``dynamic_a`` sessions):
              ``BatchingEngine(max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ)``
              serves ENGINE_REQUESTS requests (prompt j: 96 + 64 j tokens
              from numpy seed 2 + j, ENGINE_GEN tokens each) submitted one
              step apart, the counts reset just before: every stream equals
              a solo batch-1 ``generate`` over ENGINE_SEQ cache slots and
              every batched decode row's logits equal the solo run's at the
              same step (``torch.equal``; a difference reruns the traffic
              traced at the first differing row's step and names the first
              op whose row differs from the solo run's, then fails);
              K1 197 times per prefill and per decode step, nothing else.
              The same traffic through ``compile(..., guarded=True)``, a
              ``ServingSupervisor`` and the decode watchdog equals it with
              ``fallback_report() == {}``; K1 is then called again on the
              operands of each distinct shape that run gave it and held
              against its plain version (K3 likewise after the
              ``dynamic_a`` run). Chaos: an ``engine.step_stall``
              past the watchdog's deadline and a ``backend.op``
              ``TransientWorkerError`` in a decode each restart once and
              replay to the solo streams. ``dynamic_a``: 3 requests in 2
              slots equal their solo runs and the static tokens (K3 197
              times per prefill and step). The serve CLI runs in three
              subprocesses (``--server 3 --batch 2``, a solo ``--batch 1``
              and ``--mode serve_int8 --batch 1``): exit 0, row 0 equal.
              Prints tokens/s, latency and queue-wait percentiles,
              occupancy, steps, restarts, the median engine step and peak
              memory, beside the card's name and power limit.
   integrity -- the second half of the serving runtime on the same full LM
              and the engine phase's first INTEGRITY_REQUESTS requests,
              one line per check: (1) the seconds of the compile-time
              fingerprint and of one ``verify_integrity`` (CRC32 on the
              host), with the leaf count and bytes; (2) a guarded engine
              auditing every request (``audit_rate=1.0``, oracle
              ``torch_ref`` on the card): no divergence, streams == the
              unaudited engine's, audit lag p95, and the host-clock step
              time and request latency p95 beside an unaudited run of the
              same traffic (the replay stalls the serving thread); (3)
              ``backend.silent_corrupt`` on ``matmul_planes`` for request 0
              alone: caught, bundled to a temporary directory and replayed
              by ``replay_bundle`` on the card, one quarantine that demotes
              nothing on the card (``fallback_report()`` {}), health
              degraded, later requests clean; (4) ``save_checkpoint(
              verify=True)`` of the dense seed-0 tree and its restore (bytes,
              seconds), a newer step under ``ckpt.leaf_corrupt`` skipped by
              ``restore_latest``; (5) ``weights.bitflip`` at the tick of
              step 8 (``integrity_every=8``) healed from that checkpoint
              (streams == clean), and without ``heal_dir`` a typed failure
              of every live stream; (6) ``reload`` of a seed-1 dense tree
              mid-traffic: later tokens == a fresh seed-1 session's, the
              swap's seconds and peak memory. Every engine run holds K1
              against its plain version at each shape it gave K1.
   kvcache -- the int8 KV cache and the grouped decode routes on the same
              ``serve_packed`` weights (``gqa_decode``; ``kv_cache_bits=8``;
              with ``gqa_decode``; with ``attn_int8``): the engine phase's
              traffic on each, every stream and batched decode row equal to
              a solo run's, K1 == plain at the run's shapes, tokens equal
              to the bf16 cache's counted. Then one decode step at the
              engine's defaults (LONG_SLOTS slots of 32768, a cache filled
              directly) on the bf16 cache and each setting: time between
              CUDA events (beside the bf16 repeat route's busy time
              measured before the port dropped that route, 408.055 ms),
              host clock, device busy (torch.profiler), transient peak
              memory and pool bytes; a setting with ``gqa_decode`` held
              equal to its twin without it (one float body in the port;
              its engine streams and rows held to the twin's solo runs);
              on ``attn_int8`` layer 0's two ``int8_dot`` products held
              equal to the exact product on the host.
   archs   -- the other nine LM architectures (ARCH_DEPTHS: published
              width, the depth cut to one period or layer where one card
              or the time limit forces it), one at a time:
              ``serve_packed`` (8, 8) on seed-0 weights drawn on the
              card, ARCHS_BATCH prompts of ARCHS_PROMPT tokens (numpy
              seed 1; the VLM's image embeddings from numpy seed 3),
              ARCHS_GEN greedy tokens, the counts reset before every
              call: K1 launched ``loom_linears(cfg)`` times per prefill
              and per decode step and nothing else; every step's logits
              and the tokens equal a ``torch_ref`` twin's on the same
              packed weights; compile seconds (draw, pack, fingerprint),
              packed bytes, peak memory, prefill ms and decode ms/step
              (CUDA events). From the same draw, ``dense`` (the drawn
              tree as it is) and ``serve_int8``: a warm-up, a prefill and
              ARCHS_MODE_GEN - 1 decode steps each, no kernel of the port
              launched, dense logits finite, ``serve_int8``'s equal to
              ``serve_packed``'s at every step; their compile seconds,
              tree bytes, peaks, prefill and decode ms beside
              ``serve_packed``'s. ARCHS_ANALYZED (jamba, the VLM): the
              ``serve_packed`` prefill and decode step under
              ``launch.opanalysis`` (K1 equal to the launch counters)
              counted exactly as the world-one dry run counts them (in a
              subprocess beside the build and the kernel checks).
              deepseek-moe-16b: a ``dynamic_a`` prefill (K3 on every
              linear) equal to the static one, one decode step profiled
              (4 of its 28 layers: the dist phase's training and the
              launch phase took the time). deepseek-moe-16b and
              mamba2-370m: the engine's traffic (ARCHS_ENGINE_PROMPTS),
              every stream and batched decode row equal to its solo
              run. Then each arch's smoke config in ``dense`` on the
              card against the CPU port from the same seed-0 params
              (ARCHS_SMOKE_*: logits within 0.2, greedy tokens equal
              where the CPU's top-2 margin exceeds 0.4).
   train   -- the training path (no kernel of the port runs in it; the
              counts read 0): the flash VJP's dQ/dK/dV against autograd
              through ``chunked_attention`` (FLASH_CASES, float32 from
              bf16 inputs, FLASH_TOL) and each route's time and memory at
              [1, 16, 4096, 128] bf16; qwen3-1.7b at full width and depth
              (remat "none", B = 4 x 512 from the data pipeline, AdamW
              float32 moments): TRAIN_STEPS steps in ``dense`` and in
              ``fake_quant`` (8, 8) from seed-0 weights drawn on the card,
              finite losses and grad norms, the mean of the last three
              losses below the first; step ms (CUDA events, the first
              apart), tokens/s, ``train_mfu``, peak memory, one profiled
              step each, then AdamW alone (OPT_CALLS calls of its own after
              the steps, which run as the launcher runs them); one more
              step each under ``launch.opanalysis``, its operations, HBM
              bytes and kernels (none) equal to ``dryrun.train_counts``
              (float32 moments, as the step's), its operations three times
              the forward's (the backward counted), its eager-bound
              fraction beside ``train_mfu``; mamba2-370m
              (48 layers) and deepseek-moe-16b (4 of 28
              layers; its auxiliary loss positive) TRAIN_ARCH_STEPS steps.
   paper   -- the paper's evaluation (PAPER_*): the cycle model's Table 4
              headline and Fig 5 curve (modeled, printed as such); the
              paper CNN (256 images, numpy seed 1) profiled by Table 1's
              method through ``fake_quant`` forwards on the card, the
              activations' dynamic and the weights' per-group precisions,
              then the profiled (Pa capped at 8, Pw) policy served
              ``serve_packed``: logits equal a ``torch_ref`` twin's and a
              CPU session's (16 images), K2/K4 and K1/K3 as the recorded
              counts imply; ``dynamic_a`` equal to static with K5 and K3
              once per 7-bit subplane; ``session.dynamic_stats`` equal to
              the CPU's. qwen3-1.7b profiled per layer class on 4 x 32
              tokens, its mixed-Pw policy served (prefill of 2 x 512,
              PAPER_GEN - 1 decode steps): every step's logits and tokens
              equal ``torch_ref``'s, K1 + K3 197 times per call, prefill and
              decode ms (CUDA events), packed against dense bytes, the
              logits' correlation to the dense model's. The plane-width
              engine at layer 0's q projection (PAPER_ENGINE_CASES) equal
              to ``reference_int_matmul``, and at (8, 8) to ``_int_mm`` and
              K1, with its times beside theirs. The three examples'
              ``main(device="cuda")``. Wall time and peak memory.
   dist    -- serving on a ("data", "model") mesh (DIST_*): world size 1
              on NCCL at (1, 1) in this process, then ranks spawned on the
              one card over gloo: (1, 2), (2, 2), and deepseek-moe-16b's
              first 4 layers at (1, 4) (16 experts a rank). qwen3-1.7b at
              published width and depth, phase_lm's prompts, a prefill and
              DIST_STEPS decode steps: every rank's logits equal the
              unsharded session's rows, K1 once per Loom linear and step
              on every rank and nothing else, a ``dynamic_a`` prefill (K3)
              equal to them; every K1 / K3 call at its shard shape held
              against its plain version. A dense checkpoint (published
              width, 2 layers) restored with ``shardings=`` onto (1, 2)
              equals the unsharded restore's slices. Per mesh and rank:
              prefill and decode ms (CUDA events), peak memory, launches,
              the collectives by kind. Then the same worlds train
              (DIST_TRAIN_*: ``jit_train_step``, qwen3-1.7b at published
              width and DIST_TRAIN_LAYERS layers on (1, 2) ``dense`` and
              ``fake_quant`` and on (2, 2)
              ``dense``, the deepseek cut on (1, 4)): the first step's
              loss and grad norm within DIST_LOSS_RTOL and DIST_NORM_RTOL
              of the unsharded ones (this process's loss and gradients on
              the card; the (1, 1) NCCL mesh's within them too), every
              loss and grad norm finite, no
              kernel of the port launched; per rank step ms (CUDA
              events), peak memory (beside the global batch's) and the collectives
              of a step by kind and bytes; each rank is handed only its
              rows of every batch. Then the train CLI (CLI_*) on the
              2-rank world's (2, 1) mesh against the CLI at a world of
              one, and resumed from its checkpoint.
   launch  -- launch analysis (LAUNCH_*): phase_lm's cuda session runs
              one prefill (its prompts, int32) and one decode step (the
              position the int ``generate`` passes) under
              ``launch.opanalysis`` on the card: operations by type, HBM
              bytes, the kernels counted by kind (K1 once per Loom linear,
              equal to the launch counters), the tracked peak beside
              ``torch.cuda.max_memory_allocated``, the steps' time between
              CUDA events (median of LAUNCH_TIMED, the cache made before
              the timed calls) and two fractions of it, both bounds on
              the H100 datasheet constants: the eager bound (the
              analyzer's count of the unfused program this step runs)
              and the ideal bound (``dryrun.ideal_bounds`` at a world of
              one: the model's products at the bf16 peak, or its weights
              and cache read once). The same two steps traced by the dry run at a
              world of one (fake tensors, ``torch_ref``, extrapolated from
              one and two layer groups) must count the same operations,
              bytes and kernels exactly. Then LAUNCH_CELLS traced on a
              fake world of 256 ranks in a subprocess (started before
              the dist phase, host work only), one line a cell.
   reports -- the paper's reports as the port's entry points
              (``repro_torch.reports``): Table 1's method (profiles at
              tolerance 0.02, then the dynamic statistics at group 256;
              float64 forwards) on the card and on the CPU from the same
              torch-drawn params: the two profiles equal layer by layer,
              the dynamic means and plane fractions equal as the report
              prints them; both devices' metrics at every deciding width
              beside their floors; the card's seconds. Tables 2 and 4
              and Figures 4 and 5 printed once (MODELED; Figure 5's
              assertion holds). The roofline report over the launch
              cells' records: each row's terms equal its record's as
              ``fmt_ms`` formats them, one row per record.
5. timing  -- each kernel at the operands its path gave it (CUDA events,
              launched from Python and, for the device's time alone,
              replayed from a CUDA graph), beside its plain version, one
              PyTorch library call
              computing the same function, and its bound: the larger of
              bytes / 3.35 TB/s and operations over the H100 SXM peak of
              their type (int8 1979 TOP/s, bf16 989 TFLOP/s, f32 67
              TFLOP/s). K1 at the LM's shapes (layer 0 and the head, in
              prefill and decode), K3 at the ``dynamic_a`` prefill's. K7
              also at [1, 16, 4096, 128] (causal, windowed) and [1, 16,
              32768, 128] causal, the last held against the port's
              ``chunked_attention`` in float32. Each line also names the
              kernel's time in the parent (BEFORE_MS).
6. profile -- per CNN path and for the LM's prefill, decode step,
              ``serve_int8`` prefill and decode step (one request each),
              ``dynamic_a`` prefill and one engine step at full occupancy
              (ENGINE_BATCH requests decoding): the PyTorch operators one request
              dispatches on the host, device time by kernel
              (torch.profiler), and the device's idle share of the
              unprofiled median request time.

The second-to-last line is one JSON object ``{"kernels": [...]}`` with per
-request totals (ms per request of its path: a classify of BATCH images,
or one pass of the ops path) on each kernel's path; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.api import backend as backend_module  # noqa: E402
from repro_torch.api import guards  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.core import bitpack, integrity, quantize as q  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    LayerPrecision, PrecisionPolicy, uniform_policy)
from repro_torch.core.weightgroups import truncate_columns_grouped  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.bitserial_conv import (  # noqa: E402
    band_geometry, bitserial_conv, bitserial_conv_dynamic,
    bitserial_conv_dynamic_plain, bitserial_conv_plain, bitserial_conv_wgroup,
    bitserial_conv_wgroup_plain, conv_tc_chunk, conv_tc_layout,
    conv_tc_layout_bytes)
from repro_torch.kernels.bitserial_matmul import (  # noqa: E402
    _route, bitserial_matmul, bitserial_matmul_dynamic,
    bitserial_matmul_dynamic_plain, bitserial_matmul_plain)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.dynamic_quant import (  # noqa: E402
    dynamic_quant, dynamic_quant_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.ops import conv_accum_fits_f32  # noqa: E402
from repro_torch.kernels.work import (  # noqa: E402
    BF16_FLOPS, HBM_BYTES_PER_S, work)
from repro_torch.launch import dryrun, opanalysis, shapes  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import cnn, layers as L, model as M  # noqa: E402
from repro_torch.models import moe, ssm  # noqa: E402
from repro_torch.reports import (  # noqa: E402
    fig4, fig5, roofline, table1, table2, table4)
from repro_torch.runtime import faults  # noqa: E402
from repro_torch.runtime.audit import replay_bundle  # noqa: E402
from repro_torch.runtime.batching import BatchingEngine, KVPool  # noqa: E402
from repro_torch.runtime.serving import (  # noqa: E402
    DEGRADED, HEALTHY, ServingSupervisor)
from repro_torch.runtime.supervisor import TransientWorkerError  # noqa: E402

BATCH = 256
REQUESTS = 8
LATENCY_SAMPLES = 100
CSRC = "src/repro_torch/kernels/csrc"
LM_BATCH, LM_PROMPT, LM_GEN = 2, 512, 32
# The engine phase: ENGINE_REQUESTS requests into ENGINE_BATCH slots of a
# pool of ENGINE_SEQ cache slots; request j's prompt has 96 + 64 j tokens
# (numpy seed 2 + j), and it asks for ENGINE_GEN tokens.
ENGINE_BATCH, ENGINE_SEQ, ENGINE_GEN, ENGINE_REQUESTS = 4, 448, 24, 6
CHAOS_GEN, CHAOS_STEP_TIMEOUT_S, CHAOS_STALL_S = 8, 2.0, 2.5
# The integrity phase serves the engine phase's first INTEGRITY_REQUESTS
# requests (ENGINE_GEN tokens each).
INTEGRITY_REQUESTS = 3
# K7 against its plain version taken in float32 from the same inputs (bf16
# widens exactly): (atol, rtol) by input dtype. The kernel works in float32
# and rounds a bf16 output once, by at most half a bf16 ulp (2^-8 of the
# value): bf16 is held to one ulp, 2^-7, plus 1e-4 for float32 sums taken
# in another order. A tile of keys dropped, or rows left unwritten, moves
# outputs of magnitude 0.01-0.1 by more. float32: the JAX tests' 2e-5.
K7_TOL = {torch.bfloat16: (1e-4, 2 ** -7), torch.float32: (2e-5, 2e-5)}
# The JAX tests' bf16 tolerance (atol = rtol), for the library yardstick:
# scaled_dot_product_attention rounds its bf16 probabilities.
SDPA_TOL = 0.05
# Each kernel's time before K2 and K5 moved to the tensor cores (launched
# from Python, per request of its path), on an NVIDIA H100 80GB HBM3 at
# 700 W (PERF.md's table), printed beside this run's.
BEFORE_MS = {
    ("bitserial_matmul", "static"): 0.0904, ("bitserial_matmul", "W"): 0.0324,
    ("bitserial_conv", "static"): 0.4600,
    ("bitserial_matmul_dynamic", "D"): 0.0874,
    ("bitserial_matmul_dynamic", "W"): 0.0423,
    ("bitserial_conv_wgroup", "W"): 0.1549,
    ("bitserial_conv_dynamic", "D"): 0.4895,
    ("dynamic_quant", "ops"): 0.0773, ("flash_attention", "ops"): 0.0364,
    ("LM", "prefill"): 18.024, ("LM", "decode"): 8.125,
    ("LM", "dynamic_a prefill"): 18.058,
    ("long", None): 0.4072, ("long", 1024): 0.2199, ("long", 32768): 15.894,
}

# K2's and K5's shapes beyond the paths' (label, B, H, C, N, k, stride):
# ragged N (40; 10, whose int32 rows are not a multiple of 16 bytes), C =
# 512 (K = 4608, reduced in chunks) and an odd batch at conv3, whose band is
# one pixel tile (blocks of two images; the last block runs one).
ODD_CHUNKED_RAGGED = [("N=40", 8, 9, 5, 40, 3, 1), ("N=10", 8, 9, 5, 10, 3, 1),
                      ("C=512", 2, 6, 512, 40, 3, 1),
                      ("conv3 B=3", 3, 8, 64, 128, 3, 1)]

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
    "dynamic_quant": dict(
        fn=dynamic_quant, plain=dynamic_quant_plain, path="ops",
        source=f"{CSRC}/dynamic_quant.cu",
        replaces="src/repro/kernels/dynamic_quant.py:41"),
    "flash_attention": dict(
        fn=flash_attention, plain=flash_attention_plain, path="ops",
        source=f"{CSRC}/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:73"),
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


def graph_ms(fn, iters: int = 50, replays: int = 3) -> float:
    """Mean device time of ``fn`` per call without the host's launch cost:
    ``iters`` calls captured in one CUDA graph, replayed ``replays`` times
    between CUDA events (chip_kernel_times.graph_ms)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
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


def max_err(a, b):
    """Largest absolute difference (int for integer outputs); tuples of
    outputs elementwise."""
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a.is_floating_point():
        return float((a.float() - b.float()).abs().max().item())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def within(got: torch.Tensor, want: torch.Tensor, atol: float,
           rtol: float) -> bool:
    """|got - want| <= atol + rtol |want| everywhere, in float32."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= atol + rtol * w.abs()).all())


def k7_plain32(q_, k_, v_, **kw) -> torch.Tensor:
    """K7's plain version in float32 from the same inputs."""
    return flash_attention_plain(q_.float(), k_.float(), v_.float(), **kw)


def k7_hold(errs: dict, got: torch.Tensor, want: torch.Tensor,
            what: str) -> float:
    """K7's output ``got`` within K7_TOL of ``want`` (float32); returns
    the max abs err."""
    atol, rtol = K7_TOL[got.dtype]
    err = max_err(got, want)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    check(want.dtype == torch.float32 and within(got, want, atol, rtol),
          f"flash_attention {what}: outside atol {atol} + rtol {rtol} of the "
          f"float32 plain version (max abs err {err:.3g}; within the JAX "
          f"tests' 0.05: {within(got, want, SDPA_TOL, SDPA_TOL)})")
    return err


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
    """Random plane counts in [1, bits] (forced truncation), full ones and
    all 1 (the sign plane alone)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randint(1, bits + 1, shape, generator=g,
                          dtype=torch.int32).cuda(),
            torch.full(shape, bits, dtype=torch.int32, device="cuda"),
            torch.ones(shape, dtype=torch.int32, device="cuda")]


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["fn"].launches = 0


def read_launches() -> dict:
    return {name: spec["fn"].launches for name, spec in KERNELS.items()}


def _shape_key(name: str, args: tuple, kwargs: dict) -> tuple:
    """A call's kernel, operand shapes and non-tensor options."""
    return (name, tuple(tuple(a.shape) for a in args),
            tuple(sorted((k, tuple(v.shape) if isinstance(v, torch.Tensor)
                          else v) for k, v in kwargs.items())))


@contextlib.contextmanager
def recorded_calls(distinct: bool = False):
    """Yield a list that collects (kernel, args, kwargs) of every kernel
    wrapper call the backend makes inside the block (for phase 5); with
    ``distinct``, only the first call of each kernel and shape."""
    calls, seen = [], set()
    originals = {name: getattr(backend_module, name) for name in KERNELS}

    def recorder(name, fn):
        def call(*args, **kwargs):
            key = _shape_key(name, args, kwargs) if distinct else None
            if key not in seen:
                calls.append((name, args, kwargs))
                if distinct:
                    seen.add(key)
            return fn(*args, **kwargs)
        return call
    for name, fn in originals.items():
        setattr(backend_module, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(backend_module, name, fn)


def phase_device() -> tuple[str, int, str]:
    """The card's name and count, and nvidia-smi's "name, power limit"
    line (printed on its own line, and beside the engine's numbers)."""
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
    return name, count, smi[0].strip()


# Kernels that must run on the tensor cores: (library, name fragment of
# the kernel's mangled symbol) -> the kernel (K3 in every configuration of
# mm::k3_kernel; K2 and K4 in tcconv::conv_tc_kernel's packed-plane
# instantiations, Pw <= 8 and Pw > 8; K5 in its dense int8 one).
TENSOR_CORE_KERNELS = {("bitserial_matmul", "k1_kernel"): "K1",
                       ("bitserial_matmul", "k3_kernel"): "K3",
                       ("bitserial_conv", "PackedPlanes"): "K2/K4 Pw <= 8",
                       ("bitserial_conv", "WidePlanes"): "K2/K4 Pw > 8",
                       ("bitserial_conv", "DenseInt8"): "K5"}


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
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    check(cuobjdump.is_file(), "no cuobjdump beside nvcc: the SASS of the "
          "tensor-core kernels cannot be checked")
    sass = {name: sass_tensor_ops(cuobjdump, name) for name in _build.SOURCES}
    for name, kernels in sass.items():
        for kernel, found in kernels.items():
            print(f"[build] {name} SASS {kernel}: "
                  f"{found or 'no tensor-core instruction'}")
    others = [k for k in sass["bitserial_conv"] if "conv_tc_kernel" not in k]
    check(not others, f"the conv library holds kernels other than "
          f"conv_tc_kernel: {others}")
    for (lib, frag), label in TENSOR_CORE_KERNELS.items():
        usage = ptxas_usage(lib)
        found = {k: v for k, v in sass[lib].items() if frag in k}
        check(bool(found), f"{label}: no {frag} in {lib}'s SASS")
        for kernel, ops_ in found.items():
            check(ops_.get("IMMA", 0) > 0, f"{label} {kernel}: no IMMA in its "
                  f"SASS ({ops_})")
            print(f"[build] {label} {kernel}: {ops_['IMMA']} IMMA; ptxas: "
                  f"{usage.get(kernel, 'no ptxas line')}")


def ptxas_usage(name: str) -> dict:
    """Kernel -> "R registers, S bytes static shared memory, spill
    stores/loads" from the library's ``-Xptxas -v`` report (the dynamic
    shared memory is set at launch)."""
    usage, kernel = {}, None
    for line in _build.ptxas_report(name).splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
            usage[kernel] = {}
        elif kernel and "spill stores" in line:
            parts = [p.strip().split(" ")[0] for p in line.split(",")]
            usage[kernel]["spills"] = (f"{parts[1]}/{parts[2]} bytes spill "
                                       f"stores/loads")
        elif kernel and "Used" in line and "registers" in line:
            words = line.split()
            usage[kernel]["registers"] = int(
                words[words.index("registers,") - 1])
            smem = [words[i - 2] for i, w in enumerate(words)
                    if w.startswith("smem")]
            usage[kernel]["smem"] = int(smem[0]) if smem else 0
    return {k: (f"{u.get('registers')} registers, {u.get('smem', 0)} bytes "
                f"static shared memory, "
                f"{u.get('spills', 'spills not reported')}")
            for k, u in usage.items()}


def sass_tensor_ops(cuobjdump: Path, name: str) -> dict:
    """Kernel -> {tensor-core opcode: count} in the built library's SASS."""
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()
            found[kernel] = {}
        for op in ("HGMMA", "IGMMA", "HMMA", "IMMA"):
            if kernel and f" {op}." in line:
                found[kernel][op] = found[kernel].get(op, 0) + 1
                break
    return found


def _hold(errs: dict, name: str, got, want, what: str) -> None:
    errs[name] = max(errs[name], max_err(got, want))
    check(same(got, want), f"{name} {what} differs from plain")


def k1_cases() -> list:
    """(label, M, K, N, Pw) of the K1 checks: both sides of the skinny/tile
    boundary at the LM's shapes, the LM head at M = 2, the CNN's FCs and
    a ragged shape, at Pw 1/4/8/11/16."""
    lm = [(2048, 1024), (2048, 2048), (2048, 6144), (6144, 2048)]
    cases = [(f"LM K={k} N={n}", m, k, n, pw)
             for m in (1, 2, 15, 16, 17, 64, 256, 1024) for k, n in lm
             for pw in ((1, 4, 8, 11, 16) if m in (2, 16, 17, 1024) else (8,))]
    cases += [("LM head", 2, 2048, 151936, 8)]
    cases += [(label, m, k, n, pw)
              for label, m, k, n in [("fc0", BATCH, 2048, 256),
                                     ("fc1", BATCH, 256, 10),
                                     ("ragged", 7, 40, 10)]
              for pw in (1, 4, 8, 11, 16)]
    return cases


def k1_wrapping_operands(m: int, k: int = 6144, n: int = 16):
    """x = -128 (127 in every third column of row 0) against weights of
    -2^15 (2^15 - 1 in column 1) at Pw = 16: every product is about 2^22,
    so the int32 sum over K = 6144 wraps."""
    x = torch.full((m, k), -128, dtype=torch.int8)
    x[0, ::3] = 127
    wq = torch.full((k, n), -2 ** 15, dtype=torch.int32)
    wq[:, 1] = 2 ** 15 - 1
    return x.cuda(), bitpack.pack_weights(wq.cuda(), 16)


def phase_kernels(errs: dict) -> None:
    cases = k1_cases()
    for label, m, k, n, w_bits in cases:
        x, wp = operands((m, k), k, n, w_bits, seed=m + k + n + w_bits)
        got = bitserial_matmul(x, wp, w_bits=w_bits)
        torch.cuda.synchronize()
        _hold(errs, "bitserial_matmul", got,
              bitserial_matmul_plain(x, wp, w_bits),
              f"{label} M={m} K={k} N={n} Pw={w_bits} route "
              f"{_route(m, k, n, w_bits)}")
        del x, wp, got
    for m in (2, 1024):
        x, wp = k1_wrapping_operands(m)
        want = bitserial_matmul_plain(x, wp, 16)
        exact = x.double() @ bitpack.unpack_weights(wp, 16).double()
        check(bool((exact != want.double()).any()),
              "the wrapping K1 operands do not wrap")
        got = bitserial_matmul(x, wp, w_bits=16)
        torch.cuda.synchronize()
        _hold(errs, "bitserial_matmul", got, want, f"wrapping int32 M={m}")
    print(f"[kernels] K1 bitserial_matmul == plain in {len(cases) + 2} cases "
          f"(M 1/2/15/16/17/64/256/1024 at the LM's K x N, the head at M=2, "
          f"fc0/fc1 at M={BATCH}, ragged 7x40x10; Pw 1/4/8/11/16; an int32 "
          f"sum that wraps at M 2 and 1024)")
    cases = 0
    for label, b, h, c, n, kernel, stride in [
            ("conv1", BATCH, 32, 3, 32, 3, 1), ("conv2", BATCH, 16, 32, 64, 3, 1),
            ("conv3", BATCH, 8, 64, 128, 3, 1), ("k1", 8, 9, 5, 16, 1, 1),
            ("k5", 8, 9, 5, 16, 5, 1), ("k3s2", 8, 9, 5, 40, 3, 2),
            ("k5s2", 8, 9, 5, 40, 5, 2)] + ODD_CHUNKED_RAGGED:
        for w_bits in (8, 11, 16):
            x, wp = operands((b, h, h, c), kernel * kernel * c, n, w_bits,
                             seed=b + h + c + kernel + w_bits)
            want = bitserial_conv_plain(x, wp, kernel=kernel, stride=stride,
                                        w_bits=w_bits)
            banded = ref.bitserial_conv_banded_ref(
                x, wp, kernel=kernel, stride=stride, w_bits=w_bits,
                rows_per_band=3)
            check(torch.equal(banded, want), f"K2 {label}: the band-local "
                  f"oracle differs from the plain version")
            for rows in (None, 3):
                got = bitserial_conv(x, wp, kernel=kernel, stride=stride,
                                     w_bits=w_bits, rows_per_band=rows)
                torch.cuda.synchronize()
                _hold(errs, "bitserial_conv", got, want,
                      f"{label} {tuple(x.shape)} k={kernel} s={stride} "
                      f"Pw={w_bits} rows={rows}")
                cases += 1
    print(f"[kernels] K2 bitserial_conv == plain (and its band-local "
          f"oracle) in {cases} cases (conv1-3 at B={BATCH}; k 1/5, stride 2, "
          f"C=3 K-padding; N 40 and 10; C=512 chunked; B=3 at conv3; Pw "
          f"8/11/16; one band and 3-row bands)")

    # K3: path D's transposed FCs (weights [N_out, K8] x activations packed
    # at Pa = 8, one row group of 256), fc0 as path W calls it (bn 16), a
    # ragged last group; then both routes (M 10 and 1024) at bn 12 (not a
    # multiple of 8), 16 and 256, Pw 8/11/16, with every count 1, every
    # count Pw and random counts; and K1's wrapping operands at full counts.
    cases = 0
    for label, m, k, n, bits_list, bn in [
            ("D fc0", 256, 2048, BATCH, (8,), 256),
            ("D fc1", 10, 256, BATCH, (8,), 256),
            ("W fc0", BATCH, 2048, 256, (8, 11, 16), 16),
            ("ragged", 7, 40, 40, (8, 11, 16), 16)] + [
            (f"bn {bn}", m, 2040, 520, (8, 11, 16), bn)
            for m in (10, 1024) for bn in (12, 16, 256)]:
        for bits in bits_list:
            x, wp = operands((m, k), k, n, bits, seed=m + k + bits + bn)
            for counts in count_cases((-(-n // bn),), bits, seed=n + bits):
                got = bitserial_matmul_dynamic(x, wp, counts, w_bits=bits,
                                               bn=bn)
                torch.cuda.synchronize()
                _hold(errs, "bitserial_matmul_dynamic", got,
                      bitserial_matmul_dynamic_plain(x, wp, counts, bits, bn),
                      f"{label} M={m} K={k} N={n} P={bits} bn={bn} counts "
                      f"{counts.tolist()[:8]} route {_route(m, k, n, bits)}")
                cases += 1
    for m in (2, 1024):
        x, wp = k1_wrapping_operands(m)
        full = torch.full((1,), 16, dtype=torch.int32, device="cuda")
        got = bitserial_matmul_dynamic(x, wp, full, w_bits=16, bn=16)
        torch.cuda.synchronize()
        _hold(errs, "bitserial_matmul_dynamic", got,
              bitserial_matmul_plain(x, wp, 16), f"wrapping int32 M={m}")
        cases += 1
    print(f"[kernels] K3 bitserial_matmul_dynamic == plain in {cases} cases "
          f"(path D fc0/fc1 transposed at bn 256; fc0 at bn 16, Pw 8/11/16; "
          f"ragged N=40 at bn 16; M 10 and 1024 x K 2040 x N 520 at bn "
          f"12/16/256, Pw 8/11/16; random, full and all-1 counts; K1's "
          f"wrapping int32 sum at full counts, M 2 and 1024)")

    # K4: conv1-3 at B = 256 and 2, a ragged last filter group (N = 40;
    # N = 10, rows of int32 not a multiple of 16 bytes), stride 2, k 1 and
    # 5, and C = 512 (K = 4608: the chunked reduction);
    # w_group 16 and 12, Pw 8/11/16, random, full and all-1 counts, one band
    # and 3-row bands.
    cases = 0
    for label, b, h, c, n, kernel, stride in [
            ("conv1", BATCH, 32, 3, 32, 3, 1),
            ("conv2", BATCH, 16, 32, 64, 3, 1),
            ("conv3", BATCH, 8, 64, 128, 3, 1), ("conv1", 2, 32, 3, 32, 3, 1),
            ("conv2", 2, 16, 32, 64, 3, 1), ("conv3", 2, 8, 64, 128, 3, 1),
            ("N=40", 8, 9, 5, 40, 3, 1), ("N=10", 8, 9, 5, 10, 3, 1),
            ("k3s2", 8, 9, 5, 40, 3, 2),
            ("k5s2", 8, 9, 5, 40, 5, 2), ("k1", 8, 9, 8, 16, 1, 1),
            ("C=512", 2, 6, 512, 40, 3, 1)]:
        for w_bits in (8, 11, 16):
            x, wp = operands((b, h, h, c), kernel * kernel * c, n, w_bits,
                             seed=b + h + c + w_bits)
            for w_group in (16, 12):
                for counts in count_cases((-(-n // w_group),), w_bits,
                                          seed=n + w_bits + w_group):
                    want = bitserial_conv_wgroup_plain(
                        x, wp, counts, kernel=kernel, stride=stride,
                        w_bits=w_bits, w_group=w_group)
                    for rows in (None, 3):
                        got = bitserial_conv_wgroup(
                            x, wp, counts, kernel=kernel, stride=stride,
                            w_bits=w_bits, w_group=w_group,
                            rows_per_band=rows)
                        torch.cuda.synchronize()
                        _hold(errs, "bitserial_conv_wgroup", got, want,
                              f"{label} {tuple(x.shape)} k={kernel} "
                              f"s={stride} N={n} Pw={w_bits} w_group="
                              f"{w_group} rows={rows} counts "
                              f"{counts.tolist()[:8]}")
                        cases += 1
    print(f"[kernels] K4 bitserial_conv_wgroup == plain in {cases} cases "
          f"(conv1-3 at B={BATCH} and 2, N=40 and 10 ragged, stride 2, k "
          f"1/5, C=512 chunked; w_group 16/12; Pw 8/11/16; random, full and "
          f"all-1 counts; one band and 3-row bands)")

    # K5: conv1-3 at B = 256 (groups of 256, 256, 64 windows), k 1 and 5,
    # stride 2, C = 3 (K8 pads 27 to 32), and K2's ragged, chunked and
    # odd-batch shapes (groups of 16 windows, which do not divide Wo = 9;
    # 64 at conv3).
    cases = 0
    for label, b, h, c, n, kernel, stride, gsz in [
            ("conv1", BATCH, 32, 3, 32, 3, 1, 256),
            ("conv2", BATCH, 16, 32, 64, 3, 1, 256),
            ("conv3", BATCH, 8, 64, 128, 3, 1, 64),
            ("k1", 8, 9, 5, 16, 1, 1, 16), ("k5s2", 8, 9, 5, 40, 5, 2, 8),
            ("k3s2c3", 8, 9, 3, 24, 3, 2, 8)] + [
            (*case, 64 if case[0] == "conv3 B=3" else 16)
            for case in ODD_CHUNKED_RAGGED]:
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
          f"256/256/64; k 1/5, stride 2, C=3 K-padding; N 40 and 10; C=512 "
          f"chunked; B=3 at conv3; random, full and all-1 counts; one band "
          f"and 3-row bands)")

    # The shared-memory mirror the wrappers size the kernel's chunks with
    # against the built kernel's own sum, at every conv shape above.
    layouts = 0
    for h, c, kernel, stride in [(32, 3, 3, 1), (16, 32, 3, 1), (8, 64, 3, 1),
                                 (9, 5, 1, 1), (9, 5, 5, 2), (9, 3, 3, 2),
                                 (6, 512, 3, 1)]:
        ho = -(-h // stride)
        for rows in (None, 3):
            rpb = band_geometry(ho, ho, rows, kernel, stride)[0]
            for wide in (False, True):
                kc = conv_tc_chunk(h, h, c, kernel=kernel, stride=stride,
                                   rpb=rpb, wide=wide)
                mirror = conv_tc_layout(h, c, kernel=kernel, stride=stride,
                                        rpb=rpb, kc=kc, wide=wide)["bytes"]
                built = conv_tc_layout_bytes(h, c, kernel=kernel,
                                             stride=stride, rpb=rpb, kc=kc,
                                             wide=wide)
                check(mirror == built, f"conv_tc_layout {mirror} B != the "
                      f"kernel's {built} B at h={h} c={c} k={kernel} "
                      f"rpb={rpb} kc={kc} wide={wide}")
                layouts += 1
    print(f"[kernels] conv_tc_layout == the built kernel's tcconv::Layout in "
          f"{layouts} cases")

    # K6: qwen3's hidden and FFN widths at 1024 rows, the CNN's fc0 input,
    # a ragged M, bits 4 and 8; rows scaled over six decades so the
    # effective bits vary; then the groups that subnormal flushing decides.
    cases = 0
    for m, k in [(1024, 2048), (1024, 6144), (BATCH, 2048), (1000, 2048)]:
        g = torch.Generator().manual_seed(m + k)
        x = torch.randn((m, k), generator=g) * 10.0 ** (
            torch.rand((m, 1), generator=g) * 6 - 3)
        x = x.cuda()
        for bits in (4, 8):
            got = dynamic_quant(x, group_size=256, bits=bits)
            torch.cuda.synchronize()
            _hold(errs, "dynamic_quant", got,
                  dynamic_quant_plain(x, 256, bits), f"[{m}, {k}] bits={bits}")
            cases += 1
    x = edge_groups().cuda()
    for bits in (2, 4, 8):
        got = dynamic_quant(x, group_size=256, bits=bits)
        torch.cuda.synchronize()
        _hold(errs, "dynamic_quant", got, dynamic_quant_plain(x, 256, bits),
              f"edge groups bits={bits}")
        cases += 1
    print(f"[kernels] K6 dynamic_quant == plain (xq, scale, eff) in {cases} "
          f"cases ([1024, 2048], [1024, 6144], [{BATCH}, 2048], ragged "
          f"[1000, 2048]; bits 4/8; zero, 2e-38, subnormal and mixed "
          f"flushed groups at bits 2/4/8)")


def k7_cases() -> list:
    """(shape, dtype, causal, window) of the K7 checks: bf16 (tensor-core
    route) and float32 (CUDA-core route) at D 32/64/128/256, S 1/63/1000/
    4096, causal, non-causal and window 1024; and the long bf16 shapes at
    16 heads."""
    cases = [((1, 2, s_, d), dtype, causal, window)
             for dtype in (torch.bfloat16, torch.float32)
             for d in (32, 64, 128, 256) for s_ in (1, 63, 1000, 4096)
             for causal, window in ((True, None), (False, None), (True, 1024))]
    return cases + [((1, 16, 4096, 128), torch.bfloat16, True, None),
                    ((1, 16, 4096, 128), torch.bfloat16, True, 1024),
                    ((1, 16, 1000, 128), torch.bfloat16, False, None)]


def phase_k7(errs: dict) -> None:
    """K7 within K7_TOL of its plain version in float32."""
    cases = k7_cases()
    for shape, dtype, causal, window in cases:
        q_, k_, v_ = qkv(shape, dtype, seed=shape[2] + shape[3] + (window or 0))
        got = flash_attention(q_, k_, v_, causal=causal, window=window)
        torch.cuda.synchronize()
        check(got.dtype == dtype, f"flash_attention returned {got.dtype}")
        k7_hold(errs, got, k7_plain32(q_, k_, v_, causal=causal,
                                      window=window),
                f"{shape} {dtype} causal={causal} window={window}")
        del q_, k_, v_, got
    print(f"[kernels] K7 flash_attention within K7_TOL of the float32 plain "
          f"version (bf16: 1e-4 + 2^-7 |want|, f32: 2e-5 + 2e-5 |want|) in "
          f"{len(cases)} cases ([1, 2, S, D] bf16 and f32 at D 32/64/128/256,"
          f" S 1/63/1000/4096, causal, non-causal, window 1024; [1, 16, 4096,"
          f" 128] bf16 causal and window 1024, [1, 16, 1000, 128] bf16 "
          f"non-causal); max abs err {errs['flash_attention']:.3g}")


def edge_groups() -> torch.Tensor:
    """[4, 1024] f32: normal values, and in group 0 of each row a group
    that subnormal flushing decides: all zeros; all +-2e-38; a subnormal
    among zeros; 1e-36 among zeros and subnormals (its scale flushes at
    8 bits: 0 / 0 and x / 0 in one group)."""
    x = torch.randn((4, 1024), generator=torch.Generator().manual_seed(7))
    x[:, :256] = 0.0
    x[1, :256] = 2e-38
    x[1, :256:2] = -2e-38
    x[2, 3] = 1e-39
    x[3, 3], x[3, 4], x[3, 9] = 1e-36, 1e-38, -3e-39
    return x


def qkv(shape, dtype, seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).cuda() for _ in range(3)]


def skewed_params(cfg):
    """Seed-0 params with every other group of 16 output filters of every
    layer scaled by 1/32: those groups pack to fewer weight planes."""
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    for p in params.values():
        for g in range(1, -(-p["w"].shape[1] // 16), 2):
            p["w"][:, g * 16:(g + 1) * 16] /= 32
    return params


def plan_kernels(plan) -> dict:
    """The kernel each layer of a static ``serve_packed`` CNN plan
    launches, by its recorded weight-group counts: K4 on a conv whose
    counts fall below Pw, else K2; K3 on such an FC, else K1."""
    out = {}
    for (name, kind), lp in plan.layers.items():
        if kind == "linear" and (name, "conv") in plan.layers:
            continue                  # a conv's twin: no route reads it
        trimmed = lp.w_group_counts is not None and min(
            lp.w_group_counts) < lp.w_bits
        out[name, kind] = {("conv", True): "bitserial_conv_wgroup",
                           ("conv", False): "bitserial_conv",
                           ("linear", True): "bitserial_matmul_dynamic",
                           ("linear", False): "bitserial_matmul"}[kind, trimmed]
    return out


def plan_launches(plan) -> dict:
    """:func:`plan_kernels` counted: launches per request by kernel."""
    expect = {}
    for kname in plan_kernels(plan).values():
        expect[kname] = expect.get(kname, 0) + 1
    return expect


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


def latency(sess, requests: list, samples: int) -> tuple[float, float]:
    """Median and p90 of ``samples`` requests sent one at a time."""
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
    return median, lat[int(len(lat) * 0.9)]


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
                                                 LATENCY_SAMPLES)[0])

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
    runs["D"] = (dyn, boxed[0],
                 latency(dyn, boxed, LATENCY_SAMPLES // 2)[0])

    # Path W: filter-group-skewed weights; the launches follow the counts.
    wparams = skewed_params(cfg)
    wsess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed", backend="cuda",
                                params=wparams, device="cuda")
    for (name, kind), kname in plan_kernels(wsess.plan).items():
        lp = wsess.plan.layers[name, kind]
        print(f"[serve] path W {name} weight plane counts per group of "
              f"{lp.w_group}: {list(lp.w_group_counts)} -> {kname}")
    expect = plan_launches(wsess.plan)
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
                                             LATENCY_SAMPLES // 2)[0])

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


def hold_path_calls(errs: dict, calls: list, label: str) -> str:
    """Call each kernel again on the operands ``recorded_calls(distinct=
    True)`` kept from a path's run, and hold the result against its plain
    version on the same inputs (bit for bit); returns the M and N of
    each kernel's shapes held. Run after the path's launches are read."""
    ms = {}
    for name, args, kw in calls:
        spec = KERNELS[name]
        got = spec["fn"](*args, **kw)
        torch.cuda.synchronize()
        plain_kw = {k: v for k, v in kw.items() if k != "rows_per_band"}
        _hold(errs, name, got, spec["plain"](*args, **plain_kw),
              f"{label}: the path's call {_shape_key(name, args, kw)}")
        ms.setdefault(name, []).append((int(args[0].shape[0]),
                                        int(args[1].shape[-1])))
    return "; ".join(f"{name} at {len(m)} shapes, M "
                     f"{sorted({m_ for m_, _ in m})} N "
                     f"{sorted({n_ for _, n_ in m})}"
                     for name, m in ms.items())


def lm_step_launches(label: str, launches: dict, expect: dict) -> None:
    for name in KERNELS:
        check(launches[name] == expect.get(name, 0),
              f"LM {label}: {name} launched {launches[name]} times, expected "
              f"{expect.get(name, 0)}")


def lm_layer0_operands(sess, tokens) -> dict:
    """Layer 0's operands as one ``sess.prefill`` hands them on: the
    head-repeated q/k/v that ``chunked_attention`` gets ([B, S, H, D]) and
    the FFN's two inputs (the up projection's [B, S, d] and the down
    projection's [B, S, d_ff]); the q projection's input and its weight
    leaf ``"w"`` (None on a session whose linears hold no dense weight)."""
    seen = {}
    chunked, linear = attn.chunked_attention, L.linear_apply

    def chunked_attention(q_, k_, v_, **kw):
        seen.setdefault("qkv", (q_, k_, v_))
        return chunked(q_, k_, v_, **kw)

    def linear_apply(p, x, plan, layer_name="", shard=None):
        seen.setdefault(layer_name, (x, p.get("w")))
        return linear(p, x, plan, layer_name, shard)
    attn.chunked_attention, L.linear_apply = chunked_attention, linear_apply
    try:
        with torch.inference_mode():
            sess.prefill(tokens, sess.init_cache(*tokens.shape))
    finally:
        attn.chunked_attention, L.linear_apply = chunked, linear
    q_, k_, v_ = seen["qkv"]
    return dict(q=q_, k=k_, v=v_, ffn_in=seen["ffn_up"][0],
                down_in=seen["ffn_down"][0], q_in=seen["attn_q"][0],
                q_w=seen["attn_q"][1])


def lm_ops_path(o: dict) -> tuple:
    """The ops path: K6 through ``ops.quantize_activations`` on the FFN's
    two inputs, K7 through ``ops.attention`` on q/k/v as [B, H, S, D]."""
    with torch.inference_mode():
        quant = [ops.quantize_activations(
            o[key], group_size=min(256, o[key].shape[-1]), bits=8)
            for key in ("ffn_in", "down_in")]
        out = ops.attention(*(o[key].transpose(1, 2).contiguous()
                              for key in ("q", "k", "v")), causal=True)
    return quant, out


def phase_lm(errs: dict) -> dict:
    cfg = configs.get("qwen3-1.7b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).cuda()
    sessions = {be: repro_torch.compile(cfg, uniform_policy(8, 8),
                                        mode="serve_packed", backend=be,
                                        params=params, device="cuda")
                for be in ("cuda", "torch_ref")}
    dyn = repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=True),
                              mode="serve_packed", backend="cuda",
                              params=params, device="cuda")
    int8 = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                               params=params, device="cuda")
    del params
    torch.cuda.synchronize()
    sess = sessions["cuda"]
    n_lin = 7 * cfg.n_layers + 1
    max_seq = LM_PROMPT + LM_GEN
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; random bf16 weights (seed 0) "
          f"packed at (Pa, Pw) = (8, 8) for cuda, torch_ref, dynamic_a and "
          f"serve_int8 sessions in {time.perf_counter() - t0:.1f} s; prompts "
          f"{LM_BATCH} x {LM_PROMPT} (seed 1), cache {max_seq} slots")
    sess.generate(tokens, 2, max_seq=max_seq)                 # warm-up
    torch.cuda.synchronize()

    # The main path: generate, with the counts reset just before.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    gen = sess.generate(tokens, LM_GEN, max_seq=max_seq)
    gen_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    lm_step_launches("generate", launches,
                     {"bitserial_matmul": n_lin * LM_GEN})
    check(gen.shape == (LM_BATCH, LM_GEN) and gen.min() >= 0
          and gen.max() < cfg.vocab, f"generate returned {gen.shape}")
    print(f"[lm] generate {LM_GEN} tokens x {LM_BATCH}: {gen_s * 1e3:.1f} ms "
          f"(host clock, one transfer at the end), peak device memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}")

    # cuda == torch_ref, step by step.
    ref = sessions["torch_ref"]
    logits = {}
    caches = {}
    for be, s_ in sessions.items():
        caches[be] = s_.init_cache(LM_BATCH, max_seq)
        reset_launches()
        logits[be], caches[be] = s_.prefill(tokens, caches[be])
        torch.cuda.synchronize()
        if be == "cuda":
            lm_step_launches("prefill", read_launches(),
                             {"bitserial_matmul": n_lin})
    y = logits["cuda"]
    check(y.shape == (LM_BATCH, 1, cfg.vocab) and y.dtype == torch.bfloat16
          and bool(torch.isfinite(y).all()), f"prefill logits {tuple(y.shape)}")
    check(torch.equal(y, logits["torch_ref"]),
          "LM prefill logits: cuda differs from torch_ref")
    tok = torch.argmax(y[:, 0], dim=-1)
    check(torch.equal(tok.to(torch.int32).cpu(),
                      torch.from_numpy(gen[:, 0])),
          "LM prefill token differs from generate's")
    for i in range(LM_GEN - 1):
        step = {}
        for be, s_ in sessions.items():
            reset_launches()
            step[be], caches[be] = s_.decode(tok, LM_PROMPT + i, caches[be])
            torch.cuda.synchronize()
            if be == "cuda":
                lm_step_launches(f"decode {i}", read_launches(),
                                 {"bitserial_matmul": n_lin})
        check(torch.equal(step["cuda"], step["torch_ref"]),
              f"LM decode step {i} logits: cuda differs from torch_ref")
        tok = torch.argmax(step["cuda"], dim=-1)
        check(torch.equal(tok.to(torch.int32).cpu(),
                          torch.from_numpy(gen[:, i + 1])),
              f"LM decode step {i} token differs from generate's")
    print(f"[lm] cuda == torch_ref on the card: prefill logits and all "
          f"{LM_GEN - 1} decode steps' logits bit for bit, tokens identical; "
          f"K1 launched {n_lin} times per prefill and per decode step, "
          f"nothing else")

    # The timed steps: the cuda session alone, generate's work (its
    # tokens fed back) with a synchronize around each step.
    gen_dev = torch.from_numpy(gen).cuda()
    prefill_s, decode_s = [], []
    for _ in range(3):
        cache = sess.init_cache(LM_BATCH, max_seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = sess.prefill(tokens, cache)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        for i in range(LM_GEN - 1):
            t0 = time.perf_counter()
            _, cache = sess.decode(gen_dev[:, i], LM_PROMPT + i, cache)
            torch.cuda.synchronize()
            decode_s.append(time.perf_counter() - t0)
    prefill_med = sorted(prefill_s)[len(prefill_s) // 2]
    decode_med = sorted(decode_s)[len(decode_s) // 2]
    print(f"[lm] prefill {LM_BATCH} x {LM_PROMPT}: median "
          f"{prefill_med * 1e3:.3f} ms of {len(prefill_s)} "
          f"({LM_BATCH * LM_PROMPT / prefill_med:.0f} prompt tokens/s); "
          f"decode: median {decode_med * 1e3:.3f} ms/step of "
          f"{len(decode_s)} (min {min(decode_s) * 1e3:.3f}, max "
          f"{max(decode_s) * 1e3:.3f}), {LM_BATCH / decode_med:.1f} tokens/s "
          f"at batch {LM_BATCH} (host clock to synchronize); generate's "
          f"window less the median prefill: "
          f"{(gen_s - prefill_med) * 1e3 / (LM_GEN - 1):.3f} ms/step")

    # dynamic_a prefill == static, through K3; then its wall time.
    reset_launches()
    ydyn, _ = dyn.prefill(tokens, dyn.init_cache(LM_BATCH, max_seq))
    torch.cuda.synchronize()
    lm_step_launches("dynamic_a prefill", read_launches(),
                     {"bitserial_matmul_dynamic": n_lin})
    check(torch.equal(ydyn, y), "LM dynamic_a prefill differs from static")
    dyn_s = []
    for _ in range(3):
        cache = dyn.init_cache(LM_BATCH, max_seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dyn.prefill(tokens, cache)
        torch.cuda.synchronize()
        dyn_s.append(time.perf_counter() - t0)
    dyn_med = sorted(dyn_s)[len(dyn_s) // 2]
    print(f"[lm] dynamic_a prefill == static prefill bit for bit (K3 "
          f"launched {n_lin} times); dynamic_a prefill {LM_BATCH} x "
          f"{LM_PROMPT}: median {dyn_med * 1e3:.3f} ms of {len(dyn_s)} (host "
          f"clock to synchronize)")
    del ref, sessions["torch_ref"], caches, cache

    # The ops path on layer 0's operands, counts reset just before.
    o = lm_layer0_operands(sess, tokens)
    reset_launches()
    quant, out = lm_ops_path(o)
    torch.cuda.synchronize()
    ops_launches = read_launches()
    lm_step_launches("ops path", ops_launches,
                     {"dynamic_quant": 2, "flash_attention": 1})
    for key, got in zip(("ffn_in", "down_in"), quant):
        x2 = o[key].reshape(-1, o[key].shape[-1]).float()
        want = dynamic_quant_plain(x2, min(256, x2.shape[-1]), 8)
        check(same(tuple(t.reshape(want[i].shape) for i, t in enumerate(got)),
                   want), f"K6 on layer 0's {key} differs from plain")
    with torch.inference_mode():
        want = attn.chunked_attention(*(o[key].float()
                                        for key in ("q", "k", "v")),
                                      causal=True)
    k7_hold(errs, out.transpose(1, 2), want,
            "on layer 0's q/k/v against chunked_attention")
    print(f"[lm] ops path: K6 on layer 0's FFN inputs {tuple(o['ffn_in'].shape)}"
          f" and {tuple(o['down_in'].shape)} == plain; K7 on layer 0's "
          f"head-repeated q/k/v {tuple(o['q'].shape)} within K7_TOL of "
          f"chunked_attention in float32; launches "
          f"{ {k: v for k, v in ops_launches.items() if v} }")
    return dict(sess=sess, dyn=dyn, int8=int8, tokens=tokens,
                prefill_s=prefill_med,
                dyn_prefill_s=dyn_med, decode_s=decode_med, operands=o,
                gen_launches=launches, ops_launches=ops_launches, n_lin=n_lin,
                max_seq=max_seq)


def engine_prompts(cfg, n: int) -> list:
    """Request j's prompt: 96 + 64 j tokens drawn with numpy seed 2 + j."""
    return [np.random.default_rng(2 + j).integers(
        1, cfg.vocab, size=96 + 64 * j).astype(np.int32) for j in range(n)]


def solo_run(sess, prompt, gen_len: int,
             max_seq: int = ENGINE_SEQ) -> tuple:
    """A solo batch-1 ``generate`` of ``prompt`` over the pool's
    ``max_seq`` cache slots: its tokens, and the logits row behind each."""
    rows = []
    prefill, decode = sess._prefill, sess._decode

    def rec_prefill(params, tokens, cache):
        logits, cache = prefill(params, tokens, cache)
        rows.append(logits[0, 0])
        return logits, cache

    def rec_decode(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        rows.append(logits[0])
        return logits, cache
    rec = dataclasses.replace(sess, _prefill=rec_prefill, _decode=rec_decode)
    return rec.generate(prompt[None, :], gen_len, max_seq=max_seq)[0], rows


def recording_session(sess, rows: list, engine: list):
    """``sess`` whose decode records, per batched step, each active
    request's (request id, token index, logits row) of ``engine[0]``."""
    decode = sess._decode

    def recorded(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        for slot, req in engine[0].active.items():
            rows.append((req.request_id, req.n_generated, logits[slot]))
        return logits, cache
    return dataclasses.replace(sess, _decode=recorded)


def drive_engine(eng, prompts: list, gen_len: int) -> tuple:
    """Submit ``prompts`` one engine step apart, as the serve CLI does, then
    step until the engine drains. Returns (stream handles, host seconds of
    each step, kernel launches of each step)."""
    handles, step_s, step_launches = [], [], []

    def step() -> bool:
        before = sum(read_launches().values())
        t0 = time.perf_counter()
        more = eng.step()          # ends with the tokens on the host
        step_s.append(time.perf_counter() - t0)
        step_launches.append(sum(read_launches().values()) - before)
        return more
    for prompt in prompts:
        handles.append(eng.submit(prompt, gen_len))
        step()
    while step():
        pass
    return handles, step_s, step_launches


def drive_engine_admit(eng, prompts: list) -> None:
    """Submit and admit ``prompts`` one step apart, leaving them decoding
    (each asks for ENGINE_GEN tokens)."""
    for prompt in prompts:
        eng.submit(prompt, ENGINE_GEN)
        eng.step()
    check(len(eng.active) == len(prompts), "engine profile: requests not "
          "all admitted")


def diagnose_batch_variance(sess, prompts: list, max_seq: int) -> str:
    """The first op of a decode step whose row of a batch of
    ``len(prompts)`` (a pool of ``max_seq`` slots, each row a prefill)
    differs from the same row decoded alone: RMSNorm, RoPE, every linear,
    ``decode_attend``, the MoE's router product, expert products and
    output, and the SSM's decode step are traced in call order. Each
    row's batch-1 cache is prefilled again when its turn comes (a prefill
    is deterministic), so one batch-1 cache is held beside the pool."""
    n = len(prompts)
    pool = KVPool(sess, n, max_seq)
    toks = []

    def prefill(prompt):
        logits, cache1 = sess.prefill(prompt[None, :],
                                      sess.init_cache(1, max_seq))
        return int(torch.argmax(logits[0, 0])), cache1
    for b, prompt in enumerate(prompts):
        tok0, cache1 = prefill(prompt)
        pool.scatter_prefill(b, cache1)
        toks.append(tok0)
        del cache1
    pos = np.array([len(p_) for p_ in prompts], np.int32)
    tok = np.array(toks, np.int32)
    names = {"rms_norm": L, "rope": L, "linear_apply": L,
             "decode_attend": attn, "router_logits": moe, "_expert_mm": moe,
             "apply": moe, "apply_decode": ssm}
    originals = {name: getattr(mod, name) for name, mod in names.items()}

    def traced(trace):
        def wrap(name, fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                trace.append((name, args, out))
                return out
            return call
        for name, mod in names.items():
            setattr(mod, name, wrap(name, originals[name]))

    def run(trace, *args):
        traced(trace)
        try:
            sess.decode(*args)
        finally:
            for name, mod in names.items():
                setattr(mod, name, originals[name])
        torch.cuda.synchronize()
    batched = []
    run(batched, tok, pos, pool.cache)
    for b in range(n):
        alone = []
        _, cache1 = prefill(prompts[b])
        run(alone, tok[b:b + 1], int(pos[b]), cache1)
        del cache1
        for i, ((name, args, got), (_, args1, want)) in enumerate(
                zip(batched, alone)):
            row = got[b:b + 1]
            if torch.equal(row, want):
                continue
            # Every earlier op's row was equal, so this op's inputs were.
            where = f"op {i} ({name})"
            diff = (row.float() - want.float()).abs().flatten()
            first = int(torch.nonzero(diff).flatten()[0]) if \
                bool(diff.any()) else -1
            msg = (f"{where}: {name} of shape {tuple(got.shape)} (row {b}) "
                   f"differs from the batch-1 run; first differing flat "
                   f"index {first}: batched {row.flatten()[first].item()!r}"
                   f", alone {want.flatten()[first].item()!r}; max abs "
                   f"diff {diff.max().item():.3g}")
            print(f"[engine] batch variance: {msg}")
            return msg
    return "no op differs when the batch is rebuilt from prefills"


def diagnose_engine_row(sess, prompts: list, rid: int, idx: int) -> str:
    """Rerun the engine traffic of ``prompts`` (submitted one step apart,
    ENGINE_BATCH slots of ENGINE_SEQ) and request ``rid``'s solo run,
    tracing RMSNorm, RoPE, every linear and ``decode_attend`` at the decode
    step that gives request ``rid`` its token ``idx``; names the first op
    whose row differs from the solo run's, and whether its inputs were
    equal."""
    names = {"rms_norm": L, "rope": L, "linear_apply": L,
             "decode_attend": attn}
    originals = {name: getattr(mod, name) for name, mod in names.items()}
    trace, on, count, slot_at, ref = [], [False], [0], [], []

    def wrap(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if on[0]:
                trace.append((fn.__name__, [
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args], out.clone()))
            return out
        return call
    decode = sess._decode

    def solo_decode(params, token, pos, cache):
        on[0] = count[0] == idx - 1
        count[0] += 1
        try:
            return decode(params, token, pos, cache)
        finally:
            on[0] = False

    def engine_decode(params, token, pos, cache):
        hit = [slot for slot, req in ref[0].active.items()
               if req.request_id == rid and req.n_generated == idx]
        on[0] = bool(hit)
        slot_at.extend(hit)
        try:
            return decode(params, token, pos, cache)
        finally:
            on[0] = False
    for name, mod in names.items():
        setattr(mod, name, wrap(originals[name]))
    try:
        dataclasses.replace(sess, _decode=solo_decode).generate(
            prompts[rid][None, :], idx + 1, max_seq=ENGINE_SEQ)
        solo = list(trace)
        trace.clear()
        eng = BatchingEngine(dataclasses.replace(sess, _decode=engine_decode),
                             max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ)
        ref.append(eng)
        drive_engine(eng, prompts, ENGINE_GEN)
    finally:
        for name, mod in names.items():
            setattr(mod, name, originals[name])
    if not slot_at:
        return f"the step giving request {rid} token {idx} did not recur"
    b = slot_at[0]
    per_layer = len(solo) // sess.cfg.n_layers
    for i, ((name, args, got), (_, args1, want)) in enumerate(
            zip(trace, solo)):
        row = got[b:b + 1]
        if torch.equal(row, want):
            continue
        same_in = [torch.equal(x[b:b + 1], y) for x, y in zip(args, args1)
                   if isinstance(x, torch.Tensor)
                   and x.shape[:1] == got.shape[:1]]
        diff = (row.float() - want.float()).abs()
        msg = (f"op {i} ({name}, layer {i // per_layer}) of the step giving "
               f"request {rid} token {idx}: row {b} of {tuple(got.shape)} "
               f"differs from the solo run's, its batch-sized inputs equal: "
               f"{same_in}; {int((diff > 0).sum())} values differ, max "
               f"{diff.max().item():.3g}")
        print(f"[engine] batch variance: {msg}")
        return msg
    return f"no traced op differs at the step giving request {rid} token {idx}"


def phase_engine(lm: dict, card: str, errs: dict) -> dict:
    """The continuous-batching engine on the full LM (the issue's main
    path of this slice): a static run whose streams and decode logits
    equal solo generates, the same traffic guarded and supervised with
    the watchdog on (K1 held against its plain version at every shape
    the run gave it), two chaos cases, a ``dynamic_a`` run (K3 likewise),
    and the serve CLI in a subprocess."""
    t_phase = time.perf_counter()
    sess, dyn, n_lin = lm["sess"], lm["dyn"], lm["n_lin"]
    cfg = sess.cfg
    prompts = engine_prompts(cfg, ENGINE_REQUESTS)
    t0 = time.perf_counter()
    solos = [solo_run(sess, p_, ENGINE_GEN) for p_ in prompts]
    torch.cuda.synchronize()
    print(f"[engine] {card}: solo batch-1 generate of {ENGINE_REQUESTS} "
          f"prompts of {[len(p_) for p_ in prompts]} tokens (numpy seeds "
          f"2-{1 + ENGINE_REQUESTS}) x {ENGINE_GEN} tokens over "
          f"{ENGINE_SEQ} cache slots: {time.perf_counter() - t0:.2f} s")

    # The static run, with the counts reset just before.
    rows, ref = [], []
    eng = BatchingEngine(recording_session(sess, rows, ref),
                         max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ)
    ref.append(eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    handles, step_s, step_launches = drive_engine(eng, prompts, ENGINE_GEN)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    st, steps = eng.stats, eng.n_decode_steps
    lm_step_launches("engine", launches, {
        "bitserial_matmul": n_lin * (steps + ENGINE_REQUESTS)})
    check(st.n_engine_restarts == 0 and st.n_ok == ENGINE_REQUESTS,
          f"engine static run: {st.n_ok} done, "
          f"{st.n_engine_restarts} restarts")
    check(len(rows) == ENGINE_REQUESTS * (ENGINE_GEN - 1),
          f"engine recorded {len(rows)} batched rows")
    # A row's logits equal the solo run's only while its tokens so far do;
    # the first differing row of each request is the finding.
    differ = [(rid, idx) for rid, idx, row in rows
              if not torch.equal(row, solos[rid][1][idx])]
    if differ:
        cause = diagnose_engine_row(sess, prompts, *differ[0])
        check(False, f"engine: {len(differ)} of {len(rows)} batched decode "
              f"rows' logits differ from the solo run's (first: request "
              f"{differ[0][0]}, token {differ[0][1]}); {cause}")
    tokens = []
    for j, (h, (solo, _)) in enumerate(zip(handles, solos)):
        got = h.result(timeout=60.0)
        check(got.shape == (ENGINE_GEN,) and np.array_equal(got, solo),
              f"engine request {j}: stream {got.tolist()} differs from its "
              f"solo generate {solo.tolist()}")
        tokens.append(got)
    decode_only = sorted(t for t, n in zip(step_s, step_launches)
                         if n == n_lin)
    step_med = decode_only[len(decode_only) // 2]
    print(f"[engine] {card}: static run: {ENGINE_REQUESTS} requests into "
          f"{ENGINE_BATCH} slots, submitted one step apart (requests 4 and "
          f"5 queue and join mid-flight): every stream == its solo "
          f"generate, and all {len(rows)} batched decode rows' logits == "
          f"the solo run's at the same step (torch.equal); {steps} decode "
          f"steps + {ENGINE_REQUESTS} prefills, launches {launches} (K1 = "
          f"{n_lin} x {steps + ENGINE_REQUESTS})")
    print(f"[engine] {card}: static run metrics: {st.tokens_per_s:.2f} "
          f"tokens/s over the engine's busy time ({st.n_tokens_streamed} "
          f"tokens in {wall:.3f} s wall), request latency p50 "
          f"{st.p50_request_latency_s:.4f} s p95 "
          f"{st.p95_request_latency_s:.4f} s, queue wait p50 "
          f"{st.p50_queue_wait_s:.4f} s p95 {st.p95_queue_wait_s:.4f} s, "
          f"occupancy {st.batch_occupancy:.3f} of {ENGINE_BATCH}, "
          f"{steps} decode steps, {st.n_engine_restarts} restarts; one "
          f"engine step (host clock, ends with the tokens on the host): "
          f"median {step_med * 1e3:.3f} ms over {len(decode_only)} "
          f"decode-only steps (min {decode_only[0] * 1e3:.3f}, max "
          f"{decode_only[-1] * 1e3:.3f}), median "
          f"{sorted(step_s)[len(step_s) // 2] * 1e3:.3f} ms over all "
          f"{len(step_s)}; peak device memory {peak / 2**20:.1f} MiB")
    del rows

    # The same traffic guarded and supervised, decoding on the watchdog's
    # thread.
    gsess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed", backend="cuda",
                                params=sess.params, device="cuda",
                                guarded=True)
    sup = ServingSupervisor(gsess)
    geng = BatchingEngine(sup, max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ,
                          step_timeout_s=60.0)
    reset_launches()
    with recorded_calls(distinct=True) as gcalls:
        gh, gstep_s, _ = drive_engine(geng, prompts, ENGINE_GEN)
    glaunches = read_launches()
    gheld = hold_path_calls(errs, gcalls, "engine guarded")
    for j, h in enumerate(gh):
        check(np.array_equal(h.result(timeout=60.0), tokens[j]),
              f"guarded supervised engine request {j} differs from the "
              f"static run")
    check(gsess.plan.fallback_report() == {},
          f"guarded run fell back: {gsess.plan.fallback_report()}")
    check(geng.health()["state"] == HEALTHY, f"guarded run health "
          f"{geng.health()['state']}")
    lm_step_launches("engine guarded", glaunches, {
        "bitserial_matmul": n_lin * (geng.n_decode_steps + ENGINE_REQUESTS)})
    geng.drain()
    print(f"[engine] {card}: guarded + supervised run (step_timeout_s 60, "
          f"decodes on the watchdog's thread): streams == static run, "
          f"fallback_report() == {{}}, health healthy, launches "
          f"{glaunches}; == plain on the run's operands: {gheld}; median "
          f"step "
          f"{sorted(gstep_s)[len(gstep_s) // 2] * 1e3:.3f} ms")

    # Chaos: a stalled decode past the watchdog's deadline, and a worker
    # lost in a decode; each restarts and replays.
    chaos = prompts[:3]
    want = [t[:CHAOS_GEN] for t in tokens[:3]]
    cases = (
        ("engine.step_stall", BatchingEngine(
            sess, max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ,
            step_timeout_s=CHAOS_STEP_TIMEOUT_S),
         dict(delay=CHAOS_STALL_S)),
        ("backend.op", BatchingEngine(
            ServingSupervisor(gsess), max_batch=ENGINE_BATCH,
            max_seq=ENGINE_SEQ),
         dict(exc=TransientWorkerError("chaos: worker lost in a decode"),
              match="matmul_planes")))
    for point, ceng, kw in cases:
        hs = [ceng.submit(p_, CHAOS_GEN) for p_ in chaos]
        ceng.step()                  # every request admitted, one decode
        with faults.inject(point, times=1, **kw) as fault:
            ceng.run(max_steps=100)
        check(fault.fired == 1 and ceng.stats.n_engine_restarts == 1,
              f"chaos {point}: fired {fault.fired}, restarts "
              f"{ceng.stats.n_engine_restarts}")
        for j, h in enumerate(hs):
            check(np.array_equal(h.result(timeout=60.0), want[j]),
                  f"chaos {point}: request {j} differs from its solo run")
        ceng.drain()
        # The stalled call was abandoned, not stopped: wait for it to end
        # (it writes the old pool, and would count launches of later
        # phases).
        t_wait = time.monotonic() + 4 * CHAOS_STALL_S
        while any(t.name.startswith("engine-watchdog") and t.is_alive()
                  for t in threading.enumerate()):
            check(time.monotonic() < t_wait, "an abandoned stalled decode "
                  "did not end")
            time.sleep(0.05)
        torch.cuda.synchronize()
        print(f"[engine] {card}: chaos {point} ({kw}): 1 restart, "
              f"{len(hs)} streams == solo after restart-and-replay")
    check(gsess.plan.fallback_report() == {}, "chaos backend.op fell back")

    # dynamic_a: K3 on every linear, transposed.
    dprompts = prompts[:3]
    dsolo = [dyn.generate(p_[None, :], CHAOS_GEN, max_seq=ENGINE_SEQ)[0]
             for p_ in dprompts]
    deng = BatchingEngine(dyn, max_batch=2, max_seq=ENGINE_SEQ)
    reset_launches()
    with recorded_calls(distinct=True) as dcalls:
        dh, dstep_s, _ = drive_engine(deng, dprompts, CHAOS_GEN)
    dlaunches = read_launches()
    dheld = hold_path_calls(errs, dcalls, "engine dynamic_a")
    lm_step_launches("engine dynamic_a", dlaunches, {
        "bitserial_matmul_dynamic": n_lin * (deng.n_decode_steps + 3)})
    for j, h in enumerate(dh):
        got = h.result(timeout=60.0)
        check(np.array_equal(got, dsolo[j]) and
              np.array_equal(got, tokens[j][:CHAOS_GEN]),
              f"engine dynamic_a request {j} differs from its solo run or "
              f"the static engine's tokens")
    print(f"[engine] {card}: dynamic_a run (3 requests, 2 slots, "
          f"{CHAOS_GEN} tokens): streams == solo dynamic_a generate == the "
          f"static engine's; launches {dlaunches}; == plain on the run's "
          f"operands: {dheld}; median step "
          f"{sorted(dstep_s)[len(dstep_s) // 2] * 1e3:.3f} ms")
    phase_engine_cli(card)
    print(f"[engine] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, dyn_launches=dlaunches, step_s=step_med,
                prompts=prompts, tokens=tokens, solos=solos)


def phase_integrity(lm: dict, engine: dict, card: str, errs: dict) -> None:
    """The second half of the serving runtime on the full LM, with the
    engine phase's sessions and its first INTEGRITY_REQUESTS requests:
    weight fingerprints, the shadow audit (clean and against a silent
    corruption), checkpoints in the reference's format, the bitflip heal
    and a hot reload. Every engine run holds K1 against its plain version
    at every shape it gave K1."""
    t_phase = time.perf_counter()
    sess, n_lin = lm["sess"], lm["n_lin"]
    cfg, device = sess.cfg, sess.device
    prompts = engine["prompts"][:INTEGRITY_REQUESTS]
    clean = engine["tokens"][:INTEGRITY_REQUESTS]
    policy = sess.plan.policy

    def shared(guarded: bool = False):
        """A session on ``sess``'s packed weights (compile fingerprints
        them again)."""
        return repro_torch.compile(cfg, policy, mode="serve_packed",
                                   backend="cuda", params=sess.params,
                                   device=device, guarded=guarded)

    # 1. Fingerprint: the compile-time hash and one verify_integrity.
    leaves = interop.flatten_with_paths(sess.params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    t0 = time.perf_counter()
    fp = integrity.fingerprint_session(sess.params, sess.plan)
    fp_s = time.perf_counter() - t0
    check(fp == sess.fingerprint, "integrity: the fingerprint taken again "
          "differs from compile's")
    t0 = time.perf_counter()
    n = sess.verify_integrity("chip smoke")
    verify_s = time.perf_counter() - t0
    check(n == len(leaves), f"verify_integrity checked {n} of "
          f"{len(leaves)} leaves")
    print(f"[integrity] {card}: fingerprint (as compile takes it) "
          f"{fp_s:.3f} s, verify_integrity {verify_s:.3f} s: {n} leaves, "
          f"{n_bytes} bytes ({n_bytes / 2**30:.3f} GiB) hashed on the host "
          f"(CRC32, each leaf copied from the card); digest {fp.digest()}")

    # 2. Clean audit: every request replayed on torch_ref on the card,
    # beside the same traffic unaudited (the audit replays on the serving
    # thread, between steps: the steps and requests it stalls are timed).
    gsess = shared(guarded=True)
    t0 = time.perf_counter()
    runs = {}
    with recorded_calls(distinct=True) as calls:
        for rate in (0.0, 1.0):
            eng = BatchingEngine(gsess, max_batch=ENGINE_BATCH,
                                 max_seq=ENGINE_SEQ, audit_rate=rate)
            reset_launches()
            handles, step_s, _ = drive_engine(eng, prompts, ENGINE_GEN)
            launches = read_launches()
            label = f"integrity audit_rate {rate}"
            lm_step_launches(label, launches, {
                "bitserial_matmul": n_lin * (eng.n_decode_steps
                                             + len(prompts))})
            for j, (h, c) in enumerate(zip(handles, clean)):
                g = h.result(timeout=60.0)
                check(np.array_equal(g, c), f"{label}: request {j} "
                      f"{g.tolist()} differs from the engine phase's "
                      f"{c.tolist()}")
            check(eng.health()["state"] == HEALTHY, f"{label}: health "
                  f"{eng.health()['state']}")
            eng.drain()
            runs[rate] = (eng.stats, sorted(step_s), launches)
    held = hold_path_calls(errs, calls, "integrity clean audit")
    st = runs[1.0][0]
    check(st.n_audits == len(prompts) and st.n_divergences == 0
          and st.n_quarantines == 0, f"clean audit: {st.n_audits} audits, "
          f"{st.n_divergences} divergences, {st.n_quarantines} quarantines")
    cost = {rate: f"request latency p95 {r[0].p95_request_latency_s:.4f} s, "
            f"engine step (host clock) median {r[1][len(r[1]) // 2] * 1e3:.3f}"
            f" ms, max {r[1][-1] * 1e3:.3f} ms over {len(r[1])} steps"
            for rate, r in runs.items()}
    print(f"[integrity] {card}: clean audit (guarded, audit_rate 1.0, "
          f"oracle torch_ref on the card over {ENGINE_SEQ} cache slots): "
          f"{st.n_audits} audits, 0 divergences, streams == the unaudited "
          f"engine's; audit lag p95 {st.p95_audit_lag_s:.3f} s; launches "
          f"{runs[1.0][2]}; == plain on the run's operands: {held}; both "
          f"runs {time.perf_counter() - t0:.1f} s")
    print(f"[integrity] {card}: what the audit costs the traffic it stalls "
          f"({len(prompts)} requests x {ENGINE_GEN} tokens, guarded): "
          f"audit_rate 1.0: {cost[1.0]}; audit_rate 0: {cost[0.0]}")

    # 3. Silent corruption of matmul_planes for request 0 alone.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as bundles:
        sup = ServingSupervisor(gsess)
        ceng = BatchingEngine(sup, max_batch=ENGINE_BATCH,
                              max_seq=ENGINE_SEQ, audit_rate=1.0,
                              audit_bundle_dir=bundles)
        reset_launches()
        with recorded_calls(distinct=True) as calls:
            with faults.inject("backend.silent_corrupt", times=None,
                               match="matmul_planes:cuda") as fault:
                h0 = ceng.submit(prompts[0], ENGINE_GEN)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    ceng.run(max_steps=200)
            fired = fault.fired
            rest = [ceng.submit(p_, ENGINE_GEN) for p_ in prompts[1:]]
            ceng.run(max_steps=200)
        launches = read_launches()
        held = hold_path_calls(errs, calls, "integrity silent corruption")
        lm_step_launches("integrity silent corruption", launches, {
            "bitserial_matmul": n_lin * (ceng.n_decode_steps + len(prompts))})
        st = ceng.stats
        check(fired == n_lin * ENGINE_GEN, f"silent_corrupt fired {fired} "
              f"times, expected {n_lin * ENGINE_GEN}")
        check(st.n_audits == len(prompts) and st.n_divergences == 1
              and st.n_quarantines == 1, f"silent corruption: "
              f"{st.n_audits} audits, {st.n_divergences} divergences, "
              f"{st.n_quarantines} quarantines")
        check(not np.array_equal(h0.result(timeout=60.0), clean[0]),
              "silent corruption changed no token of request 0")
        for j, h in enumerate(rest, 1):
            check(np.array_equal(h.result(timeout=60.0), clean[j]),
                  f"silent corruption: request {j}, served after the "
                  f"injection ended, differs from the clean run")
        report = gsess.plan.fallback_report()
        demoted = gsess.plan.backend.quarantine("chip smoke probe",
                                                device=device)
        check(report == {} and demoted == 0
              and gsess.plan.fallback_report() == {},
              f"quarantine on the card demoted {demoted} ops, fallbacks "
              f"{report}")
        state = ceng.health()["state"]
        check(state == DEGRADED, f"silent corruption health {state}")
        paths = sorted(Path(bundles).glob("*.npz"))
        check(len(paths) == 1, f"{len(paths)} repro bundles written")
        t1 = time.perf_counter()
        b = replay_bundle(str(paths[0]))
        replay_s = time.perf_counter() - t1
        check(b["diverged"] and b["reproduced"]
              and np.array_equal(b["ref"], clean[0])
              and b["meta"]["device"] == device.type, f"bundle replay: diverged "
              f"{b['diverged']}, reproduced {b['reproduced']}, meta "
              f"{b['meta']}")
        ceng.drain()
        sup.close()
    print(f"[integrity] {card}: silent corruption (backend.silent_corrupt on "
          f"matmul_planes:cuda, {fired} dispatches = request 0 alone): "
          f"caught at position {b['meta']['diverged_at']}, 1 divergence of "
          f"{st.n_audits} audits, 1 quarantine; quarantine on the card "
          f"demotes 0 ops, fallback_report() {{}}, health degraded; "
          f"requests 1-{len(prompts) - 1} after the injection == clean; "
          f"bundle replayed on the card by replay_bundle in {replay_s:.1f} "
          f"s (reproduced, same reference tokens); K1 launched "
          f"{launches['bitserial_matmul']} times; == plain: {held}; "
          f"{time.perf_counter() - t0:.1f} s")
    del gsess, sup, ceng

    # 4. Checkpoint: the dense seed-0 tree saved (verify=True) and restored.
    with tempfile.TemporaryDirectory() as heal:
        dense = M.init_params(cfg, torch.Generator(device=device).manual_seed(
            0), device)
        t0 = time.perf_counter()
        path = ckpt.save_checkpoint(heal, 0, dense, verify=True)
        save_s = time.perf_counter() - t0
        ck_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        skel = M.param_skeleton(cfg)
        t0 = time.perf_counter()
        restored, step = ckpt.restore_checkpoint(heal, 0, skel,
                                                 device=device)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want, got_ = (interop.flatten_with_paths(t) for t in (dense,
                                                              restored))
        check(step == 0 and list(got_) == list(want) and all(
            torch.equal(got_[k], want[k]) for k in want),
              "checkpoint: restored tree differs from the saved one")
        del restored, got_, want
        with faults.inject("ckpt.leaf_corrupt", times=1):
            ckpt.save_checkpoint(heal, 1, dense)
        del dense
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            skipped, step = ckpt.restore_latest(heal, skel, device=device)
        check(step == 0 and any("corrupt" in str(w.message) for w in caught),
              f"restore_latest took step {step} past a corrupt newer step")
        del skipped
        shutil.rmtree(os.path.join(heal, "step_00000001"))
        print(f"[integrity] {card}: checkpoint of the dense seed-0 tree: "
              f"{ck_bytes} bytes ({ck_bytes / 2**30:.3f} GiB, "
              f"{len(os.listdir(path))} files), save (fsync, verify=True) "
              f"{save_s:.2f} s, restore onto the card {restore_s:.2f} s, "
              f"== the saved tree; a newer step saved under "
              f"ckpt.leaf_corrupt is skipped by restore_latest with a "
              f"warning")

        # 5. Bitflip at an integrity tick mid-traffic, healed from the
        # checkpoint; then the same without heal_dir fails loudly.
        isess = shared()
        t0 = time.perf_counter()
        heng = BatchingEngine(isess, max_batch=ENGINE_BATCH,
                              max_seq=ENGINE_SEQ, integrity_every=8,
                              heal_dir=heal)
        hs = []
        reset_launches()
        with recorded_calls(distinct=True) as calls:
            for p_ in prompts:
                hs.append(heng.submit(p_, ENGINE_GEN))
                heng.step()
            for _ in range(8 - len(prompts)):     # to the tick of step 8
                heng.step()
            with faults.inject("weights.bitflip", times=1) as fault:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    heng.run(max_steps=200)
        launches = read_launches()
        held = hold_path_calls(errs, calls, "integrity bitflip heal")
        # Each request prefilled twice: at admission, and replayed after
        # the heal's reload.
        lm_step_launches("integrity bitflip heal", launches, {
            "bitserial_matmul": n_lin * (heng.n_decode_steps
                                         + 2 * len(prompts))})
        st, heal_k1 = heng.stats, launches["bitserial_matmul"]
        check(fault.fired == 1 and st.n_reloads == 1
              and st.n_integrity_checks >= 2,
              f"bitflip heal: fired {fault.fired}, {st.n_reloads} reloads, "
              f"{st.n_integrity_checks} integrity checks")
        for j, h in enumerate(hs):
            check(np.array_equal(h.result(timeout=60.0), clean[j]),
                  f"bitflip heal: request {j} differs from the clean run")
        check(isess.fingerprint.digest() == fp.digest(),
              "bitflip heal: the weights serving after the heal are not "
              "the compiled ones (their fingerprint differs from the "
              "compile-time one)")
        heal_s = time.perf_counter() - t0
        heng.drain()
        feng = BatchingEngine(isess, max_batch=ENGINE_BATCH,
                              max_seq=ENGINE_SEQ, integrity_every=8)
        fh = [feng.submit(p_, ENGINE_GEN) for p_ in prompts]
        raised = None
        with faults.inject("weights.bitflip", times=1):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    feng.run(max_steps=200)
                except guards.WeightIntegrityError as exc:
                    raised = exc
        failed = []
        for h in fh:
            try:
                h.result(timeout=5.0)
            except guards.WeightIntegrityError:
                failed.append(h)
        check(raised is not None and len(failed) == len(fh),
              f"bitflip without heal_dir: raised {raised!r}, "
              f"{len(failed)} of {len(fh)} streams failed with it")
    print(f"[integrity] {card}: bitflip (weights.bitflip at the tick of step "
          f"8, integrity_every 8, {st.n_integrity_checks} checks) caught and "
          f"healed by reload_checkpoint: 1 reload, every stream == the clean "
          f"run, the healed weights' fingerprint == the compile-time one "
          f"{fp.digest()}; {heal_s:.1f} s; K1 "
          f"launched {heal_k1} times; == plain: {held}; without heal_dir the engine raised "
          f"WeightIntegrityError and all {len(fh)} live streams failed with "
          f"it")
    del isess, heng, feng

    # 6. Hot reload of a seed-1 dense tree in memory, mid-traffic.
    dense1 = M.init_params(cfg, torch.Generator(device=device).manual_seed(1),
                           device)
    sess1 = repro_torch.compile(cfg, policy, mode="serve_packed",
                                backend="cuda", params=dense1, device=device)
    want1 = [sess1.generate(p_[None, :], ENGINE_GEN, max_seq=ENGINE_SEQ)[0]
             for p_ in prompts]
    reng = BatchingEngine(shared(), max_batch=ENGINE_BATCH,
                          max_seq=ENGINE_SEQ)
    rh = []
    reset_launches()
    with recorded_calls(distinct=True) as calls:
        for p_ in prompts:
            rh.append(reng.submit(p_, ENGINE_GEN))
            reng.step()
        pre = [len(h.tokens_so_far()) for h in rh]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_b = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        reng.reload(dense1)
        torch.cuda.synchronize()
        swap_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        reng.run(max_steps=200)
    launches = read_launches()
    held = hold_path_calls(errs, calls, "integrity hot reload")
    lm_step_launches("integrity hot reload", launches, {
        "bitserial_matmul": n_lin * (reng.n_decode_steps + 2 * len(prompts))})
    for j, (h, n_pre) in enumerate(zip(rh, pre)):
        got1 = h.result(timeout=60.0)
        check(0 < n_pre < ENGINE_GEN
              and np.array_equal(got1[:n_pre], clean[j][:n_pre])
              and np.array_equal(got1[n_pre:], want1[j][n_pre:]),
              f"hot reload: request {j} ({n_pre} tokens before the swap) "
              f"{got1.tolist()} is not the old weights' prefix and the new "
              f"weights' suffix {want1[j].tolist()}")
    check(reng.stats.n_reloads == 1 and reng.session.fingerprint.digest()
          == sess1.fingerprint.digest(), "hot reload: the fingerprint does "
          "not follow the new weights")
    reng.drain()
    print(f"[integrity] {card}: hot reload of a seed-1 dense tree after "
          f"{pre} tokens: every later token == a fresh seed-1 session's at "
          f"that position; reload {swap_s:.3f} s (serving conversion, "
          f"checks, fingerprint, {len(prompts)} replayed prefills), peak "
          f"device memory {peak / 2**30:.3f} GiB ({(peak - held_b) / 2**30:.3f}"
          f" GiB above the {held_b / 2**30:.3f} GiB held before); K1 launched "
          f"{launches['bitserial_matmul']} times; == plain: {held}")
    del dense1, sess1, reng
    print(f"[integrity] phase took {time.perf_counter() - t_phase:.1f} s")


def _busy(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _param_bytes(params) -> int:
    return sum(t.numel() * t.element_size()
               for t in interop.flatten_with_paths(params).values())


def phase_int8(lm: dict, card: str, errs: dict) -> dict:
    """``serve_int8`` (the bit-parallel LM_8b route: int8 weights, one
    exact int8 product per linear through ``torch._int_mm``, the CNN's
    convs as ``int_conv_same`` in float32) beside Loom's ``serve_packed``
    on the same card, seed-0 weights, (Pa, Pw) = (8, 8). Both routes are
    exact integer products on the same grids, so every logit must be
    equal. Returns the CNN's launch counts of the im2col packed run."""
    t_phase = time.perf_counter()
    cfg = configs.get("paper_cnn")
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    g = torch.Generator().manual_seed(1)
    requests = [torch.randn((BATCH, cfg.img, cfg.img, cfg.in_ch),
                            generator=g).cuda() for _ in range(REQUESTS)]
    modes = ("serve_packed", "serve_int8")
    sess = {(mode, route): repro_torch.compile(
        cfg, uniform_policy(8, 8), mode=mode, params=params, device="cuda",
        conv_route=route) for mode in modes for route in ("fused", "im2col")}
    expect = {"serve_packed": {"bitserial_conv": len(cfg.convs),
                               "bitserial_matmul": len(cfg.fcs)},
              "serve_int8": {}}            # no kernel of the port: _int_mm
    logits, row = {}, {}
    for mode in modes:
        s_ = sess[mode, "fused"]
        logits[mode], _, secs = serve(f"int8-phase {mode}", s_, requests,
                                      expect[mode])
        med, p90 = latency(s_, requests, LATENCY_SAMPLES // 2)
        ops_, busy = phase_profile(f"CNN {mode}",
                                   lambda s_=s_: s_.classify(requests[0]),
                                   med, sum(expect[mode].values()))
        row[mode] = (REQUESTS * BATCH / secs, med, p90, busy, ops_)
    for j, (a, b) in enumerate(zip(logits["serve_int8"],
                                   logits["serve_packed"])):
        check(torch.equal(a, b), f"CNN request {j}: serve_int8 logits "
              f"differ from serve_packed's")
    cpu = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                              params=params, device="cpu")
    check(torch.equal(logits["serve_int8"][0].cpu(),
                      cpu.classify(requests[0].cpu())),
          "CNN serve_int8 logits on the card differ from a CPU session's")
    reset_launches()
    with recorded_calls(distinct=True) as calls:
        im2col = {mode: sess[mode, "im2col"].classify(requests[0])
                  for mode in modes}
    im2col_launches = read_launches()
    check(im2col_launches["bitserial_matmul"] == len(cfg.convs) + len(cfg.fcs)
          and sum(im2col_launches.values()) == len(cfg.convs) + len(cfg.fcs),
          f"im2col launches {im2col_launches}: K1 on every conv's patches "
          f"and every FC, nothing else")
    held = hold_path_calls(errs, calls, "im2col serve_packed")
    for mode in modes:
        check(torch.equal(im2col[mode], logits[mode][0]),
              f"CNN {mode}: the im2col route differs from the fused conv")
    print(f"[int8] {card}: CNN part took {time.perf_counter() - t_phase:.1f} "
          f"s")
    print(f"[int8] {card}: CNN serve_int8 == serve_packed on all {REQUESTS} "
          f"requests x {BATCH} images (torch.equal), == a CPU serve_int8 "
          f"session on request 0; fused == im2col in both modes on request "
          f"0 (im2col serve_packed: K1 on the patches, == plain: {held})")
    for mode in modes:
        ips, med, p90, busy, ops_ = row[mode]
        idle = "not measured" if busy is None else \
            f"{1 - busy / (med * 1e3):.3f}"
        print(f"[int8] {card}: CNN {mode}: {ips:.1f} images/s, latency "
              f"median {med * 1e3:.4f} ms p90 {p90 * 1e3:.4f} ms, device "
              f"busy {_busy(busy)} per request, idle share {idle}, {ops_} "
              f"PyTorch operators per request")

    # The LM: prefill and every decode step, logits equal; each call timed
    # alone (host clock to synchronize) with its peak above what is held.
    packed, isess, tokens = lm["sess"], lm["int8"], lm["tokens"]
    max_seq = lm["max_seq"]
    pair = {"serve_packed": packed, "serve_int8": isess}
    caches = {m: s_.init_cache(LM_BATCH, max_seq) for m, s_ in pair.items()}
    times = {m: [] for m in pair}
    peaks = dict.fromkeys(pair, 0)

    def timed(mode, fn, *args):
        torch.cuda.synchronize()
        held_b = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, caches[mode] = fn(*args, caches[mode])
        torch.cuda.synchronize()
        times[mode].append(time.perf_counter() - t0)
        peaks[mode] = max(peaks[mode],
                          torch.cuda.max_memory_allocated() - held_b)
        return out
    reset_launches()
    li = timed("serve_int8", isess.prefill, tokens)
    lm_step_launches("serve_int8 prefill", read_launches(), {})
    lp = timed("serve_packed", packed.prefill, tokens)
    check(li.shape == lp.shape and bool(torch.isfinite(li).all())
          and torch.equal(li, lp), "LM serve_int8 prefill logits differ "
          "from serve_packed's")
    tok = torch.argmax(lp[:, 0], dim=-1)
    for i in range(LM_GEN - 1):
        step = {m: timed(m, s_.decode, tok, LM_PROMPT + i)
                for m, s_ in pair.items()}
        check(torch.equal(step["serve_int8"], step["serve_packed"]),
              f"LM decode step {i}: serve_int8 logits differ from "
              f"serve_packed's")
        tok = torch.argmax(step["serve_packed"], dim=-1)
    del caches
    print(f"[int8] {card}: LM serve_int8 == serve_packed: prefill logits "
          f"{LM_BATCH} x {LM_PROMPT} and all {LM_GEN - 1} decode steps' "
          f"logits bit for bit; serve_int8 launched no kernel of the port")
    medians = {}
    for mode, s_ in pair.items():
        dec = sorted(times[mode][1:])
        medians[mode] = (times[mode][0], dec[len(dec) // 2])
        print(f"[int8] {card}: LM {mode}: prefill {times[mode][0] * 1e3:.3f} "
              f"ms, decode median {dec[len(dec) // 2] * 1e3:.3f} ms/step of "
              f"{len(dec)} (host clock to synchronize, each call alone), "
              f"peak {peaks[mode] / 2**20:.1f} MiB above what was held; "
              f"weights {_param_bytes(s_.params)} B")
    print(f"[int8] phase took {time.perf_counter() - t_phase:.1f} s")
    return dict(im2col_launches=im2col_launches, lm_medians=medians)


# The KV route settings of the kvcache phase, on top of the bf16 cache's
# defaults. ``gqa_decode`` selects no route in the port (its settings run
# the same float body as without it).
KV_ROUTES = {"gqa_decode": dict(gqa_decode=True),
             "kv_cache_bits=8": dict(kv_cache_bits=8),
             "kv_cache_bits=8 + gqa_decode": dict(kv_cache_bits=8,
                                                  gqa_decode=True),
             "kv_cache_bits=8 + attn_int8": dict(kv_cache_bits=8,
                                                 attn_int8=True)}
# The engine's defaults: BatchingEngine(max_batch=8), max_seq=cfg.max_seq.
LONG_SLOTS = 8
# The bf16 repeat route's decode step there, device busy ms, as
# chip_batch_variance.py measured it when the port still repeated the KV
# heads (NVIDIA H100 80GB HBM3, 700 W; PERF.md), printed beside this
# run's.
LONG_STEP_BEFORE_MS = 408.055


def route_session(sess, change: dict):
    """``sess`` on another attention route: the same plan and weights, a
    config with ``change`` (the cache and decode options)."""
    from repro_torch.api.session import entry_points
    cfg = dataclasses.replace(sess.cfg, **change)
    return dataclasses.replace(sess, cfg=cfg, **entry_points(cfg, sess.plan))


def fill_long_cache(cfg, batch: int, seq: int) -> dict:
    """A cache of ``batch`` rows of ``seq`` slots, every slot filled
    directly (random K/V, and scales on an int8 cache; slot j holds
    position j), one layer at a time."""
    cache = M.init_cache(cfg, batch, seq, "cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    for leaves in cache.values():
        for i in range(cfg.n_groups):
            for key in ("k", "v"):
                t = leaves[key][i]
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-128, 128, t.shape, generator=g,
                                          device="cuda", dtype=torch.int8))
                else:
                    t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
            for key in ("k_scale", "v_scale"):
                if key in leaves:
                    leaves[key][i].uniform_(0.005, 0.05, generator=g)
        leaves["slot_pos"].copy_(torch.arange(seq, dtype=torch.int32,
                                              device="cuda"))
    return cache


def hold_int8_dot(rs, tok, pos, cache, label: str) -> None:
    """One decode step with ``attention.int8_dot`` recorded: layer 0's QK
    and PV products (its first two calls) on the card held equal, bit for
    bit, to the exact product on the host (float64: every sum is an
    integer below 2^53)."""
    seen = []
    real = attn.int8_dot

    def spy(a, b):
        out = real(a, b)
        if len(seen) < 2:
            seen.append((a.cpu(), b.cpu(), out.cpu()))
        return out
    attn.int8_dot = spy
    try:
        rs.decode(tok, pos, cache)
    finally:
        attn.int8_dot = real
    check(len(seen) == 2, f"{label}: int8_dot ran {len(seen)} times in "
          f"layer 0, not 2")
    shapes = []
    for name, (a, b, out) in zip(("QK", "PV"), seen):
        exact = torch.matmul(a.double(), b.double())
        check(out.dtype == torch.int32 and torch.equal(out.double(), exact),
              f"{label}: layer 0's int8_dot {name} on the card differs from "
              f"the exact product (max |diff| "
              f"{(out.double() - exact).abs().max().item()})")
        shapes.append(f"{name} {list(a.shape)} x {list(b.shape)}")
    print(f"[kvcache] {label}: layer 0's int8_dot {', '.join(shapes)} on the "
          f"card == the exact product on the host, bit for bit")


def phase_kvcache(lm: dict, engine: dict, card: str, errs: dict) -> dict:
    """The int8 KV cache and the grouped decode routes on the full LM
    (``serve_packed``, (8, 8)): the engine phase's traffic on each route,
    batched == solo and K1 == plain at its shapes; then one decode step at
    the engine's defaults (LONG_SLOTS slots of cfg.max_seq) per route,
    with a cache filled directly. Returns each route's launches."""
    t_phase = time.perf_counter()
    sess, n_lin = lm["sess"], lm["n_lin"]
    prompts, bf16_tokens = engine["prompts"], engine["tokens"]
    all_launches = {}
    # A setting with gqa_decode runs its twin's body (the port keeps one
    # float route): its batched streams and rows are held to the twin's
    # solo runs (the bf16 cache's are the engine phase's).
    twin_solos = {(): engine.pop("solos")}
    for label, change in KV_ROUTES.items():
        rs = route_session(sess, change)
        twin = tuple(sorted((k, v) for k, v in change.items()
                            if k != "gqa_decode"))
        if "gqa_decode" in change:
            solos = twin_solos[twin]
        else:
            solos = [solo_run(rs, p_, ENGINE_GEN) for p_ in prompts]
            twin_solos[twin] = solos
        rows, ref = [], []
        eng = BatchingEngine(recording_session(rs, rows, ref),
                             max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ)
        ref.append(eng)
        torch.cuda.synchronize()
        reset_launches()
        with recorded_calls(distinct=True) as calls:
            handles, step_s, _ = drive_engine(eng, prompts, ENGINE_GEN)
        launches = read_launches()
        steps = eng.n_decode_steps
        lm_step_launches(f"kvcache {label}", launches, {
            "bitserial_matmul": n_lin * (steps + ENGINE_REQUESTS)})
        held = hold_path_calls(errs, calls, f"kvcache {label}")
        differ = [(rid, idx) for rid, idx, row in rows
                  if not torch.equal(row, solos[rid][1][idx])]
        if differ:
            cause = diagnose_engine_row(rs, prompts, *differ[0])
            check(False, f"kvcache {label}: {len(differ)} of {len(rows)} "
                  f"batched decode rows differ from the solo run's (first: "
                  f"request {differ[0][0]}, token {differ[0][1]}); {cause}")
        agree = 0
        for j, (h, (solo, _)) in enumerate(zip(handles, solos)):
            got = h.result(timeout=60.0)
            check(np.array_equal(got, solo), f"kvcache {label} request {j}: "
                  f"stream differs from its solo generate")
            agree += int(np.sum(got == bf16_tokens[j]))
        eng.drain()
        all_launches[f"LM kvcache {label}"] = launches
        print(f"[kvcache] {card}: {label}: {ENGINE_REQUESTS} requests into "
              f"{ENGINE_BATCH} slots of {ENGINE_SEQ}: every stream == its "
              f"solo generate and all {len(rows)} batched decode rows' "
              f"logits == the solo run's; K1 {launches['bitserial_matmul']} "
              f"= {n_lin} x {steps + ENGINE_REQUESTS}, == plain: {held}; "
              f"tokens equal to the bf16 cache's streams: {agree} of "
              f"{ENGINE_REQUESTS * ENGINE_GEN}; median step "
              f"{sorted(step_s)[len(step_s) // 2] * 1e3:.3f} ms")
        del rows, solos, eng
    del twin_solos

    # One decode step at the engine's defaults, per setting. A setting
    # with gqa_decode runs its twin's body (the port keeps one float
    # route): its logits are held equal to the twin's, not timed again.
    # Settings with the same cache share it: each step writes the same
    # K/V into slot seq - 1.
    seq = sess.cfg.max_seq
    tok = torch.zeros(LONG_SLOTS, dtype=torch.long, device="cuda")
    pos = torch.full((LONG_SLOTS,), seq - 1, dtype=torch.int32,
                     device="cuda")
    outs, cache, bits = {}, None, None
    for label, change in [("bf16", {})] + list(KV_ROUTES.items()):
        rs = route_session(sess, change)
        if rs.cfg.kv_cache_bits != bits:
            cache = None
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            before = torch.cuda.memory_allocated()
            cache = fill_long_cache(rs.cfg, LONG_SLOTS, seq)
            torch.cuda.synchronize()
            pool_bytes = torch.cuda.memory_allocated() - before
            bits = rs.cfg.kv_cache_bits

        def step(rs=rs, cache=cache):
            return rs.decode(tok, pos, cache)[0]
        logits = step()
        twin = tuple(sorted((k, v) for k, v in change.items()
                            if k != "gqa_decode"))
        if "gqa_decode" in change:
            check(torch.equal(logits, outs[twin]), f"kvcache {label}, "
                  f"{LONG_SLOTS} slots of {seq}: the step's logits differ "
                  f"from those without gqa_decode")
            print(f"[kvcache] {card}: {label}, {LONG_SLOTS} slots of {seq}: "
                  f"the step's logits == those without gqa_decode (the "
                  f"same float body in the port; not timed again)")
            continue
        outs[twin] = logits
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - held
        times, dev = [], []
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            step()
            ev[1].record()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            dev.append(ev[0].elapsed_time(ev[1]))
        med, dev_med = sorted(times)[1], sorted(dev)[1]
        print(f"[kvcache] {card}: {label}, {LONG_SLOTS} slots of {seq}: "
              f"decode step {dev_med:.4f} ms between CUDA events (median "
              f"of 3; the bf16 repeat route's busy time, measured when the "
              f"port still had it: {LONG_STEP_BEFORE_MS} ms), host clock "
              f"median {med * 1e3:.3f} ms; pool {pool_bytes} B "
              f"({pool_bytes / 2**30:.3f} GiB), the step's transient peak "
              f"{transient / 2**30:.3f} GiB above {held / 2**30:.3f} GiB "
              f"held")
        _, busy = phase_profile(f"kvcache {label} decode step, {LONG_SLOTS} "
                                f"slots of {seq} ({card})", step, med, n_lin,
                                requests=2)
        check(busy is not None, f"kvcache {label}: the profiler recorded no "
              f"device time")
        print(f"[kvcache] {card}: {label}, {LONG_SLOTS} slots of {seq}: "
              f"device busy {busy:.4f} ms of the {dev_med:.4f} ms between "
              f"events (busy share {busy / dev_med:.3f})")
        if change.get("attn_int8"):
            hold_int8_dot(rs, tok, pos, cache, f"kvcache {label}, "
                          f"{LONG_SLOTS} slots of {seq}")
        del step
    del cache, outs
    torch.cuda.empty_cache()
    print(f"[kvcache] phase took {time.perf_counter() - t_phase:.1f} s")
    return all_launches


# The archs phase: the nine other LM architectures at published width,
# depth cut where one card or the script's time limit forces it (None =
# the published depth; PERF.md section 4 lists each cut). deepseek-moe-16b
# keeps 4 of its 28 layers (its first 4 of the pattern: the dense layer
# and 3 MoE): at 28 its per-call expert unpack took 170 s of the phase;
# 14 left time for the dist phase's training, 8 for the launch phase, 4
# for the script's time limit on a slower host. mixtral-8x7b keeps one of
# its 32 like layers (memory at 32; one holds every kind of its blocks;
# the script's time limit).
ARCH_DEPTHS = {"deepseek-moe-16b": 4, "mamba2-370m": None,
               "jamba-v0.1-52b": 8, "mixtral-8x7b": 1, "gemma3-12b": 6,
               "llama3-405b": 1, "nemotron-4-340b": 1, "musicgen-large": 1,
               "llama-3.2-vision-90b": 5}
ARCHS_BATCH, ARCHS_PROMPT, ARCHS_GEN = 2, 512, 8
# ``dense`` and ``serve_int8`` from the same draw: a prefill and
# ARCHS_MODE_GEN - 1 decode steps, held to serve_packed's first ones.
ARCHS_MODE_GEN = 4
# Engine traffic on deepseek-moe-16b (request j: 96 + 64 j
# tokens) and mamba2-370m (256 (j + 1) tokens: the SSD's chunk divides a
# prompt), ARCHS_ENGINE_REQUESTS requests of ARCHS_GEN tokens into
# ARCHS_ENGINE_BATCH slots, submitted one step apart.
ARCHS_ENGINE_BATCH, ARCHS_ENGINE_REQUESTS = 4, 4
ARCHS_ENGINE_PROMPTS = {"deepseek-moe-16b": lambda j: 96 + 64 * j,
                        "mamba2-370m": lambda j: 256 * (j + 1)}


def loom_linears(cfg, decode: bool) -> int:
    """The Loom linears one prefill (``decode=False``) or decode step runs,
    from the config: 4 per attention block; a cross-attention block's 6 in
    prefill (the image K/V projected for its cache and again for its
    attention, as in the reference) and 2 in decode (q and o); 6 per
    mamba block; 3 per gated dense FFN, 2 ungated; 3 per MoE block with
    shared experts (the routed experts are torch products), none without;
    and the head."""
    n = 1
    for spec in cfg.pattern:
        if spec.kind == "mamba":
            per = 6
        elif spec.kind == "cross":
            per = 2 if decode else 6
        else:
            per = 4
        if spec.ffn == "dense":
            per += 3 if cfg.ffn_gated else 2
        elif spec.ffn == "moe":
            per += 3 if cfg.moe.n_shared else 0
        n += per * cfg.n_groups
    return n


def twin_session(sess, backend: str, policy=None):
    """``sess``'s packed weights under a plan on another backend (or
    policy): what ``compile`` builds from the same packed tree, without a
    second copy of the weights."""
    from repro_torch.api.plan import build_plan, counted_weights
    from repro_torch.api.session import counted_shards, entry_points
    plan = build_plan(sess.cfg, policy or sess.plan.policy, sess.plan.mode,
                      backend)
    plan.record_weight_groups(
        counted_weights(sess.cfg, sess.params) if sess.shard is None
        else counted_shards(sess.params, plan.mode, sess.shard))
    return dataclasses.replace(sess, plan=plan,
                               **entry_points(sess.cfg, plan, sess.shard))


def _event_ms(fn) -> tuple:
    """(fn's result, ms between CUDA events around it)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def counted_call(label: str, expect: dict, fn):
    """``fn()`` with the counts reset just before and held to ``expect``
    just after; returns (result, ms between CUDA events, launches)."""
    reset_launches()
    out, ms = _event_ms(fn)
    got = read_launches()
    lm_step_launches(label, got, expect)
    return out, ms, got


def arch_run(sess, tokens, img, label: str, expect_pre: int,
             expect_dec: int, gen: int = ARCHS_GEN) -> dict:
    """Prefill and ``gen`` - 1 greedy decode steps, the counts reset just
    before each call and checked after it (K1 ``expect_pre`` and
    ``expect_dec`` times, nothing else); returns the logits, tokens, the
    calls' ms between CUDA events and the launches in all."""
    cache = sess.init_cache(ARCHS_BATCH, ARCHS_PROMPT + ARCHS_GEN)
    total = {name: 0 for name in KERNELS}

    def counted(what, expect, fn):
        out, ms, got = counted_call(f"{label} {what}",
                                    {"bitserial_matmul": expect}, fn)
        for name in total:
            total[name] += got[name]
        return out, ms
    (y, cache), pre_ms = counted(
        "prefill", expect_pre, lambda: sess.prefill(tokens, cache, img))
    logits, toks, dec_ms = [y[:, 0]], [torch.argmax(y[:, 0], dim=-1)], []
    for i in range(gen - 1):
        (y, cache), ms = counted(
            f"decode {i}", expect_dec,
            lambda: sess.decode(toks[-1], ARCHS_PROMPT + i, cache))
        logits.append(y)
        toks.append(torch.argmax(y, dim=-1))
        dec_ms.append(ms)
    return dict(logits=logits, tokens=torch.stack(toks, 1), pre_ms=pre_ms,
                dec_ms=sorted(dec_ms)[len(dec_ms) // 2], launches=total)


def arch_engine(sess, name: str, card: str) -> dict:
    """The batching engine on ``sess``: ARCHS_ENGINE_REQUESTS requests one
    step apart; every stream and batched decode row equal to its solo
    run. Returns the engine's launches."""
    cfg = sess.cfg
    lengths = [ARCHS_ENGINE_PROMPTS[name](j)
               for j in range(ARCHS_ENGINE_REQUESTS)]
    prompts = [np.random.default_rng(2 + j).integers(
        1, cfg.vocab, size=n).astype(np.int32) for j, n in enumerate(lengths)]
    max_seq = max(lengths) + ARCHS_GEN
    solos = [solo_run(sess, p_, ARCHS_GEN, max_seq) for p_ in prompts]
    rows, ref = [], []
    eng = BatchingEngine(recording_session(sess, rows, ref),
                         max_batch=ARCHS_ENGINE_BATCH, max_seq=max_seq)
    ref.append(eng)
    reset_launches()
    t0 = time.perf_counter()
    handles, step_s, _ = drive_engine(eng, prompts, ARCHS_GEN)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_lin = loom_linears(cfg, decode=True)
    lm_step_launches(f"{name} engine", launches, {
        "bitserial_matmul": n_lin * (eng.n_decode_steps + len(prompts))})
    check(len(rows) == len(prompts) * (ARCHS_GEN - 1),
          f"{name} engine recorded {len(rows)} batched rows")
    differ = [(rid, idx) for rid, idx, row in rows
              if not torch.equal(row, solos[rid][1][idx])]
    if differ:
        rid, idx = differ[0]
        cause = diagnose_batch_variance(sess, prompts[:ARCHS_ENGINE_BATCH],
                                        max_seq)
        check(False, f"{name} engine: {len(differ)} of {len(rows)} batched "
              f"decode rows' logits differ from the solo run's (first: "
              f"request {rid}, token {idx}); {cause}")
    for j, (h, (solo, _)) in enumerate(zip(handles, solos)):
        got = h.result(timeout=60.0)
        check(np.array_equal(got, solo), f"{name} engine request {j}: "
              f"stream {got.tolist()} differs from its solo run "
              f"{solo.tolist()}")
    eng.drain()
    print(f"[archs] {card}: {name} engine ({ARCHS_ENGINE_BATCH} slots of "
          f"{max_seq}, prompts of {lengths} tokens, {ARCHS_GEN} tokens "
          f"each, one step apart): every stream == its solo run and all "
          f"{len(rows)} batched decode rows' logits == the solo run's "
          f"(torch.equal); {eng.n_decode_steps} decode steps + "
          f"{len(prompts)} prefills in {wall:.2f} s, median step "
          f"{sorted(step_s)[len(step_s) // 2] * 1e3:.1f} ms; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# The archs whose serve_packed prefill and decode step the op analyzer reads
# on the card, held to the world-one dry run: the hybrid (mamba, attention
# and MoE blocks) and the VLM (cross-attention over image embeddings).
ARCHS_ANALYZED = ("jamba-v0.1-52b", "llama-3.2-vision-90b")
# The card against the CPU port at the smoke configs in dense: prompts of
# ARCHS_SMOKE_PROMPT tokens (one SSD chunk on the SSM archs),
# ARCHS_SMOKE_STEPS decode steps, logits within ARCHS_SMOKE_ATOL
# (tests/_archs_parity.py's LOGIT_ATOL, the CPU port against JAX).
ARCHS_SMOKE_PROMPT, ARCHS_SMOKE_STEPS, ARCHS_SMOKE_ATOL = 16, 3, 0.2
# The world-one dry runs of ARCHS_ANALYZED's steps (host work on fake
# tensors), traced in a subprocess beside the build and the kernel
# checks, which time nothing: one JSON line of {"prefill", "decode":
# counts} per arch, in order.
_ARCHS_DRY_SCRIPT = """
import dataclasses, json
from repro_torch import configs
from repro_torch.launch import dryrun
for name, depth, batch, prompt, cache_len in {cases!r}:
    full = configs.get(name)
    cfg = dataclasses.replace(full, n_layers=depth,
                              pattern=full.pattern[:depth])
    dry = dryrun.serving_counts(cfg, "serve_packed", batch, prompt,
                                cache_len)
    print(json.dumps({{k: t.counts() for k, t in dry.items()}}),
          flush=True)
"""


def start_archs_dry_runs() -> tuple:
    """Start the dry runs of ARCHS_ANALYZED's prefill and decode step at
    their ARCH_DEPTHS cut (:func:`start_dry_runs`)."""
    cases = [(name, ARCH_DEPTHS[name], ARCHS_BATCH, ARCHS_PROMPT,
              ARCHS_PROMPT + ARCHS_GEN) for name in ARCHS_ANALYZED]
    return start_dry_runs(_ARCHS_DRY_SCRIPT.format(cases=cases))


def archs_dry_counts(started: tuple) -> dict:
    """{arch: {"prefill", "decode": counts}} of :func:`start_archs_dry_runs`'
    subprocess, waited for here."""
    lines, took, waited = finish_dry_runs(started, "the archs' dry runs")
    check(len(lines) == len(ARCHS_ANALYZED),
          f"the archs' dry runs printed {lines}")
    print(f"[archs] world-one dry runs of {list(ARCHS_ANALYZED)}' prefill "
          f"and decode step in {took:.1f} s (one subprocess beside the "
          f"build and the kernel checks; waited {waited:.1f} s here)",
          flush=True)
    return {name: json.loads(ln) for name, ln in zip(ARCHS_ANALYZED, lines)}


def arch_compile(cfg, mode: str, params) -> tuple:
    """(session, compile s, fingerprint s) of ``cfg`` in ``mode`` on the
    card from the drawn tree ``params`` (``dense`` serves it as it is; a
    serving mode converts it and fingerprints the result on the host)."""
    fp_s = []
    fingerprint = integrity.fingerprint_session

    def timed_fingerprint(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fingerprint(*args, **kwargs)
        finally:
            fp_s.append(time.perf_counter() - t0)
    integrity.fingerprint_session = timed_fingerprint
    t0 = time.perf_counter()
    try:
        sess = repro_torch.compile(cfg, uniform_policy(8, 8), mode=mode,
                                   backend="cuda", params=params,
                                   device="cuda")
    finally:
        integrity.fingerprint_session = fingerprint
    torch.cuda.synchronize()
    return sess, time.perf_counter() - t0, sum(fp_s)


def arch_mode_run(sess, tokens, img, label: str) -> dict:
    """:func:`arch_run` of a session that launches no kernel of the port
    (``dense``, ``serve_int8``): a warm-up, then a prefill and
    ARCHS_MODE_GEN - 1 decode steps, each call's counts held to none; with
    the serving peak above what was held just before (``peak``,
    ``held``)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    arch_run(sess, tokens, img, f"{label} warm-up", 0, 0, gen=2)
    r = arch_run(sess, tokens, img, label, 0, 0, gen=ARCHS_MODE_GEN)
    return dict(r, peak=torch.cuda.max_memory_allocated() - held, held=held)


def analyze_served(sess, tokens, img, cache_len: int, n_lin: tuple,
                   label: str) -> dict:
    """One prefill of ``tokens`` (int32; ``img`` the VLM's image embeddings
    or None) over ``cache_len`` cache slots and the decode step that
    follows it (at the int position ``generate`` passes), each under the
    op analyzer with the launch counts reset just before: K1 ``n_lin`` =
    (per prefill, per decode step) times and nothing else, and the
    analyzer's kernels equal to the launch counters. Returns
    {"prefill", "decode": Totals, "launches", "cache", "tok"}."""
    params = sess.params
    prompt = tokens.shape[1]
    extra = () if img is None else (img,)
    cache = sess.init_cache(tokens.shape[0], cache_len)
    with torch.inference_mode():
        reset_launches()
        (logits, cache), pre = _analyzed(
            lambda: sess._prefill(params, tokens, cache, *extra),
            (params, cache) + extra)
        pre_launches = read_launches()
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
        reset_launches()
        _, dec = _analyzed(lambda: sess._decode(params, tok, prompt, cache),
                           (params, cache))
        dec_launches = read_launches()
    for what, t, got, n in (("prefill", pre, pre_launches, n_lin[0]),
                            ("decode", dec, dec_launches, n_lin[1])):
        lm_step_launches(f"{label} {what}", got, {"bitserial_matmul": n})
        check(t.kernels == {"K1": got["bitserial_matmul"]},
              f"{label} {what}: the analyzer counted {t.kernels}, the "
              f"launch counters {got}")
    return {"prefill": pre, "decode": dec, "cache": cache, "tok": tok,
            "launches": {k: pre_launches[k] + dec_launches[k]
                         for k in KERNELS}}


def hold_dry_run(dry: dict, got: dict, label: str) -> None:
    """The world-one dry run's counts (``dryrun.serving_counts``: fake
    tensors, ``torch_ref``; {"prefill", "decode": ``Totals.counts()``}) of
    :func:`analyze_served`'s two steps must equal the card's: operations,
    HBM bytes and kernels."""
    for what in ("prefill", "decode"):
        check(dry[what] == got[what].counts(),
              f"{label} {what}: the dry run counted {dry[what]}, the "
              f"card's step {got[what].counts()}")


def arch_analysis(sess, tokens, img, n_lin: tuple, times: tuple,
                  dry: dict, card: str) -> dict:
    """The op analyzer on ``sess``'s (cut published config) prefill and
    decode step on the card (:func:`analyze_served`), held to ``dry``, the
    world-one dry run's counts at the same config
    (:func:`archs_dry_counts`); each step's eager-bound fraction against
    ``times`` (its ms from the timed run). Returns the launches."""
    t0 = time.perf_counter()
    cfg = sess.cfg
    got = analyze_served(sess, tokens.to(torch.int32), img,
                         ARCHS_PROMPT + ARCHS_GEN, n_lin,
                         f"{cfg.name} analyzed")
    del got["cache"]
    analyzed_s = time.perf_counter() - t0
    hold_dry_run(dry, got, f"{cfg.name} analyzed")
    for what, ms in zip(("prefill", "decode"), times):
        t = got[what]
        bound = opanalysis.roofline_terms(t)
        print(f"[archs] {card}: {cfg.name} serve_packed {what} under the "
              f"analyzer: {t.flops:.6g} operations {t.flops_by_type}, "
              f"{t.hbm_bytes:.6g} HBM bytes, {t.n_ops} aten ops, kernels "
              f"{t.kernels} (== the launch counters); eager bound "
              f"{bound['bound_s'] * 1e3:.4f} ms ({bound['dominant']}), "
              f"eager-bound fraction {bound['bound_s'] * 1e3 / ms:.4f} of "
              f"the timed run's {ms:.3f} ms", flush=True)
    print(f"[archs] {card}: {cfg.name}: the world-one dry run (fake "
          f"tensors, torch_ref) counts the card's prefill and decode step "
          f"exactly (operations, HBM bytes, kernels); analyzed steps "
          f"{analyzed_s:.1f} s", flush=True)
    return got["launches"]


def archs_smoke_dense(card: str) -> None:
    """The card against the CPU port in ``dense`` at each arch's smoke
    config (no published-width reference exists for ``dense`` on the
    card; ``tests/_archs_parity.py`` holds the CPU port to JAX): seed-0
    params drawn on the CPU and carried to the card, ARCHS_BATCH prompts
    of ARCHS_SMOKE_PROMPT tokens (numpy seed 1; ``cfg.ssm.chunk`` on the
    SSM archs; the VLM's image embeddings numpy seed 3), a prefill and
    ARCHS_SMOKE_STEPS decode steps fed the CPU's greedy tokens on both.
    The card's logits within ARCHS_SMOKE_ATOL of the CPU's at every step,
    and its greedy tokens equal wherever the CPU's top-2 margin exceeds
    twice that (``_archs_parity.py``'s rule)."""
    t0 = time.perf_counter()
    worst = {}
    for name in ARCH_DEPTHS:
        cfg = configs.get(name, smoke=True)
        prompt = cfg.ssm.chunk if cfg.ssm is not None else \
            ARCHS_SMOKE_PROMPT
        params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, size=(ARCHS_BATCH, prompt)))
        img = None
        if cfg.n_img_tokens:
            img = torch.from_numpy(np.random.default_rng(3).normal(
                size=(ARCHS_BATCH, cfg.n_img_tokens, cfg.d_model)).astype(
                np.float32)).to(torch.bfloat16)
        logits, caches, sessions = {}, {}, {}
        for dev in ("cpu", "cuda"):
            sessions[dev] = repro_torch.compile(
                cfg, uniform_policy(8, 8), mode="dense", backend="cuda",
                params=interop.params_from_numpy(params, dev), device=dev)
            y, caches[dev] = sessions[dev].prefill(
                tokens.to(dev), sessions[dev].init_cache(
                    ARCHS_BATCH, prompt + ARCHS_SMOKE_STEPS),
                None if img is None else img.to(dev))
            logits[dev] = y[:, 0]
        worst[name] = 0.0
        for step in range(ARCHS_SMOKE_STEPS + 1):
            want, got = logits["cpu"].float(), logits["cuda"].float().cpu()
            check(got.shape == want.shape and got.shape[-1] == cfg.vocab
                  and bool(torch.isfinite(got).all()),
                  f"{name} smoke dense step {step}: card logits "
                  f"{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
            err = float((got - want).abs().max())
            worst[name] = max(worst[name], err)
            check(err <= ARCHS_SMOKE_ATOL, f"{name} smoke dense step {step}: "
                  f"the card's logits differ from the CPU's by {err:.4g} "
                  f"(at {np.unravel_index(int((got - want).abs().argmax()), tuple(got.shape))})")
            top2 = torch.topk(want, 2, dim=-1).values
            clear = top2[:, 0] - top2[:, 1] > 2 * ARCHS_SMOKE_ATOL
            check(torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear]),
                  f"{name} smoke dense step {step}: greedy tokens "
                  f"{got.argmax(-1).tolist()} on the card, "
                  f"{want.argmax(-1).tolist()} on the CPU (clear margin "
                  f"{clear.tolist()})")
            if step == ARCHS_SMOKE_STEPS:
                break
            tok = want.argmax(-1)
            for dev, s_ in sessions.items():
                logits[dev], caches[dev] = s_.decode(tok.to(dev),
                                                     prompt + step,
                                                     caches[dev])
        del sessions, caches, logits
    print(f"[archs] {card}: smoke configs, dense, card against the CPU "
          f"port (seed-0 params carried over, {ARCHS_BATCH} prompts of "
          f"{ARCHS_SMOKE_PROMPT} tokens or one SSD chunk, "
          f"{ARCHS_SMOKE_STEPS} decode steps on the CPU's tokens): "
          f"logits within {ARCHS_SMOKE_ATOL} and tokens equal where the "
          f"margin exceeds {2 * ARCHS_SMOKE_ATOL} on all nine; largest "
          f"difference by arch "
          f"{ {k: round(v, 5) for k, v in worst.items()} }; took "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _gib(n) -> str:
    return f"{n / 2**30:.3f} GiB"


def phase_archs(card: str, dry: dict) -> dict:
    """The other nine LM architectures, one at a time on the card, from
    one seed-0 draw each (published width, ARCH_DEPTHS):
    ``serve_packed`` (8, 8), ARCHS_BATCH prompts of ARCHS_PROMPT tokens
    (numpy seed 1; the VLM also image embeddings from numpy seed 3),
    ARCHS_GEN greedy tokens. Per arch: K1 launched the config's Loom
    linear count per prefill and per decode step and nothing else;
    ``cuda`` logits and tokens equal a ``torch_ref`` twin's on the same
    packed weights; the compile's seconds (draw, pack, fingerprint),
    packed bytes, peak memory, prefill ms and decode ms/step (CUDA
    events). From the same draw, first ``dense`` (the drawn tree served as
    it is) and ``serve_int8`` (converted before the draw is freed), each a
    warm-up, a prefill and ARCHS_MODE_GEN - 1 decode steps launching no
    kernel of the port: dense logits finite and of vocab width,
    ``serve_int8``'s equal to ``serve_packed``'s at every step; their
    compile seconds, tree bytes, peaks, prefill and decode ms beside
    ``serve_packed``'s. At most the draw and two serving trees are held
    at once. ARCHS_ANALYZED: the serve_packed prefill and decode step
    under the op analyzer, held to the world-one dry run (``dry``:
    :func:`archs_dry_counts`).
    deepseek-moe-16b also: a ``dynamic_a`` prefill (K3) equal to the
    static one, the engine's traffic, a profiled decode step; mamba2-370m
    the engine's traffic. Then :func:`archs_smoke_dense`. Returns the
    launches by path."""
    t_phase = time.perf_counter()
    out = {}
    new_s = 0.0          # dense, serve_int8, the analyzer, smoke configs
    for name, depth in ARCH_DEPTHS.items():
        t_arch = time.perf_counter()
        full = configs.get(name)
        cfg = full if depth is None else dataclasses.replace(
            full, n_layers=depth, pattern=full.pattern[:depth])
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in
                       interop.flatten_with_paths(params).values())
        sess, compile_s, fp_s = arch_compile(cfg, "serve_packed", params)
        pack_peak = torch.cuda.max_memory_allocated() - base
        n_pre, n_dec = (loom_linears(cfg, decode=False),
                        loom_linears(cfg, decode=True))
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, size=(ARCHS_BATCH, ARCHS_PROMPT))).cuda()
        img = None
        if cfg.n_img_tokens:
            img = torch.from_numpy(np.random.default_rng(3).normal(
                size=(ARCHS_BATCH, cfg.n_img_tokens, cfg.d_model)).astype(
                np.float32)).to("cuda", torch.bfloat16)
        print(f"[archs] {card}: {name}: {cfg.n_layers} layers (published "
              f"{full.n_layers}), d {cfg.d_model}, pattern "
              f"{[(sp.kind, sp.ffn, sp.window) for sp in cfg.pattern]}, "
              f"vocab {cfg.vocab}; {n_params} weights drawn in {draw_s:.2f} "
              f"s, compile {compile_s:.2f} s (pack and count, fingerprint "
              f"{fp_s:.2f} s), packed tree {_param_bytes(sess.params)} "
              f"B; peak device memory over draw and compile "
              f"{pack_peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
              f"held before", flush=True)

        # serve_int8 from the same draw, then dense on the draw itself.
        t_new = time.perf_counter()
        modes = {}
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        isess, i_s, i_fp = arch_compile(cfg, "serve_int8", params)
        modes["serve_int8"] = dict(
            compile=f"{i_s:.2f} s (conversion and count, fingerprint "
                    f"{i_fp:.2f} s)",
            bytes=_param_bytes(isess.params),
            compile_peak=torch.cuda.max_memory_allocated() - held,
            compile_held=held)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dsess, d_s, _ = arch_compile(cfg, "dense", params)
        modes["dense"] = dict(
            compile=f"{d_s:.2f} s (the drawn tree as it is)",
            bytes=_param_bytes(dsess.params),
            compile_peak=torch.cuda.max_memory_allocated() - held,
            compile_held=held)
        modes["dense"].update(arch_mode_run(dsess, tokens, img,
                                            f"{name} dense"))
        for i, a in enumerate(modes["dense"]["logits"]):
            check(a.shape[-1] == cfg.vocab and bool(torch.isfinite(a).all()),
                  f"{name} dense step {i}: logits {tuple(a.shape)}, finite "
                  f"{bool(torch.isfinite(a).all())}")
        del dsess, params
        modes["serve_int8"].update(arch_mode_run(isess, tokens, img,
                                                 f"{name} serve_int8"))
        del isess
        torch.cuda.empty_cache()
        new_s += time.perf_counter() - t_new

        ref = twin_session(sess, "torch_ref")
        torch.cuda.reset_peak_memory_stats()
        arch_run(sess, tokens, img, f"{name} warm-up", n_pre, n_dec, gen=2)
        got = arch_run(sess, tokens, img, name, n_pre, n_dec)
        serve_peak = torch.cuda.max_memory_allocated() - base
        want = arch_run(ref, tokens, img, f"{name} torch_ref", 0, 0)
        for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            check(a.shape[-1] == cfg.vocab and bool(torch.isfinite(a).all()),
                  f"{name} step {i}: logits {tuple(a.shape)}")
            check(torch.equal(a, b), f"{name} step {i} logits: cuda differs "
                  f"from torch_ref")
        check(torch.equal(got["tokens"], want["tokens"]),
              f"{name}: cuda tokens differ from torch_ref's")
        for i, a in enumerate(modes["serve_int8"]["logits"]):
            b = got["logits"][i]
            check(torch.equal(a, b), f"{name} step {i}: serve_int8 logits "
                  f"differ from serve_packed's by "
                  f"{max_err(a.float(), b.float()):.4g} (first at "
                  f"{np.unravel_index(int((a != b).int().argmax()), tuple(a.shape))})")
        out[f"archs {name}"] = got["launches"]
        print(f"[archs] {card}: {name}: cuda == torch_ref (prefill and "
              f"{ARCHS_GEN - 1} decode steps' logits, tokens "
              f"{got['tokens'][0].tolist()}); K1 {n_pre} per prefill and "
              f"{n_dec} per decode step, nothing else; prefill "
              f"{ARCHS_BATCH} x {ARCHS_PROMPT} {got['pre_ms']:.3f} ms, decode "
              f"{got['dec_ms']:.3f} ms/step (median of {ARCHS_GEN - 1}; CUDA "
              f"events); peak device memory serving "
              f"{serve_peak / 2**30:.3f} GiB above the base", flush=True)
        print(f"[archs] {card}: {name}: serve_int8 == serve_packed (prefill "
              f"and {ARCHS_MODE_GEN - 1} decode steps' logits, torch.equal, "
              f"from one draw); dense logits finite, vocab {cfg.vocab}; "
              f"neither launched a kernel of the port", flush=True)
        print(f"[archs] {card}: {name} serve_packed: compile "
              f"{compile_s:.2f} s (pack and count, fingerprint {fp_s:.2f} s),"
              f" tree {_param_bytes(sess.params)} B, peak over draw and "
              f"compile {_gib(pack_peak)} above {_gib(base)}, serving peak "
              f"{_gib(serve_peak)} above {_gib(base)}; prefill "
              f"{got['pre_ms']:.3f} ms, decode {got['dec_ms']:.3f} ms/step "
              f"(median of {ARCHS_GEN - 1})", flush=True)
        for mode, m in modes.items():
            print(f"[archs] {card}: {name} {mode}: compile {m['compile']}, "
                  f"tree {m['bytes']} B, peak over compile "
                  f"{_gib(m['compile_peak'])} above {_gib(m['compile_held'])}"
                  f", serving peak {_gib(m['peak'])} above "
                  f"{_gib(m['held'])}; prefill {m['pre_ms']:.3f} ms, decode "
                  f"{m['dec_ms']:.3f} ms/step (median of "
                  f"{ARCHS_MODE_GEN - 1}; CUDA events)", flush=True)
        del ref, want, modes
        if name in ARCHS_ANALYZED:
            t_new = time.perf_counter()
            out[f"archs {name} analyzed"] = arch_analysis(
                sess, tokens, img, (n_pre, n_dec),
                (got["pre_ms"], got["dec_ms"]), dry[name], card)
            new_s += time.perf_counter() - t_new
        if name == "deepseek-moe-16b":
            dyn = twin_session(sess, "cuda", uniform_policy(8, 8,
                                                            dynamic_a=True))
            reset_launches()
            (ydyn, _), dyn_ms = _event_ms(lambda: dyn.prefill(
                tokens, dyn.init_cache(ARCHS_BATCH, ARCHS_PROMPT)))
            dl = read_launches()
            lm_step_launches(f"{name} dynamic_a prefill", dl,
                             {"bitserial_matmul_dynamic": n_pre})
            check(torch.equal(ydyn[:, 0], got["logits"][0]),
                  f"{name} dynamic_a prefill differs from the static one")
            out[f"archs {name} dynamic_a"] = dl
            print(f"[archs] {card}: {name}: dynamic_a prefill == static "
                  f"bit for bit (K3 launched {n_pre} times), "
                  f"{dyn_ms:.3f} ms", flush=True)
            del dyn, ydyn
        if name in ARCHS_ENGINE_PROMPTS:
            out[f"archs {name} engine"] = arch_engine(sess, name, card)
        if name == "deepseek-moe-16b":
            cache = sess.init_cache(ARCHS_BATCH, ARCHS_PROMPT + ARCHS_GEN)
            sess.prefill(tokens, cache)
            phase_profile(f"archs {name} decode step ({card})",
                          lambda: sess.decode(tokens[:, -1], ARCHS_PROMPT,
                                              cache),
                          got["dec_ms"] / 1e3, n_dec, requests=2)
            del cache
        del sess, got
        print(f"[archs] {name} took {time.perf_counter() - t_arch:.1f} s",
              flush=True)
    t_new = time.perf_counter()
    archs_smoke_dense(card)
    new_s += time.perf_counter() - t_new
    torch.cuda.empty_cache()
    print(f"[archs] phase took {time.perf_counter() - t_phase:.1f} s, of "
          f"which dense, serve_int8, the analyzed steps and the smoke "
          f"configs {new_s:.1f} s")
    return out


# The train phase: qwen3-1.7b at published width and depth, TRAIN_STEPS
# steps in each mode from seed-0 weights drawn on the card, batches of
# TRAIN_BATCH x TRAIN_SEQ tokens from the port's data pipeline; mamba2-370m
# (48 layers) and deepseek-moe-16b cut to its first TRAIN_MOE_LAYERS layers
# (one dense, three MoE: 64 experts x 27 MoE layers with float32 moments
# would not fit one card) for TRAIN_ARCH_STEPS steps each.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_ARCH_STEPS = 4, 512, 8, 3
OPT_CALLS = 3                    # AdamW timed alone, after the steps
TRAIN_MOE_LAYERS = 4
# The flash VJP against autograd through chunked_attention, both in
# float32 from the same bf16 inputs ([B, S, H, D], causal, window): the
# same products summed in another order, within 1e-4 + 1e-4 |want|; a kv
# block dropped or counted twice moves a gradient by 1e-2 or more.
FLASH_CASES = [((4, 512, 16, 128), None), ((1, 4096, 16, 128), None),
               ((1, 4096, 16, 128), 1024)]
FLASH_TOL = (1e-4, 1e-4)
FLASH_TIMED_S = 4096          # the sequence length whose routes are timed


def _flash_grads(route, q_, k_, v_, do, window) -> tuple:
    """(output, dq, dk, dv) of ``route`` ("flash": FlashAttention, else
    autograd through chunked_attention), causal, blocks of 512."""
    leaves = [t.detach().requires_grad_(True) for t in (q_, k_, v_)]
    if route == "flash":
        out = attn.flash_attention(*leaves, True, window, 512, 512)
    else:
        out = attn.chunked_attention(*leaves, causal=True, window=window)
    return (out,) + torch.autograd.grad(out, leaves, do)


def phase_flash_vjp(card: str) -> None:
    """FlashAttention's dQ/dK/dV against autograd through
    ``chunked_attention`` on the card (FLASH_CASES, float32 from bf16
    inputs, FLASH_TOL); then each route's forward + backward time (CUDA
    events, median of 3) and peak memory at S = 4096 in bf16."""
    for shape, window in FLASH_CASES:
        g = torch.Generator(device="cuda").manual_seed(shape[1])
        q_, k_, v_, do = (torch.randn(shape, generator=g, device="cuda")
                          .to(torch.bfloat16).float() for _ in range(4))
        got = _flash_grads("flash", q_, k_, v_, do, window)
        want = _flash_grads("autograd", q_, k_, v_, do, window)
        err = max(max_err(a, b) for a, b in zip(got, want))
        for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            check(within(a, b, *FLASH_TOL), f"flash VJP {what} at {shape} "
                  f"window {window}: max err {max_err(a, b):.3g}")
        print(f"[train] {card}: flash VJP == autograd through "
              f"chunked_attention at {list(shape)} causal window {window} "
              f"(float32 from bf16 inputs): max abs err {err:.3g} "
              f"(tolerance {FLASH_TOL[0]} + {FLASH_TOL[1]} |want|)",
              flush=True)
        if shape[1] == FLASH_TIMED_S:
            bf = [t.to(torch.bfloat16) for t in (q_, k_, v_, do)]
            for route in ("flash", "autograd"):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = sorted(_event_ms(lambda: _flash_grads(route, *bf,
                                                           window))[1]
                            for _ in range(3))[1]
                peak = torch.cuda.max_memory_allocated() - base
                print(f"[train] {card}: {route} route at {list(shape)} bf16 "
                      f"causal window {window}: forward + backward {ms:.3f} "
                      f"ms (CUDA events, median of 3), peak memory "
                      f"{peak / 2**30:.3f} GiB above the inputs", flush=True)
            del bf
        del q_, k_, v_, do, got, want
    torch.cuda.empty_cache()


def _train_flops(cfg, params) -> float:
    """Model FLOPs per token of a training step: 6 x the parameters a
    token's products touch (the embedding table is a gather and counts
    none; a MoE layer's routed experts count top_k / n_experts of theirs,
    capacity drops ignored), plus attention's 12 x layers x heads x d_head
    x S (PaLM's appendix B, the causal half not discounted). The SSM's
    scan counts none."""
    n = 0.0
    for key, t in interop.flatten_with_paths(params).items():
        if key == "embed/emb":
            continue
        if cfg.moe is not None and t.ndim == 4 and key.rsplit("/", 1)[-1] \
                in ("w_gate", "w_up", "w_down"):
            n += t.numel() * cfg.moe.top_k / cfg.moe.n_experts
        else:
            n += t.numel()
    n_attn = sum(spec.kind != "mamba" for spec in cfg.pattern) * cfg.n_groups
    return 6 * n + 12 * n_attn * cfg.n_heads * cfg.d_head * TRAIN_SEQ


def train_analysis(cfg, plan, state, step, median_ms: float,
                   mfu: float, label: str, card: str) -> None:
    """One more step of ``step`` on ``state`` under the op analyzer on the
    card, its batch laid out as the dry run's (the pipeline's step-0
    batch as int32 tokens and labels on the card), held to
    ``dryrun.train_counts(cfg, plan.mode, TRAIN_BATCH, TRAIN_SEQ)``
    (the step's moments, float32): operations, HBM bytes and kernels equal,
    kernels none. The backward, which autograd runs on its CUDA device
    thread, must be counted: the step's operations within 1% of three
    times the forward's (the loss alone under ``no_grad``, analyzed too;
    each product's backward is two products of its size). Prints the
    counts and the eager-bound fraction (the analyzer's bound over the
    median step) beside ``train_mfu``."""
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train as train_mod
    t0 = time.perf_counter()
    batch = {k: torch.as_tensor(v, dtype=torch.int32, device="cuda")
             for k, v in synthetic_batch(DataConfig(
                 vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                 global_batch=TRAIN_BATCH), 0).items()}
    reset_launches()
    _, t = _analyzed(lambda: step(state, batch), (state, batch))
    launches = read_launches()
    with torch.no_grad(), opanalysis.OpAnalysis(memory=False) as fwd:
        M.loss_fn(state["params"], cfg, train_mod.batch_on(batch, "cuda"),
                  plan)
    torch.cuda.synchronize()
    analyzed_s = time.perf_counter() - t0
    ratio = t.flops / fwd.totals().flops
    t0 = time.perf_counter()
    dry = dryrun.train_counts(cfg, plan.mode, TRAIN_BATCH, TRAIN_SEQ)
    dry_s = time.perf_counter() - t0
    check(not any(launches.values()) and t.kernels == {},
          f"{label} analyzed step: kernels {t.kernels}, launches {launches}")
    check(abs(ratio / 3 - 1) <= 0.01, f"{label} analyzed step: "
          f"{t.flops:.6g} operations, {ratio:.4f} times the forward's "
          f"{fwd.totals().flops:.6g}: the backward is not counted whole")
    check(dry.counts() == t.counts(), f"{label} analyzed step: the dry run "
          f"counted {dry.counts()}, the card's step {t.counts()}")
    terms = opanalysis.roofline_terms(t)
    print(f"[train] {card}: {label} step under the analyzer: "
          f"{t.flops:.6g} operations {t.flops_by_type} ({ratio:.4f} times "
          f"the forward's {fwd.totals().flops:.6g}: the backward counted), "
          f"{t.hbm_bytes:.6g} HBM bytes, {t.n_ops} aten ops, kernels "
          f"{t.kernels}, tracked peak {t.peak_bytes / 2**30:.3f} GiB; the "
          f"world-one dry run (dryrun.train_counts, fake tensors, "
          f"{cfg.n_groups} layer groups) counts the "
          f"same operations, HBM bytes and kernels; on the datasheet "
          f"constants: eager bound {terms['bound_s'] * 1e3:.4f} ms "
          f"({terms['dominant']}), eager-bound fraction "
          f"{terms['bound_s'] * 1e3 / median_ms:.4f} of the median step's "
          f"{median_ms:.3f} ms, beside train_mfu {mfu:.4f}; analyzed step "
          f"and forward {analyzed_s:.1f} s, dry run {dry_s:.1f} s",
          flush=True)


def train_run(cfg, mode: str, steps: int, label: str, card: str,
              profile: bool = False, analyze: bool = False) -> dict:
    """``steps`` train steps of ``cfg`` in ``mode`` ((8, 8) for
    fake_quant) from a seed-0 state drawn on the card, AdamW (float32
    moments) under ``Schedule(warmup_steps=2, total_steps=TRAIN_STEPS)``,
    batch j = the data pipeline's step j. The kernel counts are reset
    just before the steps and read just after: the training path runs
    none of the port's kernels. Prints and returns the losses, step ms
    (CUDA events: the first step apart, the median of the rest),
    tokens/s, train_mfu, peak memory and the optimizer's ms: the median of
    OPT_CALLS calls of ``adamw_update`` alone after the steps, on the
    final params with the params as their gradients (same leaves, shapes
    and dtypes as the step's), so that no timed step holds a host sync.
    ``analyze``: then :func:`train_analysis`."""
    from repro_torch.api.plan import build_plan
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import Schedule, make_schedule
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    tc = train_mod.TrainConfig(sched=Schedule(warmup_steps=2,
                                              total_steps=TRAIN_STEPS))
    state, _ = train_mod.make_train_state(
        cfg, tc, torch.Generator(device="cuda").manual_seed(0), "cuda")
    state_bytes = _param_bytes(state)
    flops = _train_flops(cfg, state["params"])
    plan = build_plan(cfg, uniform_policy(8, 8), mode)
    step = train_mod.make_train_step(cfg, plan, tc)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    batches = [synthetic_batch(dcfg, i) for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics, step_ms = [], []
    for batch in batches:
        (state, m), ms = _event_ms(lambda: step(state, batch))
        metrics.append({k: float(v) for k, v in m.items()})
        step_ms.append(ms)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() - base
    lr = make_schedule(tc.sched)(state["opt"]["step"])
    opt_ms = sorted(_event_ms(lambda: train_mod.adamw_update(
        state["params"], state["params"], state["opt"], tc.opt, lr))[1]
        for _ in range(OPT_CALLS))
    check(not any(launches.values()), f"{label}: the training path "
          f"launched kernels of the port: {launches}")
    losses = [m["loss"] for m in metrics]
    check(all(np.isfinite(x) for x in losses), f"{label}: losses {losses}")
    check(all(np.isfinite(m["grad_norm"]) for m in metrics),
          f"{label}: grad norms {[m['grad_norm'] for m in metrics]}")
    rest = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    opt = opt_ms[len(opt_ms) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = flops * tokens / (rest / 1e3) / BF16_FLOPS
    n_weights = sum(t.numel() for t in
                    interop.flatten_with_paths(state["params"]).values())
    print(f"[train] {card}: {label}: {cfg.n_layers} layers, "
          f"{n_weights} weights, state "
          f"{state_bytes / 2**30:.3f} GiB; {steps} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: losses {[round(x, 4) for x in losses]}, "
          f"grad norms {[round(m['grad_norm'], 3) for m in metrics]}; step "
          f"{step_ms[0]:.3f} ms first, {rest:.3f} ms median of the other "
          f"{steps - 1} (CUDA events), {tokens / (rest / 1e3):.1f} tokens/s, "
          f"train_mfu {mfu:.4f} ({flops:.4g} FLOPs/token over {BF16_FLOPS:.4g}"
          f" FLOP/s bf16 dense peak); optimizer {opt:.3f} ms (median of {OPT_CALLS} calls of its own); peak "
          f"memory {peak / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB "
          f"held before; the port's kernels launched 0 times", flush=True)
    if analyze:
        train_analysis(cfg, plan, state, step, rest, mfu, label, card)
    busy = None
    if profile:
        _, busy = phase_profile(f"train {label} step ({card})",
                                lambda: step(state, batches[-1]),
                                rest / 1e3, 0, requests=1)
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, metrics=metrics, step_ms=step_ms,
                median_ms=rest, opt_ms=opt, mfu=mfu, peak=peak, busy=busy)


def phase_train(card: str) -> None:
    """The training path on the card: the flash VJP held against autograd
    (phase_flash_vjp); qwen3-1.7b at full width and depth (remat "none"),
    TRAIN_STEPS steps in ``dense`` and in ``fake_quant`` (8, 8), every loss
    finite and the mean of the last three below the first, one step of
    each analyzed (:func:`train_analysis`) and one profiled; mamba2-370m (48 layers) and deepseek-moe-16b (its first
    TRAIN_MOE_LAYERS layers) TRAIN_ARCH_STEPS dense steps each, finite
    losses, deepseek's auxiliary loss positive and finite."""
    t_phase = time.perf_counter()
    phase_flash_vjp(card)
    qwen = dataclasses.replace(configs.get("qwen3-1.7b"), remat="none")
    for mode in ("dense", "fake_quant"):
        r = train_run(qwen, mode, TRAIN_STEPS, f"qwen3-1.7b {mode}", card,
                      profile=True, analyze=True)
        last = float(np.mean(r["losses"][-3:]))
        check(last < r["losses"][0], f"qwen3-1.7b {mode}: the last three "
              f"losses' mean {last} is not below the first "
              f"{r['losses'][0]}")
    mamba = dataclasses.replace(configs.get("mamba2-370m"), remat="none")
    train_run(mamba, "dense", TRAIN_ARCH_STEPS, "mamba2-370m dense", card)
    full = configs.get("deepseek-moe-16b")
    moe_cfg = dataclasses.replace(full, n_layers=TRAIN_MOE_LAYERS,
                                  pattern=full.pattern[:TRAIN_MOE_LAYERS],
                                  remat="none")
    r = train_run(moe_cfg, "dense", TRAIN_ARCH_STEPS,
                  f"deepseek-moe-16b ({TRAIN_MOE_LAYERS} of "
                  f"{full.n_layers} layers) dense", card)
    aux = [m["aux"] for m in r["metrics"]]
    check(all(np.isfinite(a) and a > 0 for a in aux),
          f"deepseek-moe-16b: auxiliary losses {aux}")
    print(f"[train] deepseek-moe-16b auxiliary losses {aux}")
    print(f"[train] phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# The paper phase: the paper's evaluation on the card. The CNN's profile
# (benchmarks/table1.py's method: tolerance 0.02, min_bits 2, a_bits then
# w_bits) on PAPER_IMAGES images (numpy seed 1); the LM's per-class search
# (examples/precision_profiles.py's: tolerance 0.03, min_bits 3) on
# PAPER_LM_TOKENS tokens (numpy seed 0), then a prefill of LM_BATCH x
# LM_PROMPT prompts (numpy seed 1) and PAPER_GEN - 1 greedy decode steps;
# the plane-width engine at qwen3-1.7b's layer-0 q projection.
PAPER_IMAGES = 256
PAPER_LM_TOKENS = (4, 32)
PAPER_GEN = 9
# (label, a_bits, w_bits, plane bits, mode); the last two take the
# engine's float64 product (an unsigned 8-bit low plane; whole 16-bit
# activations), the rest its int8 one.
PAPER_ENGINE_CASES = [("LM_1b", 8, 8, 1, "serial_both"),
                      ("LM_2b", 8, 8, 2, "serial_both"),
                      ("LM_4b", 8, 8, 4, "serial_both"),
                      ("LM_8b", 8, 8, 8, "serial_both"),
                      ("LM_8b (16, 8)", 16, 8, 8, "serial_both"),
                      ("serial_weights (16, 8)", 16, 8, 8, "serial_weights")]
# A hand-set per-layer mix for the paper CNN (the card tests' own):
# K2 on packed (Pw 5) and wide (Pw 11, 13) planes, K1 split lo/hi at Pw
# 9 and 16, activations below 8 bits.
PAPER_CNN_MIX = PrecisionPolicy(default=LayerPrecision(8, 8), per_layer={
    "conv1": LayerPrecision(8, 13), "conv2": LayerPrecision(6, 11),
    "conv3": LayerPrecision(8, 5), "fc0": LayerPrecision(7, 16),
    "fc1": LayerPrecision(8, 9)})


def subplanes(w_bits: int) -> int:
    """Launches of an int8-weight kernel per layer on a dynamic route: one
    per 7-bit subplane above Pw = 8 (``backend.sum_int8_subplanes``)."""
    return 1 if w_bits <= 8 else -(-w_bits // 7)




def phase_paper_model() -> None:
    """The cycle model's headline numbers: MODELED cycles of the paper's
    65 nm designs (host arithmetic), not measurements of this card."""
    from repro_torch.core import cyclemodel as cm
    s = cm.geomean_speedup("lm1b", "t3", "all")
    print(f"[paper] cycle model (modeled, not measured): Table 4 LM_1b "
          f"geomean speedup over DPNN {s:.4f}x (paper 4.38x), energy "
          f"efficiency {cm.efficiency('lm1b', s):.4f}x (paper 3.54x)")
    for profile in ("100", "t3"):
        curve = cm.scaling_curve("lm1b", profile)
        print(f"[paper] cycle model (modeled): Fig 5 LM_1b profile {profile}, "
              f"speedup by equivalent MACs/cycle: "
              f"{ {k: round(v, 4) for k, v in curve.items()} }")


def phase_paper_engine(x_bf16: torch.Tensor, w_bf16: torch.Tensor,
                       errs: dict) -> dict:
    """``engine.plane_matmul`` at the LM's layer-0 q projection (its input
    from one prefill, [M, K], and its dense weight [K, N]), every case of
    PAPER_ENGINE_CASES ``torch.equal`` to ``reference_int_matmul``; at
    (8, 8) also to ``ops.int8_matmul`` and to K1 on the packed weight.
    Times between CUDA events beside K1's and ``_int_mm``'s. Returns the
    K1 launches of the comparison."""
    from repro_torch.core import engine
    x2 = x_bf16.reshape(-1, x_bf16.shape[-1])
    m, k = x2.shape
    n = w_bf16.shape[1]
    k1_launches = 0
    for label, a_bits, w_bits, pb, mode in PAPER_ENGINE_CASES:
        xq, _ = q.quantize(x2.to(torch.float32), a_bits)
        wq, _ = q.quantize(w_bf16.to(torch.float32), w_bits)
        cfg = engine.LoomConfig(a_bits=a_bits, w_bits=w_bits, a_plane_bits=pb,
                                w_plane_bits=pb, mode=mode)
        a_range = (engine.plane_range(a_bits, pb) if mode == "serial_both"
                   else (q.qmin(a_bits), q.qmax(a_bits)))
        route = engine.product_route(k, a_range,
                                     engine.plane_range(w_bits, pb))
        got = engine.plane_matmul(xq, wq, cfg)
        want = engine.reference_int_matmul(xq, wq)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.shape == (m, n)
              and torch.equal(got, want), f"engine {label}: plane_matmul "
              f"differs from reference_int_matmul on the card (max abs err "
              f"{max_err(got, want)})")
        ms = cuda_ms(lambda: engine.plane_matmul(xq, wq, cfg), iters=5,
                     warmup=1)
        line = (f"[paper] engine {label} (Pa, Pw) = ({a_bits}, {w_bits}), "
                f"{cfg.n_a_planes} x {cfg.n_w_planes} plane passes, {route} "
                f"product, [{m}, {k}] x [{k}, {n}]: == reference_int_matmul "
                f"on the card; {ms:.4f} ms (CUDA events, mean of 5)")
        if (a_bits, w_bits) == (8, 8):
            x8, w8 = xq.to(torch.int8), wq.to(torch.int8)
            packed = bitpack.pack_weights(wq, 8)
            k1, _, got_k1 = counted_call(
                f"paper engine {label}", {"bitserial_matmul": 1},
                lambda: bitserial_matmul(x8, packed, w_bits=8))
            k1_launches += got_k1["bitserial_matmul"]
            mm = ops.int8_matmul(x8, w8)
            torch.cuda.synchronize()
            _hold(errs, "bitserial_matmul", k1, want,
                  f"K1 at the engine's (8, 8) {label} operands")
            check(torch.equal(got, mm), f"engine {label}: differs from "
                  f"ops.int8_matmul")
            k1_ms = cuda_ms(lambda: bitserial_matmul(x8, packed, w_bits=8),
                            iters=20)
            mm_ms = cuda_ms(lambda: ops.int8_matmul(x8, w8), iters=20)
            line += (f"; == ops.int8_matmul and K1; K1 {k1_ms:.4f} ms, "
                     f"_int_mm {mm_ms:.4f} ms (CUDA events, launched from "
                     f"Python)")
        print(line, flush=True)
    return {name: (k1_launches if name == "bitserial_matmul" else 0)
            for name in KERNELS}


def phase_paper_cnn(card: str, errs: dict) -> dict:
    """The paper CNN at full size: the Table 1 profile through fake_quant
    forwards on the card, dynamic and weight-group statistics, then the
    profiled mixed policy and a hand-set per-layer mix served
    ``serve_packed`` on the static and the ``dynamic_a`` paths."""
    from repro_torch.api.plan import build_plan
    from repro_torch.core import dynamic, policy as pol, profiler
    cfg = configs.get("paper_cnn")
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(PAPER_IMAGES, cfg.img, cfg.img, cfg.in_ch)).astype(
        np.float32)).cuda()
    names = cfg.layer_names
    t0 = time.perf_counter()
    with torch.inference_mode():
        base = cnn.forward(params, cfg, x, build_plan(cfg, mode="dense"))
        n_evals = [0]

        def eval_fn(p):
            n_evals[0] += 1
            lg = cnn.forward(params, cfg, x,
                             build_plan(cfg, p, mode="fake_quant"))
            return float(-torch.linalg.norm(lg - base)
                         / torch.linalg.norm(base))
        prof_a = profiler.profile_layer_precisions(
            eval_fn, names, tolerance=0.02, what="a_bits", min_bits=2)
        prof_w = profiler.profile_layer_precisions(
            eval_fn, names, tolerance=0.02, what="w_bits", min_bits=2)
        _, acts = cnn.forward(params, cfg, x, build_plan(cfg, mode="dense"),
                              collect_activations=True)
    search_s = time.perf_counter() - t0
    print(f"[paper] {card}: paper CNN ({PAPER_IMAGES} images, seed 1) Table 1 "
          f"profile on the card in {n_evals[0]} fake_quant forwards, "
          f"{search_s:.2f} s: Pa {'-'.join(str(prof_a[n]) for n in names)}, "
          f"Pw {'-'.join(str(prof_w[n]) for n in names)}", flush=True)
    fractions = {}
    for name in names:
        a = acts[name].reshape(-1)
        n = (a.shape[0] // 256) * 256
        xq, _ = q.quantize(a[:n].to(torch.float32), prof_a[name])
        st = dynamic.dynamic_stats(xq.reshape(-1, 256), prof_a[name], 256)
        wgp = profiler.measure_weight_group_precision(params[name]["w"],
                                                      prof_w[name])
        fractions[name] = float(st["plane_fraction_executed"])
        print(f"[paper] {name}: activations static {prof_a[name]}b -> "
              f"dynamic mean {float(st['mean_effective_bits']):.4f}b "
              f"(x{fractions[name]:.4f} of the planes, groups of 256); "
              f"weights static {prof_w[name]}b -> per-group mean "
              f"{wgp['mean_effective_bits']:.4f}b over {wgp['n_groups']} "
              f"groups of 16 filters")
    cvl = [fractions[c.name] for c in cfg.convs]
    print(f"[paper] measured dynamic ratio (mean plane fraction): CVLs "
          f"{sum(cvl) / len(cvl):.4f}, all layers "
          f"{sum(fractions.values()) / len(fractions):.4f}, beside the "
          f"cycle model's DYN_RATIO 0.80 (Lascorz et al.)")

    # The mixed policy, Pa capped at 8 (the kernels take int8 activations).
    mixed = pol.PrecisionPolicy(
        default=pol.LayerPrecision(8, 8),
        per_layer={n: pol.LayerPrecision(min(prof_a[n], 8), prof_w[n])
                   for n in names})
    sess, cpu, launches = paper_cnn_paths("paper CNN", cfg, params, x, mixed,
                                          errs)
    stats = {}
    for layer in (cfg.convs[-1].name, "fc0"):
        a = acts[layer]
        on_card = sess.dynamic_stats(a, layer)
        on_cpu = cpu.dynamic_stats(a.cpu(), layer)
        for key, v in on_card.items():
            same_v = (torch.equal(v.cpu(), on_cpu[key])
                      if isinstance(v, torch.Tensor) else v == on_cpu[key])
            check(same_v, f"paper CNN session.dynamic_stats({layer}) {key}: "
                  f"card {v} against CPU {on_cpu[key]}")
        stats[layer] = round(float(on_card["plane_fraction_executed"]), 4)
    print(f"[paper] paper CNN: session.dynamic_stats on the card == the CPU "
          f"session's (plane fraction {stats})", flush=True)
    # The profile on random weights is uniform; a hand-set per-layer mix
    # (Pa 6-8, Pw 5-16) sends K1/K2 down their packed and wide-plane
    # routes layer by layer.
    _, _, mix_launches = paper_cnn_paths("paper CNN hand-set mix", cfg,
                                         params, x, PAPER_CNN_MIX, errs)
    launches.update(mix_launches)
    return launches


def paper_cnn_paths(label: str, cfg, params, x: torch.Tensor, policy,
                    errs: dict) -> tuple:
    """``policy`` served ``serve_packed`` on the card, static and then
    ``dynamic_a``, with the counts reset just before each request and held
    to the plan's (static) or one launch per 7-bit subplane (``dynamic_a``)
    just after, every kernel call held against its plain version at the
    shapes it got, the static logits ``torch.equal`` to a ``torch_ref``
    twin's and a CPU session's, ``dynamic_a``'s to the static ones.
    Returns (the static session, the CPU session, launches by path)."""
    sess = repro_torch.compile(cfg, policy, mode="serve_packed",
                               backend="cuda", params=params, device="cuda")
    expect = plan_launches(sess.plan)
    sess.classify(x)                                      # warm-up
    with recorded_calls(distinct=True) as calls:
        y, ms, static = counted_call(label, expect, lambda: sess.classify(x))
    held = hold_path_calls(errs, calls, label)
    check(y.shape == (x.shape[0], 10) and bool(torch.isfinite(y).all()),
          f"{label} logits {tuple(y.shape)}")
    twin = twin_session(sess, "torch_ref")
    check(torch.equal(y, twin.classify(x)),
          f"{label}: cuda logits differ from the torch_ref twin's")
    cpu = repro_torch.compile(cfg, policy, mode="serve_packed",
                              backend="torch_ref", params=params,
                              device="cpu")
    small = x[:16]
    check(torch.equal(sess.classify(small).cpu(), cpu.classify(small.cpu())),
          f"{label}: cuda logits differ from a CPU session's")
    counts = {name: list(lp.w_group_counts)
              for (name, kind), lp in sess.plan.layers.items()
              if lp.w_group_counts is not None and not (
                  kind == "linear" and (name, "conv") in sess.plan.layers)}
    bits = [(policy.lookup(n).a_bits, policy.lookup(n).w_bits)
            for n in cfg.layer_names]
    print(f"[paper] {label} (Pa, Pw) {bits}: cuda == torch_ref twin "
          f"({x.shape[0]} images) == CPU session (16 images); {ms:.4f} ms a "
          f"request (CUDA events); launches "
          f"{ {k: v for k, v in static.items() if v} } as the recorded "
          f"weight-group counts imply: {counts}; == plain: {held}",
          flush=True)

    dyn = repro_torch.compile(cfg, dataclasses.replace(policy, dynamic_a=True),
                              mode="serve_packed", backend="cuda",
                              params=params, device="cuda")
    dyn_expect = {
        "bitserial_conv_dynamic": sum(subplanes(policy.lookup(c.name).w_bits)
                                      for c in cfg.convs),
        "bitserial_matmul_dynamic": sum(
            subplanes(policy.lookup(f"fc{i}").w_bits)
            for i in range(len(cfg.fcs)))}
    dyn.classify(x)                                       # warm-up
    with recorded_calls(distinct=True) as dcalls:
        yd, dms, dynamic_launches = counted_call(
            f"{label} dynamic_a", dyn_expect, lambda: dyn.classify(x))
    dheld = hold_path_calls(errs, dcalls, f"{label} dynamic_a")
    check(torch.equal(yd, y), f"{label} dynamic_a logits differ from the "
          f"static path's")
    print(f"[paper] {label} dynamic_a: logits == static bit for bit; "
          f"{dms:.4f} ms a request (CUDA events); launches "
          f"{ {k: v for k, v in dynamic_launches.items() if v} } (K5 and K3 "
          f"once per 7-bit subplane above Pw 8); == plain: {dheld}",
          flush=True)
    return sess, cpu, {label: static, f"{label} dynamic_a": dynamic_launches}


def phase_paper_lm(card: str, errs: dict) -> dict:
    """qwen3-1.7b at full width and depth: the per-class profile search,
    the mixed-Pw policy served ``serve_packed`` (a prefill and PAPER_GEN -
    1 greedy decode steps), every step's logits and tokens ``cuda`` ==
    ``torch_ref``, K1 + K3 197 times per call; the engine at layer 0's q
    projection. Returns the launches by path and the peak device memory
    up to the serving (the phase's CNN, the profile search, compile and
    warm-up; the serving's own peak is printed apart)."""
    from repro_torch.api.backend import _trims
    from repro_torch.examples import precision_profiles as pp
    cfg = configs.get("qwen3-1.7b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, PAPER_LM_TOKENS)).cuda()
    t0 = time.perf_counter()
    with torch.inference_mode():
        _, prof_a, prof_w, n_evals = pp.profile_classes(params, cfg, toks)
    search_s = time.perf_counter() - t0
    mixed = pp.mixed_policy(prof_a, prof_w)
    served = {c: (mixed.lookup(c).a_bits, mixed.lookup(c).w_bits)
              for c in pp.CLASSES}
    print(f"[paper] {card}: {cfg.name} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}) per-class profile on {PAPER_LM_TOKENS[0]} x "
          f"{PAPER_LM_TOKENS[1]} tokens (seed 0) in {n_evals} fake_quant "
          f"forwards, {search_s:.2f} s; (Pa, Pw) served: {served}",
          flush=True)
    dense = repro_torch.compile(cfg, mode="dense", params=params,
                                device="cuda")
    sess = repro_torch.compile(cfg, mixed, mode="serve_packed",
                               backend="cuda", params=params, device="cuda")
    ref = twin_session(sess, "torch_ref")
    head = sess.plan.layer("lm_head")
    n_k3 = 1 if _trims(head.w_group_counts, head.w_bits) else 0
    n_lin = 7 * cfg.n_layers + 1
    expect = {"bitserial_matmul": n_lin - n_k3,
              "bitserial_matmul_dynamic": n_k3}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).cuda()
    max_seq = LM_PROMPT + PAPER_GEN

    # Layer 0's q projection: its input and dense weight, for the engine.
    layer0 = lm_layer0_operands(dense, tokens)
    q_in, q_w = layer0["q_in"], layer0["q_w"]
    del layer0
    dcache = dense.init_cache(LM_BATCH, max_seq)
    dense_y, dcache = dense.prefill(tokens, dcache)

    sess.prefill(tokens, sess.init_cache(LM_BATCH, max_seq))   # warm-up
    setup_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    caches = {"cuda": sess.init_cache(LM_BATCH, max_seq),
              "torch_ref": ref.init_cache(LM_BATCH, max_seq)}
    total = {name: 0 for name in KERNELS}
    with recorded_calls(distinct=True) as calls:
        (y, caches["cuda"]), pre_ms, got = counted_call(
            "paper LM prefill", expect,
            lambda: sess.prefill(tokens, caches["cuda"]))
    for name in total:
        total[name] += got[name]
    y_ref, caches["torch_ref"] = ref.prefill(tokens, caches["torch_ref"])
    check(y.shape == (LM_BATCH, 1, cfg.vocab) and bool(torch.isfinite(y).all())
          and torch.equal(y, y_ref), "paper LM prefill: cuda logits differ "
          "from torch_ref (or are not finite)")
    tok = torch.argmax(y[:, 0], dim=-1)
    logits, dense_logits, dec_ms = [y[:, 0]], [dense_y[:, 0]], []
    toks_out = [tok]
    for i in range(PAPER_GEN - 1):
        # The first step's calls are held too: the decode's shapes (M = 2).
        with recorded_calls(distinct=True) as step_calls:
            (y, caches["cuda"]), ms, got = counted_call(
                f"paper LM decode {i}", expect,
                lambda: sess.decode(tok, LM_PROMPT + i, caches["cuda"]))
        if i == 0:
            calls += step_calls
        for name in total:
            total[name] += got[name]
        y_ref, caches["torch_ref"] = ref.decode(tok, LM_PROMPT + i,
                                                caches["torch_ref"])
        check(torch.equal(y, y_ref), f"paper LM decode step {i}: cuda logits "
              f"differ from torch_ref")
        dy, dcache = dense.decode(tok, LM_PROMPT + i, dcache)
        logits.append(y)
        dense_logits.append(dy)
        dec_ms.append(ms)
        tok = torch.argmax(y, dim=-1)
        check(torch.equal(tok, torch.argmax(y_ref, dim=-1)),
              f"paper LM decode step {i}: tokens differ from torch_ref's")
        toks_out.append(tok)
    peak = torch.cuda.max_memory_allocated()
    held = hold_path_calls(errs, calls, "paper LM")
    del calls
    corr = pp.corr(torch.stack(logits), torch.stack(dense_logits))
    packed_b, dense_b = _param_bytes(sess.params), _param_bytes(params)
    print(f"[paper] {cfg.name} mixed-Pw serve_packed: prefill {LM_BATCH} x "
          f"{LM_PROMPT} and {PAPER_GEN - 1} decode steps, cuda == torch_ref "
          f"on every step's logits and tokens (first row "
          f"{torch.stack(toks_out, 1)[0].tolist()}); K1 "
          f"{expect['bitserial_matmul']} + K3 {n_k3} launches per call "
          f"(lm_head counts {'below' if n_k3 else 'all at'} Pw); prefill "
          f"{pre_ms:.3f} ms, decode {sorted(dec_ms)[len(dec_ms) // 2]:.3f} "
          f"ms/step (median of {len(dec_ms)}; CUDA events); packed weights "
          f"{packed_b} B against dense {dense_b} B "
          f"({packed_b / dense_b:.4f}x); logits' correlation to the dense "
          f"model's (fed the same tokens) {corr:.6f}; peak device memory "
          f"while serving {peak / 2**30:.3f} GiB; == plain: {held}",
          flush=True)
    check(corr > 0.97, f"paper LM: logit correlation {corr} to dense")
    del ref, caches, dcache, dense, sess, params
    engine_launches = phase_paper_engine(q_in, q_w, errs)
    return {"paper LM": total, "paper engine": engine_launches}, setup_peak


def phase_paper(card: str, errs: dict) -> dict:
    """The paper's evaluation: the cycle model's modeled numbers, the
    profiled CNN and LM on the card, the plane-width engine and the three
    examples. Returns the launches by path."""
    from repro_torch.examples import (precision_profiles, quickstart,
                                      serve_quantized)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    phase_paper_model()
    out = phase_paper_cnn(card, errs)
    lm_launches, setup_peak = phase_paper_lm(card, errs)
    out.update(lm_launches)
    t0 = time.perf_counter()
    reset_launches()
    with recorded_calls() as calls:
        for example in (quickstart, precision_profiles, serve_quantized):
            example.main(device="cuda")
    torch.cuda.synchronize()
    out["paper examples"] = read_launches()
    check(out["paper examples"]["bitserial_matmul"] > 0,
          "the examples launched no K1")
    held = hold_path_calls(errs, calls, "paper examples")
    print(f"[paper] the three examples ran on the card with their asserts "
          f"held in {time.perf_counter() - t0:.2f} s; launches "
          f"{ {k: v for k, v in out['paper examples'].items() if v} }; every "
          f"call == plain: {held}")
    del calls
    phase_peak = max(setup_peak, torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    print(f"[paper] {card}: phase took {time.perf_counter() - t_phase:.1f} s, "
          f"peak device memory {phase_peak / 2**30:.3f} GiB (of which "
          f"{base / 2**30:.3f} GiB held before the phase)", flush=True)
    return out


# The dist phase: the port served on a ("data", "model") device mesh of
# torch.distributed ranks (ROADMAP A.13a). (a) World size 1 on NCCL, mesh
# (1, 1), in this process. (b) Ranks spawned on the one card over gloo
# (NCCL refuses two ranks on one device): a 2-rank world serves mesh
# (1, 2) and restores (d)'s checkpoint onto it; a 4-rank world serves
# (2, 2) and (c), deepseek-moe-16b cut to its first DIST_MOE_LAYERS layers
# on (1, 4), 16 local experts a rank. qwen3-1.7b at published width and
# depth, serve_packed (8, 8), seed-0 weights, phase_lm's prompts: a
# prefill and DIST_STEPS greedy decode steps whose logits on every rank
# equal the unsharded session's rows (torch.equal), then a dynamic_a
# prefill (K3) equal to them too. (d): qwen3-1.7b's dense tree at
# published width cut to DIST_CKPT_LAYERS layers (the whole depth's 4 GB
# would take the phase's budget to write), restored with shardings=.
DIST_STEPS = 4
DIST_MOE_LAYERS = 4
DIST_CKPT_LAYERS = 2
DIST_TIMEOUT_S = 240
DIST_LABEL = "gloo on one H100, transport through the host"
# Training on the mesh, in the same spawned worlds after
# their serving: qwen3-1.7b at published width cut to DIST_TRAIN_LAYERS
# of its 28 layers (remat "none",
# float32 moments) on (1, 2) in dense and fake_quant (8, 8) and on (2, 2)
# in dense ("fsdp" dims over "data"), deepseek-moe-16b's first
# DIST_MOE_LAYERS layers on (1, 4) dense (16 experts a rank); a global
# batch of DIST_TRAIN_BATCH x DIST_TRAIN_SEQ tokens (the data pipeline's
# step j), a first step and DIST_TRAIN_STEPS timed ones. The first step's
# loss and grad norm are held within DIST_LOSS_RTOL and DIST_NORM_RTOL of
# the unsharded ones on the same batch (the parent's loss and gradients
# on the card, without the optimizer, whose state the parent has no room
# for beside the earlier phases'; a (1, 1) NCCL mesh's within them too),
# every loss and grad norm finite, no kernel of the port launched.
DIST_TRAIN_BATCH, DIST_TRAIN_SEQ, DIST_TRAIN_STEPS = 4, 256, 1
DIST_TRAIN_LAYERS = 14
# Three times the largest relative difference measured on the card
# (4.85e-4: (1, 2) fake_quant).
DIST_LOSS_RTOL = 1.5e-3
# The first step's grad norm (before the clip), which reads every
# gradient the backward's collectives carry: three times the largest
# relative difference from the unsharded one measured on the card
# (1.262e-3: (2, 2) dense; 7.75e-4 (1, 2) dense, 2.83e-4 fake_quant,
# 2.27e-4 deepseek (1, 4)).
DIST_NORM_RTOL = 3.8e-3
DIST_TRAIN_RUNS = {2: [("qwen", "dense", "(1, 2)"),
                       ("qwen", "fake_quant", "(1, 2)")],
                   4: [("qwen", "dense", "(2, 2)"),
                       ("moe", "dense", "(1, 4)")]}
# Each rank's peak over the steps when every rank was handed the global
# batch (this script's last run before the step took the rank's rows;
# H100 80GB HBM3, 700 W; the largest over the ranks): printed beside
# this run's.
DIST_TRAIN_PEAK_BEFORE_GIB = {"(1, 2) qwen3-1.7b dense": 16.665,
                              "(1, 2) qwen3-1.7b fake_quant": 16.665,
                              "(2, 2) qwen3-1.7b dense": 8.218,
                              "(1, 4) deepseek-moe-16b dense": 16.223}
# The train CLI (``python -m repro_torch.launch.train``, its ``main``
# called in-process) on the 2-rank world after the world's other runs: a
# (2, 1) mesh of the one card over gloo, qwen3-1.7b's smoke config (the
# CLI trains smoke configs, as the reference's does), CLI_STEPS steps
# checkpointed every CLI_CKPT_EVERY, resumed from the first checkpoint to
# CLI_RESUME_TO steps, and an uninterrupted CLI_RESUME_TO-step run. Every
# loss of the first run within DIST_LOSS_RTOL of the same CLI's at a
# world of one (this process, NCCL, before the spawn); the resumed run's
# losses equal the uninterrupted run's; no kernel of the port launched.
CLI_ARGS = ["--device", "cuda", "--arch", "qwen3-1.7b", "--batch", "4",
            "--seq", "64"]
CLI_STEPS, CLI_CKPT_EVERY, CLI_RESUME_TO = 6, 3, 8


def _free_port() -> int:
    import socket
    with socket.socket() as s_:
        s_.bind(("localhost", 0))
        return s_.getsockname()[1]


def _dist_expect(sess, tokens, max_seq: int) -> list:
    """The unsharded session's logits: a prefill and DIST_STEPS greedy
    decode steps (on the host)."""
    cache = sess.init_cache(tokens.shape[0], max_seq)
    logits, cache = sess.prefill(tokens, cache)
    out = [logits]
    for i in range(DIST_STEPS):
        tok = torch.argmax(out[-1].reshape(tokens.shape[0], -1), dim=-1)
        logits, cache = sess.decode(tok, tokens.shape[1] + i, cache)
        out.append(logits)
    return [t.cpu() for t in out]


def _moe_cut(smoke: bool = False):
    """deepseek-moe-16b's first DIST_MOE_LAYERS layers (``smoke``: its
    smoke config, for a short rehearsal of the phase)."""
    if smoke:
        return configs.get("deepseek-moe-16b", smoke=True)
    full = configs.get("deepseek-moe-16b")
    return dataclasses.replace(full, n_layers=DIST_MOE_LAYERS,
                               pattern=full.pattern[:DIST_MOE_LAYERS])


def _dist_serve(mesh, cfg, tokens, expect: list, max_seq: int, errs: dict,
                label: str) -> dict:
    """``cfg`` compiled on ``mesh`` (seed-0 weights drawn on the card, each
    rank packing its own shards) and served: a warm-up prefill, then a
    prefill and DIST_STEPS decode steps with the counts reset just before,
    each step's logits torch.equal to ``expect``'s rows; K1 once per
    Loom linear and step, nothing else; then a dynamic_a prefill (K3 once
    per linear) equal to them. Every kernel call of both runs is held
    against its plain version at its shard shape, after the counts are
    read. Returns this rank's numbers."""
    sess = repro_torch.compile(
        cfg, uniform_policy(8, 8), mode="serve_packed",
        generator=torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
    rows = sess.rows(tokens.shape[0])
    want = [t.cuda()[rows] for t in expect]
    n_pre, n_dec = loom_linears(cfg, decode=False), loom_linears(cfg, True)
    sess.prefill(tokens, sess.init_cache(tokens.shape[0], max_seq))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cache = sess.init_cache(tokens.shape[0], max_seq)
    reset_launches()
    dec_ms = []
    with recorded_calls(distinct=True) as calls:
        (logits, cache), pre_ms = _event_ms(
            lambda: sess.prefill(tokens, cache))
        check(torch.equal(logits, want[0]), f"dist {label}: prefill logits "
              f"differ from the unsharded session's (max abs err "
              f"{max_err(logits, want[0])})")
        for i in range(DIST_STEPS):
            tok = torch.argmax(expect[i].cuda().reshape(tokens.shape[0], -1),
                               dim=-1)
            (logits, cache), ms = _event_ms(
                lambda: sess.decode(tok, tokens.shape[1] + i, cache))
            dec_ms.append(ms)
            check(torch.equal(logits, want[i + 1]), f"dist {label}: decode "
                  f"step {i} logits differ from the unsharded session's "
                  f"(max abs err {max_err(logits, want[i + 1])})")
    launches = read_launches()
    lm_step_launches(f"dist {label}", launches, {
        "bitserial_matmul": n_pre + DIST_STEPS * n_dec})
    peak = torch.cuda.max_memory_allocated()
    held = hold_path_calls(errs, calls, f"dist {label}")
    del cache
    dyn = twin_session(sess, "cuda", uniform_policy(8, 8, dynamic_a=True))
    reset_launches()
    with recorded_calls(distinct=True) as dcalls:
        (dlogits, _), dyn_ms = _event_ms(lambda: dyn.prefill(
            tokens, dyn.init_cache(tokens.shape[0], max_seq)))
    dyn_launches = read_launches()
    lm_step_launches(f"dist {label} dynamic_a", dyn_launches,
                     {"bitserial_matmul_dynamic": n_pre})
    check(torch.equal(dlogits, want[0]), f"dist {label}: the dynamic_a "
          f"prefill differs from the static one")
    counts = [c.float().mean().item() for name, a, _ in dcalls
              if name == "bitserial_matmul_dynamic" for c in a[2:3]]
    dheld = hold_path_calls(errs, dcalls, f"dist {label} dynamic_a")
    return {"label": label, "rank": dist_rank(), "prefill_ms": pre_ms,
            "decode_ms": float(np.median(dec_ms)),
            "dyn_prefill_ms": dyn_ms, "peak_gib": peak / 2**30,
            "launches": launches, "dyn_launches": dyn_launches,
            "k3_mean_planes": float(np.mean(counts)), "held": held,
            "dyn_held": dheld, "collectives": {
                f"{op} {str(dt).replace('torch.', '')} {red or ''}".strip(): n
                for (op, dt, red), n in sorted(
                    sess.shard.comm.calls.items(), key=str)}}


def _train_cfgs(smoke: bool) -> dict:
    """The dist phase's training configs: qwen3-1.7b at DIST_TRAIN_LAYERS
    layers and the deepseek cut, remat "none" (``smoke``: the smoke
    configs)."""
    qwen = configs.get("qwen3-1.7b", smoke=smoke)
    if not smoke:
        qwen = dataclasses.replace(qwen, n_layers=DIST_TRAIN_LAYERS)
    return {"qwen": dataclasses.replace(qwen, remat="none"),
            "moe": dataclasses.replace(_moe_cut(smoke), remat="none")}


def _train_batches(cfg, n: int, rows=None) -> list:
    """The data pipeline's first ``n`` batches: ``rows`` of each (all of
    them when None)."""
    from repro_torch.data import DataConfig, synthetic_batch
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=DIST_TRAIN_SEQ,
                      global_batch=DIST_TRAIN_BATCH)
    return [synthetic_batch(dcfg, i, rows) for i in range(n)]


def _train_tc():
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import Schedule
    return train_mod.TrainConfig(sched=Schedule(warmup_steps=1,
                                                total_steps=10))


def _dist_train_expect(smoke: bool, mesh=None) -> dict:
    """The first step's loss and grad norm (before the clip) of every
    training run of DIST_TRAIN_RUNS, seed-0 params drawn on the card:
    {"<model> <mode>": [loss, grad norm]}; on a ``mesh`` (the (1, 1) NCCL
    one) through ``mesh_value_and_grad`` and the sharded norm. Neither
    needs the optimizer's state, so the card holds the params, their
    gradients and the activations alone."""
    from repro_torch.api.plan import build_plan
    from repro_torch.dist.parallel import ShardCtx
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import global_norm
    cfgs, out = _train_cfgs(smoke), {}
    for model, mode in sorted({(m, md) for runs in DIST_TRAIN_RUNS.values()
                               for m, md, _ in runs}):
        cfg = cfgs[model]
        plan = build_plan(cfg, uniform_policy(8, 8), mode)
        params = M.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        batch = train_mod.batch_on(_train_batches(cfg, 1)[0], "cuda")
        if mesh is None:
            loss, _, grads = train_mod.value_and_grad(params, cfg, batch,
                                                      plan)
            norm = global_norm(grads)
        else:
            shard, specs = ShardCtx(mesh), M.param_spec_tree(cfg)
            loss, _, grads = train_mod.mesh_value_and_grad(
                params, cfg, batch, plan, shard, specs)
            norm = global_norm(grads, shard, specs)
        out[f"{model} {mode}"] = [float(loss), float(norm)]
        del params, grads
        torch.cuda.empty_cache()
    return out


def _dist_train(mesh, model: str, mode: str, label: str, expect: dict,
                smoke: bool) -> dict:
    """One training run of the dist phase on ``mesh``: this rank's shards
    of the seed-0 state, a first step (its loss held to ``expect``'s)
    and DIST_TRAIN_STEPS timed ones (CUDA events), the kernel counts
    reset just before the steps and read just after. Returns this rank's
    numbers: step ms, peak memory, the collectives of a step by kind."""
    from repro_torch.api.plan import build_plan
    from repro_torch.launch import train as train_mod
    cfg, tc = _train_cfgs(smoke)[model], _train_tc()
    plan = build_plan(cfg, uniform_policy(8, 8), mode)
    torch.cuda.empty_cache()
    state, specs = train_mod.make_train_state(
        cfg, tc, torch.Generator(device="cuda").manual_seed(0), "cuda",
        mesh=mesh)
    state_bytes = _param_bytes(state)
    step = train_mod.jit_train_step(cfg, plan, tc, mesh, specs,
                                    train_mod.batch_specs(cfg))
    rows = train_mod.batch_rows(DIST_TRAIN_BATCH, tc, step.shard)
    batches = _train_batches(cfg, 1 + DIST_TRAIN_STEPS, rows)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (state, m), first_ms = _event_ms(lambda: step(state, batches[0]))
    metrics = [m]
    comm = step.shard.comm
    comm.calls.clear()
    comm.bytes.clear()
    step_ms = []
    for b in batches[1:]:
        (state, m), ms = _event_ms(lambda: step(state, b))
        metrics.append(m)
        step_ms.append(ms)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    want, want_norm = expect[f"{model} {mode}"]
    name = f"dist train {label} {cfg.name} {mode}"
    check(all(np.isfinite(losses + norms)), f"{name}: losses {losses}, "
          f"grad norms {norms}")
    check(abs(losses[0] - want) <= DIST_LOSS_RTOL * abs(want),
          f"{name}: first-step loss {losses[0]!r}, the unsharded step's "
          f"{want!r} (limit {DIST_LOSS_RTOL} relative)")
    check(abs(norms[0] - want_norm) <= DIST_NORM_RTOL * abs(want_norm),
          f"{name}: first-step grad norm {norms[0]!r}, the unsharded "
          f"step's {want_norm!r} (limit {DIST_NORM_RTOL} relative)")
    check(not any(launches.values()), f"{name}: the training path launched "
          f"kernels of the port: {launches}")
    del state, step
    torch.cuda.empty_cache()

    def kind(key):
        op, dt, red = key
        return f"{op} {str(dt).replace('torch.', '')} {red or ''}".strip()
    return {"label": f"{label} {cfg.name} {mode}", "rank": dist_rank(),
            "rows": len(rows),
            "layers": cfg.n_layers, "state_gib": state_bytes / 2**30,
            "first_ms": first_ms, "step_ms": float(np.median(step_ms)),
            "peak_gib": peak / 2**30, "losses": losses, "grad_norms": norms,
            "want": [want, want_norm],
            "loss_err": abs(losses[0] - want) / abs(want),
            "norm_err": abs(norms[0] - want_norm) / abs(want_norm),
            "launches": launches, "collectives": {
                kind(k): [n / DIST_TRAIN_STEPS,
                          comm.bytes[k] / DIST_TRAIN_STEPS / 2**20]
                for k, n in sorted(comm.calls.items(), key=str)}}


def _print_dist_train(r: dict, card: str) -> None:
    coll = ", ".join(f"{k} x{n:g} ({mib:.1f} MiB)"
                     for k, (n, mib) in r["collectives"].items())
    before = DIST_TRAIN_PEAK_BEFORE_GIB.get(r["label"])
    print(f"[dist] train {r['label']} rank {r['rank']} ({card}; "
          f"{r['transport']}): {r['layers']} layers, state "
          f"{r['state_gib']:.3f} GiB a rank; {DIST_TRAIN_BATCH} x "
          f"{DIST_TRAIN_SEQ} tokens a step, {r['rows']} rows handed to "
          f"this rank: first step {r['first_ms']:.1f} "
          f"ms, step {r['step_ms']:.1f} ms (median of {DIST_TRAIN_STEPS}, "
          f"CUDA events), peak {r['peak_gib']:.3f} GiB (with the global "
          f"batch on every rank: {before if before else 'n/a'} GiB); losses "
          f"{[round(x, 5) for x in r['losses']]}, grad norms "
          f"{[round(x, 4) for x in r['grad_norms']]}; first loss "
          f"{r['losses'][0]!r} against the unsharded step's "
          f"{r['want'][0]!r} (relative {r['loss_err']:.3g}, limit "
          f"{DIST_LOSS_RTOL}); first grad norm {r['grad_norms'][0]!r} "
          f"against {r['want'][1]!r} (relative {r['norm_err']:.3g}, limit "
          f"{DIST_NORM_RTOL}); kernels of the port launched 0 times; "
          f"collectives a step: {coll or 'none'}", flush=True)


def dist_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _ckpt_cfg(smoke: bool):
    return dataclasses.replace(configs.get("qwen3-1.7b", smoke=smoke),
                               n_layers=DIST_CKPT_LAYERS)


def _dist_ckpt(mesh, tmp: str, smoke: bool) -> dict:
    """(d): the dense checkpoint restored with ``shardings=`` equals the
    unsharded restore's slices, leaf for leaf."""
    from repro_torch.dist import sharding
    cfg = _ckpt_cfg(smoke)
    skel, specs = M.param_skeleton(cfg), M.param_spec_tree(cfg)
    t0 = time.perf_counter()
    got, step = ckpt.restore_checkpoint(
        os.path.join(tmp, "ckpt"), 0, skel, device="cuda",
        shardings=sharding.named_tree(specs, mesh))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    whole, _ = ckpt.restore_checkpoint(os.path.join(tmp, "ckpt"), 0, skel,
                                       device="cuda")
    want = interop.flatten_with_paths(sharding.shard_tree(whole, specs, mesh))
    flat = interop.flatten_with_paths(got)
    for key, t in flat.items():
        check(torch.equal(t, want[key]), f"dist ckpt: leaf {key} is not the "
              f"slice of the unsharded restore")
    return {"leaves": len(flat), "restore_s": restore_s,
            "bytes": sum(t.numel() * t.element_size() for t in flat.values())}


def _dist_cli(tmp: str) -> dict:
    """The train CLI's three runs on the joined world (CLI_ARGS above),
    the kernel counts reset just before and read just after: {"run",
    "resumed", "whole": [[step, loss], ...], "seconds", "launches"}."""
    import torch.distributed as dist
    from repro_torch.launch import train as train_mod
    d = os.path.join(tmp, "cli_ckpt")
    ckpt_args = ["--ckpt-dir", d, "--ckpt-every", str(CLI_CKPT_EVERY)]
    t0 = time.perf_counter()
    reset_launches()
    run = train_mod.main(CLI_ARGS + ["--steps", str(CLI_STEPS)] + ckpt_args)
    if dist.get_rank() == 0:         # the resume starts at the first one
        for name in os.listdir(d):
            if name != f"step_{CLI_CKPT_EVERY:08d}":
                shutil.rmtree(os.path.join(d, name))
    dist.barrier()
    resumed = train_mod.main(CLI_ARGS + ["--steps", str(CLI_RESUME_TO)]
                             + ckpt_args)
    whole = train_mod.main(CLI_ARGS + ["--steps", str(CLI_RESUME_TO)])
    launches = read_launches()
    return {"run": sorted(run.items()), "resumed": sorted(resumed.items()),
            "whole": sorted(whole.items()), "launches": launches,
            "seconds": time.perf_counter() - t0}


def _check_cli(cli: dict, one: dict, card: str) -> dict:
    """Holds the 2-rank CLI's runs (:func:`_dist_cli`, rank 0's) to the
    world-one CLI's losses ``one`` and prints them; returns the launches."""
    run, resumed, whole = (dict(cli[k]) for k in ("run", "resumed",
                                                    "whole"))
    check(sorted(run) == sorted(one) == list(range(CLI_STEPS))
          and all(np.isfinite(list(run.values()))), f"dist train CLI (2, 1):"
          f" losses {run}, at a world of one {one}")
    err = max(abs(run[s] - one[s]) / abs(one[s]) for s in one)
    check(err <= DIST_LOSS_RTOL, f"dist train CLI (2, 1): losses {run}, at "
          f"a world of one {one} (limit {DIST_LOSS_RTOL} relative)")
    tail = list(range(CLI_CKPT_EVERY, CLI_RESUME_TO))
    check(sorted(resumed) == tail and all(resumed[s] == whole[s]
                                          for s in tail),
          f"dist train CLI (2, 1): the resumed run's losses {resumed} are "
          f"not the uninterrupted run's {whole}")
    check(not any(cli["launches"].values()), f"dist train CLI: the training "
          f"path launched kernels of the port: {cli['launches']}")
    print(f"[dist] train CLI (2, 1) qwen3-1.7b smoke ({card}; {DIST_LABEL}):"
          f" {CLI_STEPS} steps, losses {run}; at a world of one {one} "
          f"(largest relative difference {err:.3g}, limit {DIST_LOSS_RTOL});"
          f" resumed at step {CLI_CKPT_EVERY} to {CLI_RESUME_TO}: losses "
          f"{resumed} equal the uninterrupted run's; three runs in "
          f"{cli['seconds']:.1f} s; kernels of the port launched 0 times",
          flush=True)
    return cli["launches"]


def _dist_rank(rank: int, world: int, port: int, tmp: str,
               smoke: bool) -> None:
    """One spawned rank of the dist phase; writes ``rank<r>_<world>.json``."""
    from repro_torch.dist import init_process
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = init_process(rank, world, port, "cuda", timeout_s=DIST_TIMEOUT_S)
    expect = torch.load(os.path.join(tmp, "expect.pt"))
    tokens = expect["tokens"].cuda()
    max_seq = tokens.shape[1] + DIST_STEPS + 1
    errs = {k: 0 for k in KERNELS}
    runs, extra = [], {}
    qwen = configs.get("qwen3-1.7b", smoke=smoke)
    meshes = {"(1, 2)": (1, 2), "(2, 2)": (2, 2), "(1, 4)": (1, 4)}
    if world == 2:
        mesh = make_host_mesh(2, model=2, device="cuda")
        runs.append(_dist_serve(mesh, qwen, tokens, expect["qwen"], max_seq,
                                errs, "(1, 2)"))
        extra["ckpt"] = _dist_ckpt(mesh, tmp, smoke)
    else:
        mesh = make_host_mesh(4, model=2, device="cuda")
        runs.append(_dist_serve(mesh, qwen, tokens, expect["qwen"], max_seq,
                                errs, "(2, 2)"))
        mesh = make_host_mesh(4, model=4, device="cuda")
        runs.append(_dist_serve(mesh, _moe_cut(smoke),
                                expect["moe_tokens"].cuda(), expect["moe"],
                                max_seq, errs, "(1, 4) deepseek"))
    train = []
    for model, mode, label in DIST_TRAIN_RUNS[world]:
        mesh = make_host_mesh(world, model=meshes[label][1], device="cuda")
        train.append(_dist_train(mesh, model, mode, label, expect["train"],
                                 smoke))
    if world == 2:
        extra["cli"] = _dist_cli(tmp)
    with open(os.path.join(tmp, f"rank{rank}_{world}.json"), "w") as f:
        json.dump({"backend": backend, "runs": runs, "train": train,
                   "errs": errs, **extra}, f)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def _print_dist(r: dict, card: str) -> None:
    la, dl = r["launches"], r["dyn_launches"]
    print(f"[dist] {r['label']} rank {r['rank']} ({card}; {r['transport']}): "
          f"prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms']:.3f} "
          f"ms/step (median of {DIST_STEPS}), dynamic_a prefill "
          f"{r['dyn_prefill_ms']:.3f} ms, peak {r['peak_gib']:.3f} GiB; K1 "
          f"{la['bitserial_matmul']}, K3 {dl['bitserial_matmul_dynamic']} "
          f"(mean activation planes {r['k3_mean_planes']:.3f}); "
          f"collectives since compile {r['collectives'] or 'none'}; held: "
          f"{r['held']}; {r['dyn_held']}")


def phase_dist(lm: dict, card: str, errs: dict, smoke: bool = False) -> dict:
    """The dist phase (see DIST_STEPS above); returns the launches by path
    (rank 0's of each spawned mesh). ``smoke``: the smoke configs (``lm``
    then holds a smoke qwen3 session), a rehearsal of the phase."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from repro_torch.dist import init_process
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    sess, tokens = lm["sess"], lm["tokens"]
    qwen = sess.cfg
    max_seq = tokens.shape[1] + DIST_STEPS + 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        expect = {"tokens": tokens.cpu(),
                  "qwen": _dist_expect(sess, tokens, max_seq)}
        moe_cfg = _moe_cut(smoke)
        moe_sess = repro_torch.compile(
            moe_cfg, uniform_policy(8, 8), mode="serve_packed",
            generator=torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        expect["moe_tokens"] = (tokens % moe_cfg.vocab).cpu()  # its vocab
        expect["moe"] = _dist_expect(moe_sess, expect["moe_tokens"].cuda(),
                                     max_seq)
        del moe_sess
        torch.cuda.empty_cache()
        expect["train"] = _dist_train_expect(smoke)
        print(f"[dist] unsharded first train steps on the card (loss, grad "
              f"norm before the clip): {expect['train']}", flush=True)
        torch.save(expect, os.path.join(tmp, "expect.pt"))
        ckpt.save_checkpoint(os.path.join(tmp, "ckpt"), 0, M.init_params(
            _ckpt_cfg(smoke), torch.Generator(device="cuda").manual_seed(0),
            "cuda"))
        torch.cuda.empty_cache()
        print(f"[dist] unsharded expectations and the checkpoint in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        t0 = time.perf_counter()
        reset_launches()
        cli_one = train_mod.main(CLI_ARGS + ["--steps", str(CLI_STEPS)])
        check(not any(read_launches().values()), "dist: the train CLI at a "
              "world of one launched kernels of the port")
        print(f"[dist] train CLI at a world of one (NCCL): {CLI_STEPS} steps "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)

        launches = {}
        backend = init_process(0, 1, _free_port(), "cuda",
                               timeout_s=DIST_TIMEOUT_S)
        check(backend == "nccl", f"dist: world size 1 ran on {backend}")
        mesh11 = make_host_mesh(1, 1, device="cuda")
        r = _dist_serve(mesh11, qwen, tokens, expect["qwen"], max_seq, errs,
                        "(1, 1)")
        torch.cuda.empty_cache()
        got = _dist_train_expect(smoke, mesh11)
        for key, (loss, norm) in got.items():
            want, want_norm = expect["train"][key]
            check(abs(loss - want) <= DIST_LOSS_RTOL * abs(want)
                  and abs(norm - want_norm) <= DIST_NORM_RTOL * want_norm,
                  f"dist: the (1, 1) NCCL mesh's first {key} train step's "
                  f"loss {loss!r} and grad norm {norm!r}, the unsharded "
                  f"step's {want!r}, {want_norm!r}")
            print(f"[dist] (1, 1) NCCL train {key}: first-step loss {loss!r}"
                  f", grad norm {norm!r}; the unsharded step's {want!r}, "
                  f"{want_norm!r} (bit-equal: {[loss, norm] == [want, want_norm]})",
                  flush=True)
        dist.destroy_process_group()
        torch.cuda.empty_cache()
        r["transport"] = "NCCL, world size 1"
        _print_dist(r, card)
        launches["dist (1, 1) nccl"] = r["launches"]
        launches["dist (1, 1) nccl dynamic_a"] = r["dyn_launches"]

        for world in (2, 4):
            t0 = time.perf_counter()
            ctx = mp.start_processes(_dist_rank,
                                     args=(world, _free_port(), tmp, smoke),
                                     nprocs=world, join=False,
                                     start_method="spawn")
            while not ctx.join():
                pass
            for rank in range(world):
                with open(os.path.join(tmp, f"rank{rank}_{world}.json")) as f:
                    got = json.load(f)
                check(got["backend"] == "gloo", f"dist: {world} ranks on "
                      f"one card ran on {got['backend']}")
                for k, v in got["errs"].items():
                    errs[k] = max(errs[k], v)
                for r in got["runs"]:
                    r["transport"] = DIST_LABEL
                    _print_dist(r, card)
                    if rank == 0:
                        launches[f"dist {r['label']} rank 0"] = r["launches"]
                        launches[f"dist {r['label']} rank 0 dynamic_a"] = \
                            r["dyn_launches"]
                for r in got["train"]:
                    r["transport"] = DIST_LABEL
                    _print_dist_train(r, card)
                    if rank == 0:
                        launches[f"dist train {r['label']} rank 0"] = \
                            r["launches"]
                if "cli" in got and rank == 0:
                    launches["dist train CLI (2, 1) rank 0"] = _check_cli(
                        got["cli"], cli_one, card)
                if "ckpt" in got:
                    c = got["ckpt"]
                    print(f"[dist] (1, 2) rank {rank}: checkpoint of "
                          f"qwen3-1.7b at published width, {DIST_CKPT_LAYERS}"
                          f" layers, restored with shardings= in "
                          f"{c['restore_s']:.2f} s: {c['leaves']} leaves, "
                          f"{c['bytes']} bytes of shards, each the slice of "
                          f"the unsharded restore")
            print(f"[dist] the {world}-rank world took "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[dist] {card}: phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def phase_engine_cli(card: str) -> None:
    """``python -m repro_torch.launch.serve`` in three subprocesses at
    once: server mode (3 requests, 2 slots), a solo ``--batch 1`` run of
    request 0's prompt, and the same on ``--mode serve_int8``; row 0 must
    equal the solo run, and the serve_int8 run too (exact at (8, 8))."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
            "qwen3-1.7b", "--mode", "serve_packed"]
    with tempfile.TemporaryDirectory() as tmp:
        files = [str(Path(tmp) / f"{n}.npy") for n in ("server", "solo",
                                                        "int8")]
        int8 = [a if a != "serve_packed" else "serve_int8" for a in base]
        cmds = [base + ["--server", "3", "--batch", "2", "--out-tokens",
                        files[0]],
                base + ["--batch", "1", "--out-tokens", files[1]],
                int8 + ["--batch", "1", "--out-tokens", files[2]]]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, env=env, cwd=root, text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for c in cmds]
        try:
            outs = [p_.communicate(timeout=300)[0] for p_ in procs]
        finally:
            for p_ in procs:
                if p_.poll() is None:
                    p_.kill()
                    p_.wait()
        for c, p_, out in zip(cmds, procs, outs):
            check(p_.returncode == 0, f"{' '.join(c[2:])} exited "
                  f"{p_.returncode}:\n{out[-3000:]}")
        rows, solo, int8_solo = (np.load(f) for f in files)
    check(rows.shape == (3, 16) and np.array_equal(rows[0], solo[0]),
          f"serve CLI: --server row 0 {rows[0].tolist()} differs from the "
          f"solo run {solo[0].tolist()}")
    check(np.array_equal(int8_solo, solo), f"serve CLI: --mode serve_int8 "
          f"{int8_solo[0].tolist()} differs from serve_packed at (8, 8) "
          f"{solo[0].tolist()}")
    line = [ln for ln in outs[0].splitlines() if "[serve] server:" in ln]
    print(f"[engine] {card}: serve CLI (smoke config on the card): --server "
          f"3 --batch 2 exit 0, row 0 == solo --batch 1 run == --mode "
          f"serve_int8 --batch 1, the three in "
          f"{time.perf_counter() - t0:.1f} s; {line[0] if line else ''}")


def _sdpa(q_, k_, v_, causal: bool, window):
    """F.scaled_dot_product_attention over the same function as K7 (a
    boolean mask for a window), or None when it has no such call."""
    s_, d = q_.shape[2], q_.shape[3]
    mask = None
    if window is not None:
        i = torch.arange(s_, device=q_.device)
        mask = (i[None, :] > i[:, None] - window)
        if causal:
            mask &= i[None, :] <= i[:, None]
    return lambda: F.scaled_dot_product_attention(
        q_, k_, v_, attn_mask=mask, is_causal=causal and mask is None,
        scale=d ** -0.5)


def _library(name: str, args: tuple, kw: dict, out):
    """One PyTorch call computing the same function, checked against the
    kernel's output ``out``: torch._int_mm for K1/K3 (on the untrimmed
    operand), an fp32 cuDNN conv (exact: every partial sum fits a float32
    mantissa) for K2/K4/K5, scaled_dot_product_attention for K7 (within
    SDPA_TOL); None where there is none (K6: no single PyTorch call
    quantizes per group and reports effective bits)."""
    x = args[0]
    if name == "dynamic_quant":
        return None
    if name == "flash_attention":
        lib = _sdpa(*args, kw.get("causal", True), kw.get("window"))
        check(within(lib(), out, SDPA_TOL, SDPA_TOL),
              "scaled_dot_product_attention disagrees with flash_attention")
        return lib
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


def time_call(name: str, args: tuple, kw: dict, label: str, errs: dict,
              plain_iters: int = 10) -> dict:
    """Kernel, plain and library ms of one recorded call, its bound, and
    its agreement with the plain version (K7: in float32); prints one
    line."""
    spec = KERNELS[name]
    plain_kw = {k: v for k, v in kw.items() if k != "rows_per_band"}

    def kernel():
        return spec["fn"](*args, **kw)

    def plain():
        return spec["plain"](*args, **plain_kw)
    out = kernel()
    if name == "flash_attention":
        k7_hold(errs, out, k7_plain32(*args, **plain_kw), f"at {label}")
    else:
        _hold(errs, name, out, plain(), f"at {label}")
    nbytes, ops_, peak = work(name, args, kw, out)
    lib = _library(name, args, kw, out)
    t_kernel, t_plain = cuda_ms(kernel), cuda_ms(plain, iters=plain_iters)
    out_bytes = sum(t.numel() * t.element_size()
                    for t in (out if isinstance(out, tuple) else (out,)))
    t_graph = graph_ms(kernel, iters=max(2, min(50, 2 ** 30 // out_bytes)))
    t_lib = cuda_ms(lib) if lib is not None else None
    bound = max(nbytes / HBM_BYTES_PER_S, ops_ / peak) * 1e3
    shapes = " ".join(f"{tuple(a.shape)}" for a in args)
    opts = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[timing] {label} {name} {shapes} {opts}: kernel {t_kernel:.4f} "
          f"ms (graph-replayed {t_graph:.4f} ms), plain {t_plain:.4f} ms, "
          f"library {'n/a' if t_lib is None else f'{t_lib:.4f} ms'}, bound "
          f"{bound:.5f} ms ({nbytes} B, {ops_} op, "
          f"{'bytes' if nbytes / HBM_BYTES_PER_S >= ops_ / peak else 'operations'})")
    return dict(ms=t_kernel, graph_ms=t_graph, plain_ms=t_plain,
                library_ms=t_lib, bytes_s=nbytes / HBM_BYTES_PER_S,
                ops_s=ops_ / peak)


def phase_timing(runs: dict, errs: dict) -> dict:
    """Per (kernel, path): kernel, plain and library ms and the bound,
    summed over the kernel's calls in one request of that path (``runs``:
    path -> a callable that serves one request)."""
    rows = {}
    for path, run in runs.items():
        with recorded_calls() as calls:
            run()
        torch.cuda.synchronize()
        for i, (name, args, kw) in enumerate(calls):
            t = time_call(name, args, kw, f"path {path} call {i}", errs)
            r = rows.setdefault((name, path), dict(
                ms=0.0, graph_ms=0.0, plain_ms=0.0, bytes_s=0.0, ops_s=0.0,
                library_ms=0.0, library=True))
            for key in ("ms", "graph_ms", "plain_ms", "bytes_s", "ops_s"):
                r[key] += t[key]
            if t["library_ms"] is None:
                r["library"] = False
            else:
                r["library_ms"] += t["library_ms"]
    for (name, path), r in rows.items():
        print(f"[timing] path {path} {name} per request: kernel "
              f"{r['ms']:.4f} ms (before: {BEFORE_MS.get((name, path), 'n/a')}"
              f" ms; graph-replayed {r['graph_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library "
              f"{r['library_ms'] if r['library'] else 'n/a'}, bound "
              f"{max(r['bytes_s'], r['ops_s']) * 1e3:.5f} ms")
    return rows


def phase_lm_timing(lm: dict, errs: dict) -> None:
    """K1 at the LM's shapes: layer 0's seven linears and the head, in a
    prefill and a decode step; and K3 at the ``dynamic_a`` prefill's
    (each linear transposed, the weights [N_out, K] against the
    activations packed at Pa = 8). Per step the layer sum times the layer
    count plus the head (the kernels' time does not depend on the
    weights' values)."""
    sess, dyn, tokens = lm["sess"], lm["dyn"], lm["tokens"]
    cfg = sess.cfg
    cache = sess.init_cache(LM_BATCH, lm["max_seq"])
    with recorded_calls() as pre:
        _, cache = sess.prefill(tokens, cache)
    with recorded_calls() as dec:
        sess.decode(tokens[:, -1], LM_PROMPT, cache)
    with recorded_calls() as dyn_pre:
        dyn.prefill(tokens, dyn.init_cache(LM_BATCH, lm["max_seq"]))
    torch.cuda.synchronize()
    for label, calls, kname, before in (
            ("prefill", pre, "K1", BEFORE_MS["LM", "prefill"]),
            ("decode", dec, "K1", BEFORE_MS["LM", "decode"]),
            ("dynamic_a prefill", dyn_pre, "K3",
             BEFORE_MS["LM", "dynamic_a prefill"])):
        check(len(calls) == lm["n_lin"], f"LM {label} recorded {len(calls)} "
              f"kernel calls")
        tot = {k: 0.0 for k in ("ms", "graph_ms", "plain_ms", "library_ms",
                                "bound")}
        for j, (name, args, kw) in enumerate(calls[:7] + calls[-1:]):
            t = time_call(name, args, kw, f"LM {label} "
                          f"{'head' if j == 7 else f'layer 0 linear {j}'}",
                          errs, plain_iters=3)
            times = cfg.n_layers if j < 7 else 1
            for k in ("ms", "graph_ms", "plain_ms", "library_ms"):
                tot[k] += times * t[k]
            tot["bound"] += times * max(t["bytes_s"], t["ops_s"]) * 1e3
        print(f"[timing] LM {label} {kname} per step ({cfg.n_layers} x layer 0 "
              f"+ head): kernel {tot['ms']:.3f} ms (before: {before} ms; "
              f"graph-replayed {tot['graph_ms']:.3f} ms), "
              f"plain {tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f}"
              f" ms, bound {tot['bound']:.4f} ms")
        del calls[:]


def phase_attention_timing(errs: dict) -> None:
    """K7 at the long shapes: [1, 16, 4096, 128] bf16 causal and windowed
    against its plain version and scaled_dot_product_attention; [1, 16,
    32768, 128] causal against the port's chunked_attention (the plain
    version's [S, S] logits would take 64 GiB; held in float32) and the
    library call."""
    for window in (None, 1024):
        args = tuple(qkv((1, 16, 4096, 128), torch.bfloat16, seed=11))
        t = time_call("flash_attention", args, dict(causal=True,
                                                    window=window),
                      "long", errs, plain_iters=3)
        print(f"[timing] long flash_attention (1, 16, 4096, 128) window="
              f"{window}: kernel {t['ms']:.4f} ms (before: "
              f"{BEFORE_MS['long', window]} ms)")
        del args
    q_, k_, v_ = qkv((1, 16, 32768, 128), torch.bfloat16, seed=12)
    out = flash_attention(q_, k_, v_, causal=True)
    with torch.inference_mode():
        want = attn.chunked_attention(
            *(t.transpose(1, 2).float() for t in (q_, k_, v_)),
            causal=True).transpose(1, 2)
    err = k7_hold(errs, out, want, "at S = 32768 against chunked_attention")
    del want
    t_kernel = cuda_ms(lambda: flash_attention(q_, k_, v_, causal=True),
                       iters=2, warmup=0)
    with torch.inference_mode():
        t_plain = cuda_ms(lambda: attn.chunked_attention(
            *(t.transpose(1, 2) for t in (q_, k_, v_)), causal=True),
            iters=1, warmup=0)
    lib = _sdpa(q_, k_, v_, True, None)
    check(within(lib(), out, SDPA_TOL, SDPA_TOL),
          "scaled_dot_product_attention disagrees at S = 32768")
    t_lib = cuda_ms(lib, iters=3, warmup=1)
    nbytes, ops_, peak = work("flash_attention", (q_, k_, v_),
                               dict(causal=True), out)
    print(f"[timing] long flash_attention (1, 16, 32768, 128) bf16 causal: "
          f"kernel {t_kernel:.3f} ms (before: {BEFORE_MS['long', 32768]} ms), "
          f"plain (chunked_attention) "
          f"{t_plain:.3f} ms, library {t_lib:.3f} ms, bound "
          f"{max(nbytes / HBM_BYTES_PER_S, ops_ / peak) * 1e3:.4f} ms "
          f"({ops_} op); max abs err vs chunked_attention in float32 "
          f"{err:.3g}")


class _OpCount(TorchDispatchMode):
    """Counts the PyTorch operators dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def phase_profile(label: str, run, request_s: float, launches: int,
                  requests: int = 4) -> tuple:
    """Host operators per request, device time by kernel over a few
    requests (torch.profiler), and the device's idle share of the
    unprofiled median request time. ``run`` serves one request. Returns
    (operators, busy ms per request or None where the profiler recorded
    no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with _OpCount() as count:
        run()
    print(f"[profile] path {label}: {count.ops} PyTorch operators dispatched "
          f"per request, beside its {launches} kernel launches")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(requests):
            run()
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
        return count.ops, None
    print(f"[profile] path {label}: device busy {busy_ms:.4f} ms per request "
          f"of {request_s * 1e3:.4f} ms (idle share "
          f"{1 - busy_ms / (request_s * 1e3):.3f}), {requests} requests")
    for t, key in per_kernel[:12]:
        print(f"[profile] path {label} {t / 1e3:.4f} ms/request  {key[:90]}")
    return count.ops, busy_ms


# The launch phase: the dry run's production cells traced on a fake world
# of 256 ranks in a subprocess (arch, shape, weights); its time limit; and
# the timed runs of the analyzed steps.
LAUNCH_CELLS = [("musicgen_large", "decode_32k", "dense"),
                ("qwen3-1.7b", "decode_32k", "serve_packed"),
                ("mamba2_370m", "long_500k", "dense")]
LAUNCH_TIMEOUT_S = 300
LAUNCH_TIMED = 5
_LAUNCH_CELLS_SCRIPT = """
import sys, tempfile
from repro_torch.launch import dryrun
out = tempfile.mkdtemp()
for arch, shape, weights in {cells!r}:
    dryrun.run_cell(arch, shape, "single", weights, weights, out_dir=out)
print("[records]", out)
"""


def start_dry_runs(script: str) -> tuple:
    """Start ``script`` (dry runs: host work on fake tensors) in a
    subprocess with the checkout's ``src`` on its path, killed at exit if
    still running: (its start time, the process)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", script], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ,
                 PYTHONPATH=str(Path(__file__).resolve().parent / "src")))
    atexit.register(proc.kill)
    return time.perf_counter(), proc


def finish_dry_runs(started: tuple, what: str) -> tuple:
    """Wait for :func:`start_dry_runs`' subprocess (LAUNCH_TIMEOUT_S at
    most), which must exit 0: (its output lines, its seconds, the seconds
    waited here)."""
    t0, proc = started
    t_wait = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    check(proc.returncode == 0, f"{what} exited {proc.returncode}:\n"
          f"{out[-2000:]}{err[-3000:]}")
    now = time.perf_counter()
    return out.splitlines(), now - t0, now - t_wait


def _analyzed(fn, arguments) -> tuple:
    """(its result, the Totals) of ``fn()`` under the op analyzer."""
    with opanalysis.OpAnalysis(arguments=arguments) as a:
        out = fn()
    torch.cuda.synchronize()
    return out, a.totals()


def phase_launch(lm: dict, card: str, cells: tuple) -> tuple:
    """The analyzer on the card's own prefill and decode step, held equal
    to the dry run's trace of them; the production cells on a fake world
    (module docstring; ``cells``: :func:`start_dry_runs`). Returns the
    step's launches and the directory of the cells' records."""
    t_phase = time.perf_counter()
    sess, cfg = lm["sess"], lm["sess"].cfg
    tokens = lm["tokens"].to(torch.int32)
    batch, prompt = tokens.shape
    pos = prompt                              # as ``generate`` passes it
    n_lin = lm["n_lin"]
    params = sess.params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = analyze_served(sess, tokens, None, lm["max_seq"], (n_lin, n_lin),
                         "launch")
    pre, dec, cache, tok = (got[k] for k in ("prefill", "decode", "cache",
                                             "tok"))
    peak = torch.cuda.max_memory_allocated()

    timed_cache = sess.init_cache(batch, lm["max_seq"])
    with torch.inference_mode():
        timed = {label: float(np.median([_event_ms(fn)[1]
                                         for _ in range(LAUNCH_TIMED)]))
                 for label, fn in (("prefill", lambda: sess._prefill(
                                       params, tokens, timed_cache)),
                                   ("decode", lambda: sess._decode(
                                       params, tok, pos, cache)))}
    del timed_cache
    cache_bytes = float(opanalysis.storage_bytes(cache))
    for label, t in (("prefill", pre), ("decode", dec)):
        terms = opanalysis.roofline_terms(t)
        cell = shapes.ShapeCell(
            label, label, prompt if label == "prefill" else prompt + 1,
            batch)
        ideal_ms = dryrun.ideal_bounds(cfg, cell, 1, "serve_packed",
                                       cache_bytes)["ideal_bound_s"] * 1e3
        ms = timed[label]
        print(f"[launch] {card}: {cfg.name} serve_packed {label} "
              f"({batch} x {prompt if label == 'prefill' else 1}) under the "
              f"analyzer: {t.flops:.6g} operations {t.flops_by_type}, "
              f"{t.hbm_bytes:.6g} HBM bytes, {t.n_ops} aten ops, kernels "
              f"{t.kernels} (launch counters {n_lin}); tracked peak "
              f"{t.peak_bytes / 2**30:.3f} GiB, max_memory_allocated "
              f"{peak / 2**30:.3f} GiB; measured {ms:.4f} ms (CUDA events, "
              f"median of {LAUNCH_TIMED}); on the datasheet constants: "
              f"eager bound {terms['bound_s'] * 1e3:.4f} ms "
              f"({terms['dominant']}; the unfused program counted), "
              f"eager-bound fraction {terms['bound_s'] * 1e3 / ms:.4f}; "
              f"ideal bound {ideal_ms:.4f} ms (dryrun.ideal_bounds, world "
              f"one), ideal-bound fraction {ideal_ms / ms:.4f}")
    t0 = time.perf_counter()
    dry = dryrun.serving_counts(cfg, "serve_packed", batch, prompt,
                                lm["max_seq"])
    hold_dry_run({k: t.counts() for k, t in dry.items()}, got, "launch")
    print(f"[launch] world-one dry run (fake tensors, torch_ref, traced at "
          f"1 and 2 layer groups and extrapolated to {cfg.n_groups}) in "
          f"{time.perf_counter() - t0:.1f} s: operations, HBM bytes and "
          f"kernels equal to the card's prefill and decode step's")
    out, took, waited = finish_dry_runs(cells, "launch cells")
    lines = [ln for ln in out if ln.startswith("[dryrun]")]
    check(len(lines) == len(LAUNCH_CELLS) and all(" OK " in ln
                                                  for ln in lines),
          f"launch cells: {out[-20:]}")
    for ln in lines:
        print(f"[launch] fake world of 256 ranks (modeled, datasheet "
              f"constants): {ln}")
    records = [ln.split(" ", 1)[1] for ln in out
               if ln.startswith("[records] ")]
    check(len(records) == 1, f"launch cells: no records directory: "
          f"{out[-5:]}")
    print(f"[launch] production cells in {took:.1f} s (one subprocess, "
          f"started before the dist phase; waited {waited:.1f} s here); "
          f"phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launch": got["launches"]}, records[0]


def printed(fn, *args, **kwargs) -> tuple:
    """(``fn``'s result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def table1_deciders(params: dict, device: str) -> tuple:
    """Table 1's metric on ``device`` (``table1.metric`` from ``params``
    and the report's images) and the search's floor."""
    eval_fn = table1.metric(*table1.operands(params, None, device))
    base = eval_fn(uniform_policy(16, 16))
    tol = table1.TOLERANCE
    return eval_fn, base * (1.0 - tol) if base >= 0 else base * (1.0 + tol)


@torch.inference_mode()
def hold_table1(got: dict, want: dict, params: dict) -> None:
    """The card's Table 1 rows ``got`` equal the CPU's ``want``: each
    layer's profiled widths, and its dynamic line as the report prints
    it. Prints, for each layer and width kind, both devices' metrics
    beside their floors at the deciding widths: the larger profiled width
    less one (where the search stopped, or where one device went on and
    the other stopped) and the smaller profiled width below 16 (the last
    one kept); any difference fails."""
    (card_fn, card_floor), (cpu_fn, cpu_floor) = (
        table1_deciders(params, d) for d in ("cuda", "cpu"))
    diffs = []
    for what in ("a_bits", "w_bits"):
        for name in got["layers"]:
            a, b = got[what][name], want[what][name]
            for width in sorted({max(a, b) - 1, min(a, b)}):
                if not table1.MIN_BITS <= width < 16:
                    continue
                lp = LayerPrecision(a_bits=width if what == "a_bits" else 16,
                                    w_bits=width if what == "w_bits" else 16)
                pol = PrecisionPolicy(default=LayerPrecision(16, 16),
                                      per_layer={name: lp})
                mc, mh = card_fn(pol), cpu_fn(pol)
                print(f"[reports] Table 1 decision: {name} {what} card {a}, "
                      f"CPU {b}; at {width} bits the card's metric {mc!r} "
                      f"(floor {card_floor!r}, margin {mc - card_floor:.3g}),"
                      f" the CPU's {mh!r} (floor {cpu_floor!r}, margin "
                      f"{mh - cpu_floor:.3g})")
            if a != b:
                diffs.append(f"{name} {what}: card {a}, CPU {b}")
    for name in got["layers"]:
        lines = [table1.dynamic_line(name, r["dynamic"][name])
                 if name in r["dynamic"] else None for r in (got, want)]
        if lines[0] != lines[1]:
            diffs.append(f"{name} dynamic: card {lines[0]!r}, CPU "
                         f"{lines[1]!r}")
    for d in diffs:
        print(f"[reports] Table 1 differs: {d}")
    check(not diffs, f"Table 1 on the card differs from the CPU's in "
          f"{len(diffs)} place(s)")


def hold_roofline(lines: list, recs: list, weights: str) -> int:
    """The roofline table's rows in ``lines`` are those of ``recs``' single
    -mesh, untagged ``weights`` records, one each, with every term as
    ``fmt_ms`` formats it. Returns the rows held."""
    rows = [ln for ln in lines if ln.startswith("| ") and
            not ln.startswith("| arch |")]
    want = [r for r in recs if not r.get("skipped") and r["mesh"] == "single"
            and r["weights"] == weights and not r.get("tag")]
    check(len(rows) == len(want), f"roofline ({weights}): {len(rows)} rows "
          f"for {len(want)} records:\n" + "\n".join(lines))
    for r in want:
        match = [ln for ln in rows
                 if ln.startswith(f"| {r['arch']} | {r['shape']} |")]
        check(len(match) == 1, f"roofline ({weights}): {len(match)} rows "
              f"for {r['arch']} x {r['shape']}")
        cells = [c.strip() for c in match[0].strip("|").split("|")]
        terms = [roofline.fmt_ms(r["t_compute_s"]),
                 roofline.fmt_ms(r["t_memory_s"]),
                 roofline.fmt_ms(r["t_collective_s"]), r["dominant"],
                 roofline.fmt_ms(r["ideal_bound_s"]),
                 f"{r['roofline_fraction']:.3f}"]
        check(cells[2:8] == terms, f"roofline row {cells} against the "
              f"record's terms {terms}")
    return len(want)


def phase_reports(card: str, records: str) -> None:
    """The paper's reports as the port's entry points (module docstring);
    ``records``: the launch cells' dry-run records, removed after."""
    t_phase = time.perf_counter()
    cfg = configs.get("paper_cnn", smoke=True)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = table1.rows(params, device="cuda")
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = table1.rows(params, device="cpu")
    t_cpu = time.perf_counter() - t0
    for line in table1.lines(got):
        print(f"[reports] {card}: {line}")
    hold_table1(got, want, params)
    print(f"[reports] Table 1 on the card in {t_card:.3f} s (host clock to "
          f"synchronize), equal to the CPU's ({t_cpu:.3f} s) layer by layer")
    for report in (table2, table4, fig4, fig5):
        _, lines = printed(report.main)
        check(lines[0].startswith("(MODELED"), f"{report.__name__}: "
              f"{lines[0]}")
        for line in lines:
            print(f"[reports] {line}")
    with tempfile.TemporaryDirectory() as no_opt:
        recs, lines = printed(roofline.main, results_dir=records,
                              opt_dir=no_opt)
    # The report's table shows the dense records; the serve_packed cell's
    # table is printed beside it.
    served = roofline.table(recs, weights="serve_packed").splitlines()
    for line in lines + served:
        print(f"[reports] {line}")
    held = (hold_roofline(lines, recs, "dense")
            + hold_roofline(served, recs, "serve_packed"))
    check(held == len(LAUNCH_CELLS), f"roofline: {held} rows held for "
          f"{len(LAUNCH_CELLS)} launch cells")
    shutil.rmtree(records)
    print(f"[reports] roofline rows equal to the {held} launch cells' "
          f"records; phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def main() -> None:
    # The fp32 yardsticks and plain versions run in full fp32, not TF32
    # (cuDNN's default for convolutions).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_script = time.perf_counter()
    name, count, card = phase_device()
    archs_dry = start_archs_dry_runs()
    phase_build()
    errs = {k: 0 for k in KERNELS}
    phase_kernels(errs)
    phase_k7(errs)
    archs_dry = archs_dry_counts(archs_dry)
    served = phase_serve()
    lm = phase_lm(errs)
    int8 = phase_int8(lm, card, errs)
    engine = phase_engine(lm, card, errs)
    phase_integrity(lm, engine, card, errs)
    kv_launches = phase_kvcache(lm, engine, card, errs)
    arch_launches = phase_archs(card, archs_dry)
    phase_train(card)
    paper_launches = phase_paper(card, errs)
    cells = start_dry_runs(_LAUNCH_CELLS_SCRIPT.format(cells=LAUNCH_CELLS))
    dist_launches = phase_dist(lm, card, errs)
    launch_launches, records = phase_launch(lm, card, cells)
    phase_reports(card, records)
    launches = dict(served["launches"])
    launches["CNN im2col"] = int8["im2col_launches"]
    launches["LM generate"] = lm["gen_launches"]
    launches["LM engine"] = engine["launches"]
    launches["LM engine dynamic_a"] = engine["dyn_launches"]
    launches.update(kv_launches)
    launches.update(arch_launches)
    launches.update(paper_launches)
    launches.update(dist_launches)
    launches.update(launch_launches)
    launches["ops"] = lm["ops_launches"]
    runs = {label: (lambda sess=sess, x=x: sess.classify(x))
            for label, (sess, x, _) in served["runs"].items()}
    runs["ops"] = lambda: lm_ops_path(lm["operands"])
    rows = phase_timing(runs, errs)
    phase_lm_timing(lm, errs)
    phase_attention_timing(errs)
    for label, (sess, x, request_s) in served["runs"].items():
        phase_profile(label, lambda sess=sess, x=x: sess.classify(x),
                      request_s,
                      sum(served["launches"][label].values()) // REQUESTS)
    sess, tokens = lm["sess"], lm["tokens"]
    cache = sess.init_cache(LM_BATCH, lm["max_seq"])
    _, pre_busy = phase_profile("LM prefill",
                                lambda: sess.prefill(tokens, cache),
                                lm["prefill_s"], lm["n_lin"], requests=2)
    _, dec_busy = phase_profile("LM decode",
                                lambda: sess.decode(tokens[:, -1], LM_PROMPT,
                                                    cache),
                                lm["decode_s"], lm["n_lin"], requests=4)
    isess = lm["int8"]
    icache = isess.init_cache(LM_BATCH, lm["max_seq"])
    ipre, idec = int8["lm_medians"]["serve_int8"]
    _, ipre_busy = phase_profile("LM serve_int8 prefill",
                                 lambda: isess.prefill(tokens, icache), ipre,
                                 0, requests=1)
    _, idec_busy = phase_profile("LM serve_int8 decode",
                                 lambda: isess.decode(tokens[:, -1],
                                                      LM_PROMPT, icache),
                                 idec, 0, requests=1)
    del icache
    print(f"[int8] {card}: LM device busy, serve_int8 against serve_packed: "
          f"prefill {_busy(ipre_busy)} against {_busy(pre_busy)}, decode "
          f"step {_busy(idec_busy)} against {_busy(dec_busy)}")
    dyn = lm["dyn"]
    dyn_cache = dyn.init_cache(LM_BATCH, lm["max_seq"])
    phase_profile("LM dynamic_a prefill",
                  lambda: dyn.prefill(tokens, dyn_cache),
                  lm["dyn_prefill_s"], lm["n_lin"], requests=2)
    # One engine step at full occupancy: ENGINE_BATCH requests admitted,
    # then decode-only steps (host bookkeeping and the tokens' transfer
    # included).
    eng = BatchingEngine(sess, max_batch=ENGINE_BATCH, max_seq=ENGINE_SEQ)
    drive_engine_admit(eng, engine["prompts"][:ENGINE_BATCH])
    phase_profile(f"LM engine step ({card})", eng.step, engine["step_s"],
                  lm["n_lin"], requests=4)
    eng.shutdown(0.0)
    kernels = []
    for kname, spec in KERNELS.items():
        path = spec["path"]
        r = rows[kname, path]
        by_bytes = r["bytes_s"] >= r["ops_s"]
        kernels.append({
            "name": kname, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "path": path,
            "launches": launches[path][kname],
            "launches_by_path": {p: n[kname] for p, n in launches.items()
                                 if n[kname]},
            "max_abs_err": errs[kname], "ms": r["ms"],
            "graph_ms": r["graph_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_s"], r["ops_s"]) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations",
            "library_ms": r["library_ms"] if r["library"] else None})
    print(f"[smoke] {card}: the whole script took "
          f"{time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
