#!/usr/bin/env python3
"""Is the LM's decode step batch-invariant on the card, and what does it
cost, at the batching engine's sizes?

    python3 chip_batch_variance.py

On the full qwen3-1.7b (random weights, seed 0), for two pool sizes --
the engine phase of ``chip_smoke.py`` (``chip_smoke.ENGINE_BATCH`` slots
of ``chip_smoke.ENGINE_SEQ``) and the ``BatchingEngine`` defaults (8
slots of ``cfg.max_seq``) -- one prompt per slot, from the first seven
of ``chip_smoke.engine_prompts`` (the eighth slot takes the first again),
is prefilled alone and copied into one pool; one decode step runs on the
pool and on each prompt's own batch-1 cache, and
``chip_smoke.diagnose_batch_variance`` names the first op (RMSNorm, RoPE,
a linear or ``decode_attend``, in call order) whose row of the batch
differs from the row decoded alone.
Then the decode step at that size is timed (host clock to synchronize,
median of 15), profiled (device busy time, ``chip_smoke.phase_profile``)
and its memory read: the pool's bytes, and the peak above what was
allocated before the step (``torch.cuda.max_memory_allocated``). Exits
non-zero when either size is batch-variant, or without a CUDA device.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.policy import uniform_policy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

# (slots, cache slots): the engine phase's pool, and the engine's defaults
# (None: cfg.max_seq).
SIZES = ((cs.ENGINE_BATCH, cs.ENGINE_SEQ), (8, None))


def main() -> None:
    _, _, card = cs.phase_device()
    cs.phase_build()
    cfg = configs.get("qwen3-1.7b")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")
    sess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_packed",
                               params=params, device="cuda")
    del params
    every = cs.engine_prompts(cfg, 7)                 # 96-480 tokens
    variant = []
    for batch, seq in SIZES:
        seq = seq or cfg.max_seq
        # chunked_attention takes a prompt of up to 512 tokens or a
        # multiple of 512: at 8 slots the first prompt comes again.
        prompts = [every[j % len(every)] for j in range(batch)]
        verdict = cs.diagnose_batch_variance(sess, prompts, seq)
        if not verdict.startswith("no op"):
            variant.append(f"batch {batch}, cache {seq}: {verdict}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        pool = cs.KVPool(sess, batch, seq)
        pool_bytes = torch.cuda.memory_allocated() - before
        tok = torch.zeros(batch, dtype=torch.long, device="cuda")
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device="cuda")

        def step():
            sess.decode(tok, pos, pool.cache)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        transient = torch.cuda.max_memory_allocated() - held
        times = []
        for _ in range(15):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = sorted(times)[len(times) // 2]
        print(f"[variance] {card}: batch {batch} vs alone, cache {seq} "
              f"slots: {verdict}; decode step median {med * 1e3:.3f} ms of "
              f"15 (host clock to synchronize); pool {pool_bytes / 2**30:.3f} "
              f"GiB, the step's peak {transient / 2**30:.3f} GiB above the "
              f"{held / 2**30:.3f} GiB held (weights and pool)")
        cs.phase_profile(f"decode step, batch {batch}, cache {seq} ({card})",
                         step, med, 7 * cfg.n_layers + 1, requests=4)
        del pool, tok, pos
        torch.cuda.empty_cache()
    cs.check(not variant, f"the decode step is batch-variant: {variant}")


if __name__ == "__main__":
    main()
