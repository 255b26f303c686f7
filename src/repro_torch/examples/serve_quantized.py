"""Batched serving with the paper's precision ladder, end to end:

  dense bf16 (DPNN)  ->  LM_8b int8  ->  bit-packed serve (LM_1b storage)

Builds a small transformer, converts the weights offline (the paper's
bit-interleaved packing), runs the same batched prefill+decode through all
three execution modes, and reports (a) weight-memory footprints (the
paper's Pw/16 law), (b) agreement of generated tokens and logits, (c) the
bytes ratio that bounds the decode-step speedup when weight bytes
dominate.

Run:  python -m repro_torch.examples.serve_quantized [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api.plan import build_plan
from repro_torch.core.policy import uniform_policy
from repro_torch.examples import resolve_device, run
from repro_torch.examples.precision_profiles import tree_bytes
from repro_torch.launch.serve import make_serve_fns
from repro_torch.models import model as M


def generate(cfg, params, plan, tokens, n_new: int, force=None):
    """Greedy decode; if ``force`` is given, feed ITS tokens instead of our
    argmax (teacher forcing) so different precisions see identical inputs
    and per-step logits are comparable. Returns numpy (tokens [B, n_new],
    float32 logits [B, n_new, V])."""
    prefill_fn, decode_fn = make_serve_fns(cfg, plan)
    b, s = tokens.shape
    cache = M.init_cache(cfg, b, cfg.max_seq, tokens.device)
    logits, cache = prefill_fn(params, tokens, cache)
    tok = torch.argmax(logits[:, 0], dim=-1)
    out, lgs = [tok.cpu().numpy()], [logits[:, 0].float().cpu().numpy()]
    for i in range(n_new - 1):
        feed = tok if force is None else torch.as_tensor(
            force[:, i], device=tokens.device)
        logits, cache = decode_fn(params, feed, s + i, cache)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok.cpu().numpy())
        lgs.append(logits.float().cpu().numpy())
    return np.stack(out, axis=1), np.stack(lgs, axis=1)


@torch.inference_mode()
def main(device="cuda") -> dict:
    device = resolve_device(device)
    cfg = configs.get("qwen3-1.7b", smoke=True)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0), device)
    pol = uniform_policy(8, 8)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab, size=(4, 16)),
                             device=device)

    dense_bytes = tree_bytes(params)
    gen_dense, lg_dense = generate(cfg, params, build_plan(cfg, mode="dense"),
                                   tokens, 12)
    print(f"[dense]        weights {dense_bytes/1e6:7.3f}MB  "
          f"tokens[0]={gen_dense[0][:8]}")

    def corr(a, b):
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])

    p8 = M.convert_params_for_serving(params, pol, "serve_int8")
    b8 = tree_bytes(p8)
    gen8, lg8 = generate(cfg, p8, build_plan(cfg, pol, mode="serve_int8"),
                         tokens, 12, force=gen_dense)
    c8 = corr(lg8, lg_dense)
    print(f"[serve_int8]   weights {b8/1e6:7.3f}MB ({b8/dense_bytes:.2f}x)  "
          f"logit corr {c8:.4f}  tokens[0]={gen8[0][:8]}")

    pp = M.convert_params_for_serving(params, pol, "serve_packed")
    bp = tree_bytes(pp)
    genp, lgp = generate(cfg, pp, build_plan(cfg, pol, mode="serve_packed"),
                         tokens, 12, force=gen_dense)
    cp = corr(lgp, lg_dense)
    print(f"[serve_packed] weights {bp/1e6:7.3f}MB ({bp/dense_bytes:.2f}x; "
          f"paper law Pw/16 = {8/16:.2f} of bf16)  "
          f"logit corr {cp:.4f}  tokens[0]={genp[0][:8]}")

    # the paper's law on what decode cost becomes when weight bytes dominate
    print(f"[law] decode is weight-bandwidth-bound; bytes ratio dense->packed"
          f" = {dense_bytes/bp:.2f}x  (ideal Loom decode speedup at Pw=8)")
    assert c8 > 0.99 and cp > 0.99, (c8, cp)
    print("serve_quantized done.")
    return {"corr_int8": c8, "corr_packed": cp,
            "bytes": (dense_bytes, b8, bp)}


if __name__ == "__main__":
    run(main, __doc__)
