"""The paper's full precision pipeline on a TRANSFORMER (Tables 1+3 logic):

1. Judd-style profiling per projection class (attn q/k/v/o, ffn up/gate/
   down, lm_head) -- the transformer analogue of per-layer profiles.
2. A mixed-precision PrecisionPolicy from the profile.
3. Offline bit-packed conversion at the profiled widths -> weight bytes
   follow sum(Pw_i * size_i)/16 (the paper's storage law, now per class).
4. Dynamic per-group activation trimming statistics (Lascorz et al.) on
   live activations -- the runtime savings Loom adds on top of the static
   profile.

Run:  python -m repro_torch.examples.precision_profiles [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api.plan import build_plan
from repro_torch.core import dynamic, policy as pol, profiler, quantize as q
from repro_torch.examples import resolve_device, run
from repro_torch.models import layers as L, model as M

CLASSES = ("attn_q", "attn_k", "attn_v", "attn_o", "ffn_gate", "ffn_up",
           "ffn_down", "lm_head")


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in M._leaves(tree))


def corr(a: torch.Tensor, b: torch.Tensor) -> float:
    """Pearson correlation of two logit tensors, in float64 on the host."""
    return float(np.corrcoef(a.float().cpu().numpy().ravel(),
                             b.float().cpu().numpy().ravel())[0, 1])


def profile_classes(params, cfg, toks, *, tolerance: float = 0.03,
                    min_bits: int = 3) -> tuple:
    """The per-class search through ``forward_train`` in ``fake_quant``,
    the metric the negative relative distortion of the dense logits.
    Returns (dense logits, {class: Pa}, {class: Pw}, forwards run)."""
    ref, _ = M.forward_train(params, cfg, toks, build_plan(cfg, mode="dense"))
    ref32 = ref.to(torch.float32)
    n_evals = [0]

    def eval_fn(p):
        n_evals[0] += 1
        lg, _ = M.forward_train(params, cfg, toks,
                                build_plan(cfg, p, mode="fake_quant"))
        err = torch.linalg.norm(lg.to(torch.float32) - ref32) \
            / torch.linalg.norm(ref32)
        return float(-err)

    prof_w = profiler.profile_layer_precisions(
        eval_fn, CLASSES, tolerance=tolerance, what="w_bits",
        min_bits=min_bits)
    prof_a = profiler.profile_layer_precisions(
        eval_fn, CLASSES, tolerance=tolerance, what="a_bits",
        min_bits=min_bits)
    return ref, prof_a, prof_w, n_evals[0]


def mixed_policy(prof_a: dict, prof_w: dict) -> pol.PrecisionPolicy:
    """The profile as a policy; activations ride the int8 serving datapath,
    so Pa is capped at 8."""
    per_layer = {c: pol.LayerPrecision(a_bits=min(prof_a[c], 8),
                                       w_bits=prof_w[c]) for c in CLASSES}
    return pol.PrecisionPolicy(default=pol.LayerPrecision(8, 8),
                               per_layer=per_layer)


@torch.inference_mode()
def main(device="cuda") -> dict:
    device = resolve_device(device)
    cfg = configs.get("qwen3-1.7b", smoke=True)
    params = M.init_params(cfg, torch.Generator(device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 32)), device=device)

    # -- 1. per-class weight- and activation-precision profile -----------
    ref, prof_a, prof_w, _ = profile_classes(params, cfg, toks)
    print("[profile] per-class precisions (Pa/Pw):")
    for c in CLASSES:
        print(f"    {c:10s} {prof_a[c]:2d} / {prof_w[c]:2d}")

    # -- 2+3. mixed-precision policy -> packed serving -------------------
    mixed = mixed_policy(prof_a, prof_w)
    packed = M.convert_params_for_serving(params, mixed, "serve_packed")
    dense_bytes = tree_bytes(params)
    packed_bytes = tree_bytes(packed)
    lg_p, _ = M.forward_train(packed, cfg, toks,
                              build_plan(cfg, mixed, mode="serve_packed"))
    c = corr(ref, lg_p)
    print(f"[packed] mixed-precision weights: {packed_bytes/1e6:.3f}MB vs "
          f"{dense_bytes/1e6:.3f}MB bf16 ({packed_bytes/dense_bytes:.2f}x); "
          f"logit corr {c:.4f}")
    assert c > 0.97

    # -- 4. dynamic per-group trimming on live activations ----------------
    h = L.embed_apply(params["embed"], toks).to(torch.float32)
    flat = h.reshape(-1)
    n = (flat.shape[0] // 256) * 256
    xq, _ = q.quantize(flat[:n], 8)
    stats = dynamic.dynamic_stats(xq.reshape(-1, 256), 8, 256)
    print(f"[dynamic] embeddings: static 8b -> mean effective "
          f"{float(stats['mean_effective_bits']):.2f}b "
          f"(x{float(stats['plane_fraction_executed']):.2f} of the planes "
          f"execute at runtime -- Loom's dynamic trim)")
    print("precision_profiles done.")
    return {"prof_a": prof_a, "prof_w": prof_w, "corr": c,
            "bytes": (packed_bytes, dense_bytes),
            "dynamic": {k: float(v) for k, v in stats.items()}}


if __name__ == "__main__":
    run(main, __doc__)
