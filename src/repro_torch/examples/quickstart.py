"""Quickstart: the paper's pipeline end to end, on the card or the CPU.

1. Build a small CNN (the paper's CVL+FCL workload) and a transformer.
2. Profile per-layer precisions (Judd et al.) on live data.
3. Pack the weights bit-serially (Loom's storage law: bytes = Pw/16).
4. Run inference through the bit-serial engine (K1 on the card) and
   check it matches the full-precision product closely.
5. Print the modeled Loom speedup (the paper's cycle law).

Run:  python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api.plan import build_plan
from repro_torch.core import bitpack, cyclemodel as cm, policy, profiler, quantize as q
from repro_torch.examples import resolve_device, run
from repro_torch.kernels import ops
from repro_torch.models import cnn, model as M


@torch.inference_mode()
def main(device="cuda") -> dict:
    device = resolve_device(device)
    # -- 1. the paper's workload: a CNN with conv + fc layers -------------
    cfg = configs.get("paper_cnn", smoke=True)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), device)
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(8, cfg.img, cfg.img, 3)), dtype=torch.float32, device=device)
    ref = cnn.forward(params, cfg, x, build_plan(cfg, mode="dense"))
    print(f"[1] paper_cnn forward: logits {tuple(ref.shape)}")

    # -- 2. per-layer precision profiling (Table 1 methodology) -----------
    def eval_fn(pol):
        lg = cnn.forward(params, cfg, x,
                         build_plan(cfg, pol, mode="fake_quant"))
        return float(-torch.linalg.norm(lg - ref) / torch.linalg.norm(ref))

    prof = profiler.profile_layer_precisions(
        eval_fn, cfg.layer_names, tolerance=0.02, what="a_bits", min_bits=2)
    print(f"[2] profiled activation precisions: "
          f"{'-'.join(str(prof[n]) for n in cfg.layer_names)}")

    # -- 3+4. bit-serial serving path (the Loom engine) --------------------
    w = params["fc0"]["w"]
    pw = 8
    wq, ws = q.quantize(w.to(torch.float32), pw)
    packed = bitpack.pack_weights(wq, pw)
    shape = tuple(w.shape)
    print(f"[3] fc0 weights packed: {tuple(packed.shape)} uint8 = "
          f"{bitpack.packed_nbytes(shape, pw)} bytes "
          f"({pw}/16 of the {bitpack.baseline_nbytes(shape)}-byte baseline)")
    xin = torch.as_tensor(np.random.default_rng(1).normal(
        size=(16, w.shape[0])), dtype=torch.float32, device=device)
    y_serial = ops.loom_linear_serve(xin, packed, ws, a_bits=8, w_bits=pw)
    y_ref = xin @ w.to(torch.float32)
    rel = float(torch.linalg.norm(y_serial.to(torch.float32) - y_ref)
                / torch.linalg.norm(y_ref))
    print(f"[4] bit-serial matmul vs dense: rel err {rel:.4f} (8b/8b quant)")

    # -- 5. the paper's performance model ----------------------------------
    s = cm.geomean_speedup("lm1b", "t3", "all")
    print(f"[5] Loom LM_1b modeled speedup over DPNN "
          f"(Table 4 geomean): {s:.2f}x (paper: 4.38x)")

    # -- bonus: the same engine inside a transformer -----------------------
    tcfg = configs.get("qwen3-1.7b", smoke=True)
    tparams = M.init_params(tcfg, torch.Generator(device).manual_seed(1),
                            device)
    pol = policy.uniform_policy(8, 8)
    sp = M.convert_params_for_serving(tparams, pol, "serve_int8")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(2, 16)), device=device)
    lg_d, _ = M.forward_train(tparams, tcfg, toks,
                              build_plan(tcfg, mode="dense"))
    lg_q, _ = M.forward_train(sp, tcfg, toks,
                              build_plan(tcfg, pol, mode="serve_int8"))
    corr = np.corrcoef(lg_d.float().cpu().numpy().ravel(),
                       lg_q.float().cpu().numpy().ravel())[0, 1]
    print(f"[6] transformer int8 serving vs dense: logit corr {corr:.4f}")
    print("quickstart done.")
    return {"profile": prof, "rel_err": rel, "speedup": s, "corr": corr}


if __name__ == "__main__":
    run(main, __doc__)
