"""The op analyzer (``repro_torch.launch.opanalysis``), the counterpart of
the reference's ``hloanalysis``, and the kernels' work formula
(``repro_torch.kernels.work``) it shares with ``chip_smoke.py``.

Hand counts: a linear's 2·M·N·K and its bytes, a loop of 8, views, a
cache slot write, an embedding lookup, a row-parallel Loom linear's one int32 SUM on a fake
world of 8 ranks; each Loom backend op counted as its kernel, by its
formula, on ``torch_ref`` and on ``cuda`` (plain versions on CPU
tensors) alike; a served step run for real equal, count for count, to
the dry run's fake trace (qwen3, the hybrid jamba and the VLM), and a
train step, its backward counted, to ``dryrun.train_counts``; the dense smoke prefill's operations against
the reference's ``analyze_hlo`` of its jitted prefill; and the bound
column of ``PERF.md``'s kernel table from the shared formula at the
table's shapes.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.api import backend as B
from repro_torch.core import bitpack
from repro_torch.core.policy import uniform_policy
from repro_torch.kernels import work as W
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.opanalysis import OpAnalysis, roofline_terms

jax.config.update("jax_platform_name", "cpu")


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def test_one_linear_counts_2mnk_and_its_bytes():
    x, w = torch.randn(6, 40), torch.randn(40, 24)
    with OpAnalysis(memory=False) as a:
        y = x @ w
    t = a.totals()
    assert t.flops == 2 * 6 * 24 * 40 and t.flops_by_type == {"f32": t.flops}
    assert t.hbm_bytes == _bytes(x, w, y)
    with OpAnalysis(memory=False) as a8:
        for _ in range(8):
            y = x @ w
    assert a8.totals().flops == 8 * t.flops
    assert a8.totals().hbm_bytes == 8 * t.hbm_bytes


def test_views_count_nothing_and_a_broadcast_counts_once():
    x = torch.randn(16, 32)
    with OpAnalysis(memory=False) as a:
        x.view(32, 16), x.t(), x[:, :4], x.reshape(4, 128), x.unsqueeze(0)
    assert a.totals().hbm_bytes == 0 and a.totals().n_ops > 0
    row = torch.randn(1, 32)
    with OpAnalysis(memory=False) as b:
        y = x + row.expand(16, 32)
    assert b.totals().hbm_bytes == _bytes(x, row, y)


@pytest.mark.parametrize("memory", [True, False])
def test_the_analysis_lets_its_arguments_go(memory):
    """No tensor handed to ``OpAnalysis(arguments=)`` outlives the block
    once its caller drops it, without the cyclic collector: the analysis
    and its recorder refer to each other, and on the card a served
    step's weights kept that way (jamba's 13.5 GB packed tree) left the
    train phase that followed out of memory."""
    import gc
    import weakref
    x = torch.randn(64, 32)
    alive = weakref.ref(x)
    gc.disable()
    try:
        with OpAnalysis(memory=memory, arguments=(x, {"w": x})) as a:
            x * 2
        assert a.totals().argument_bytes == (_bytes(x) if memory else 0)
        del x
        assert alive() is None
    finally:
        gc.enable()


def test_a_cache_slot_write_counts_the_slot_only():
    cache = torch.zeros(2, 64, 4, 8)
    val = torch.randn(2, 4, 8)
    with OpAnalysis(memory=False) as a:
        cache[:, 5] = val
    assert a.totals().hbm_bytes == 2 * _bytes(val)
    idx = torch.tensor([7])
    with OpAnalysis(memory=False) as b:
        cache.index_copy_(1, idx, val[:, None])
    assert b.totals().hbm_bytes == 2 * _bytes(val) + _bytes(idx)


def test_a_gather_counts_the_rows_it_gathers():
    """An embedding lookup reads its rows, not the table."""
    emb, tok = torch.randn(1000, 16), torch.tensor([[1, 5, 7]])
    with OpAnalysis(memory=False) as a:
        rows = emb[tok]
    assert a.totals().hbm_bytes == _bytes(tok) + 2 * _bytes(rows)


def test_a_product_summed_over_its_last_dim_counts_as_a_product():
    """``decode_attend``'s products (an elementwise product and a sum,
    for batch invariance) count as its einsum's."""
    q, k = torch.randn(2, 3, 1, 16), torch.randn(2, 3, 50, 16)
    with OpAnalysis(memory=False) as a:
        (q * k).sum(-1)
    with OpAnalysis(memory=False) as b:
        torch.einsum("bhqd,bhkd->bhqk", q, k)
    assert a.totals().flops == b.totals().flops == 2 * 2 * 3 * 50 * 16


def _ops_cases():
    g = torch.Generator().manual_seed(3)
    xq = torch.randint(-127, 128, (5, 64), generator=g, dtype=torch.int8)
    w8 = torch.randint(-128, 128, (64, 48), generator=g, dtype=torch.int32)
    wp = bitpack.pack_weights(w8, 8)
    w11 = bitpack.pack_weights(torch.randint(-1024, 1024, (27, 32),
                                             generator=g,
                                             dtype=torch.int32), 11)
    xc = torch.randint(-127, 128, (2, 6, 6, 3), generator=g,
                       dtype=torch.int8)
    counts = torch.full((2, 3), 5, dtype=torch.int32)
    x2 = torch.randn(5, 64, generator=g)
    qkv = [torch.randn(1, 2, 16, 8, generator=g) for _ in range(3)]
    return [
        ("matmul_planes", (xq, wp), dict(w_bits=8), ["K1"]),
        ("matmul_planes", (xq, wp), dict(w_bits=8, w_counts=(8, 3, 8),
                                         w_group=16), ["K3"]),
        ("matmul_planes_dynamic", (xq, wp, torch.tensor([4, 8, 2],
                                                        dtype=torch.int32)),
         dict(w_bits=8, bn=16), ["K3"]),
        ("conv_planes", (xc, w11), dict(kernel=3, stride=1, w_bits=11),
         ["K2"]),
        ("conv_planes", (xc, w11), dict(kernel=3, stride=1, w_bits=11,
                                        w_counts=(9, 11), w_group=16),
         ["K4"]),
        ("conv_planes_dynamic", (xc, w11, counts),
         dict(kernel=3, stride=1, w_bits=11, group_size=12), ["K5"] * 2),
        ("dynamic_quant", (x2,), dict(group_size=16, bits=8), ["K6"]),
        ("attention", tuple(qkv), dict(causal=True, window=6), ["K7"]),
    ]


@pytest.mark.parametrize("case", range(8))
def test_each_backend_op_counts_its_kernel_by_its_formula(case):
    op, args, kw, kernels = _ops_cases()[case]
    got = {}
    for name in ("torch_ref", "cuda"):
        with OpAnalysis(memory=False) as a:
            out = getattr(B.resolve_backend(name), op)(*args, **kw)
        got[name] = a.totals()
    ref, cuda = got["torch_ref"], got["cuda"]
    assert ref.counts() == cuda.counts()
    assert ref.kernels == {kernels[0]: len(kernels)}
    # no aten op of the plain version is counted: every byte is the
    # kernel's formula
    assert ref.hbm_bytes == ref.kernel_bytes and ref.flops == ref.kernel_ops
    from repro_torch.launch.opanalysis import _kernel_calls
    want = [W.work(n, ka, kk, out if n == "dynamic_quant" else
                   (out[0] if isinstance(out, tuple) else out))
            for n, ka, kk in _kernel_calls(op, args, kw)]
    assert ref.kernel_bytes == sum(w[0] for w in want)
    assert ref.kernel_ops == sum(w[1] for w in want)


def test_a_guarded_op_counts_once():
    xq = torch.randint(-127, 128, (4, 32), dtype=torch.int8)
    wp = bitpack.pack_weights(torch.randint(-8, 8, (32, 16),
                                            dtype=torch.int32), 4)
    with OpAnalysis(memory=False) as a:
        B.guard_backend("cuda").matmul_planes(xq, wp, w_bits=4)
    assert a.totals().kernels == {"K1": 1}


def test_a_served_step_counts_as_its_dry_run():
    """The smoke qwen3's ``serve_packed`` prefill (2 x 32) and one decode
    step at the int position ``generate`` passes, run for real on
    ``cuda`` (its kernels' plain versions on CPU tensors) under the
    analyzer, against the world-one dry run's fake trace on ``torch_ref``:
    operations, bytes and kernels equal (the card check of
    ``chip_smoke.py``'s launch phase, on the CPU)."""
    cfg = configs.get("qwen3-1.7b", smoke=True)
    sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                               mode="serve_packed", device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 32), dtype=torch.int32)
    cache = sess.init_cache(2, 48)
    with torch.inference_mode():
        with OpAnalysis(arguments=(sess.params, cache)) as pre:
            logits, cache = sess._prefill(sess.params, tokens, cache)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
        with OpAnalysis(arguments=(sess.params, cache)) as dec:
            sess._decode(sess.params, tok, 32, cache)
    dry = dryrun.serving_counts(cfg, "serve_packed", 2, 32, 48)
    assert pre.totals().counts() == dry["prefill"].counts()
    assert dec.totals().counts() == dry["decode"].counts()
    assert pre.totals().kernels == {"K1": 2 * 7 + 1}
    assert dry["decode"].peak_bytes > 0


# (arch, K1 per prefill, K1 per decode step) at the smoke configs: jamba's
# mamba block (6) with a gated FFN (3) and attention block (4) with a MoE
# of no shared experts (0), and the head: 14; the VLM's attention block
# (4 + 3), its cross-attention block (6 in prefill, the image K/V
# projected for its cache and its attention; 2 in decode; + 3) and the
# head: 17 and 13.
SERVED_ARCHS = [("jamba-v0.1-52b", 14, 14), ("llama-3.2-vision-90b", 17, 13)]


@pytest.mark.parametrize("name,k1_pre,k1_dec", SERVED_ARCHS,
                         ids=["jamba", "vision"])
def test_served_steps_count_as_their_dry_run(name, k1_pre, k1_dec):
    """The hybrid (mamba, attention and MoE blocks) and the VLM (cross-
    attention over image embeddings, which its prefill takes): a
    ``serve_packed`` prefill (2 x 16) and one decode step run for real
    under the analyzer count what ``dryrun.serving_counts`` counts
    (``chip_smoke.py``'s archs phase holds the same on the card at the
    cut published configs)."""
    cfg = configs.get(name, smoke=True)
    sess = repro_torch.compile(cfg, uniform_policy(8, 8),
                               mode="serve_packed", device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 16))).to(torch.int32)
    img = ()
    if cfg.n_img_tokens:
        img = (torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, cfg.n_img_tokens, cfg.d_model)).astype(
            np.float32)).to(torch.bfloat16),)
    cache = sess.init_cache(2, 24)
    with torch.inference_mode():
        with OpAnalysis(arguments=(sess.params, cache) + img) as pre:
            logits, cache = sess._prefill(sess.params, tokens, cache, *img)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)
        with OpAnalysis(arguments=(sess.params, cache)) as dec:
            sess._decode(sess.params, tok, 16, cache)
    dry = dryrun.serving_counts(cfg, "serve_packed", 2, 16, 24)
    assert pre.totals().counts() == dry["prefill"].counts()
    assert dec.totals().counts() == dry["decode"].counts()
    assert pre.totals().kernels == {"K1": k1_pre}
    assert dec.totals().kernels == {"K1": k1_dec}


@pytest.mark.parametrize("inference", [False, True])
def test_moe_routing_counts_alike_on_real_and_fake_tensors(inference):
    """The MoE's top-k routing and capacity dispatch count the same
    operations, bytes and aten ops on real tensors as on the dry run's
    fake ones, with and without ``inference_mode``. ``F.one_hot`` chose
    its ops by device and mode (a range check and a scatter on real CPU
    tensors with autograd on, ``zeros`` and ``scatter_`` on CUDA ones, a
    comparison on fake ones): on the card jamba's analyzed prefill counted
    395264 HBM bytes fewer than its dry run. ``moe._one_hot`` is one
    comparison everywhere."""
    from repro_torch.models import moe
    cfg = configs.get("jamba-v0.1-52b", smoke=True).moe

    def route(x, w):
        probs, ids, aux = moe._route(moe.router_logits(x, w), cfg)
        return moe.dispatch(ids, cfg, 5)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, cfg.d_model, generator=g).to(torch.bfloat16)
    w = torch.randn(cfg.d_model, cfg.n_experts, generator=g)
    with torch.inference_mode(inference), OpAnalysis(memory=False) as real:
        route(x, w)
    with shapes.fake_mode():
        fx, fw = torch.empty_like(x), torch.empty_like(w)
        with torch.inference_mode(inference), \
                OpAnalysis(memory=False) as fake:
            route(fx, fw)
    assert real.totals().counts() == fake.totals().counts()
    assert real.totals().n_ops == fake.totals().n_ops


@pytest.mark.parametrize("mode", ["dense", "fake_quant"])
def test_a_train_step_counts_as_its_dry_run(mode):
    """One real train step (AdamW, float32 moments, a schedule; 2 x 32
    int32 tokens and labels, as the dry run lays out its batch) of the
    smoke qwen3 at 4 layers under the analyzer, against
    ``dryrun.train_counts`` (the same moments; the schedule changes
    values, not operations), traced at one and two layers and
    extrapolated, as on the card at 28: operations, bytes and kernels
    (none) equal. The backward is counted:
    the step's operations are three times the forward's (a product's two
    gradient products each), within 1%."""
    from repro_torch.api.plan import build_plan
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import Schedule
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True),
                              n_layers=4, remat="none")
    tc = T.TrainConfig(sched=Schedule(warmup_steps=2, total_steps=8))
    state, _ = T.make_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                  "cpu")
    plan = build_plan(cfg, uniform_policy(8, 8), mode)
    step = T.make_train_step(cfg, plan, tc)
    batch = {k: torch.as_tensor(v, dtype=torch.int32) for k, v in
             synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                        global_batch=2), 0).items()}
    with OpAnalysis(arguments=(state, batch)) as a:
        step(state, batch)
    with torch.no_grad(), OpAnalysis(memory=False) as fwd:
        M.loss_fn(state["params"], cfg, T.batch_on(batch, "cpu"), plan)
    dry = dryrun.train_counts(cfg, mode, 2, 32)
    assert a.totals().counts() == dry.counts()
    assert a.totals().kernels == {}
    assert a.totals().flops / fwd.totals().flops == pytest.approx(3, rel=0.01)


def test_the_dry_run_extrapolates_a_deep_model_exactly():
    """Traced at one and two layer groups and extrapolated, the counts of
    a four-group model equal its whole trace."""
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True),
                              n_layers=4)
    cell = shapes.ShapeCell("p", "prefill", 32, 2)
    part = dryrun.traced_totals(cfg, cell, "serve_packed", "serve_packed")
    whole = dryrun.traced_totals(cfg, cell, "serve_packed", "serve_packed",
                                 full_depth=True)
    assert part[3] == 3 and whole[3] == 4
    assert part[0].counts() == whole[0].counts()
    assert part[0].argument_bytes == whole[0].argument_bytes


def test_row_parallel_linear_sums_once_on_a_fake_world():
    """On a fake world of 8 ranks ("model" 8), a row-parallel packed Loom
    linear hands one int32 SUM of the local [M, N] to its collectives
    (in a subprocess: one default group a process)."""
    script = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.api import backend as B, plan as planlib
from repro_torch.core.policy import uniform_policy
from repro_torch.dist.parallel import ShardCtx
from repro_torch.launch.opanalysis import OpAnalysis, roofline_terms
from repro_torch.models import layers as L
mesh = init_device_mesh("cpu", (1, 8), mesh_dim_names=("data", "model"))
sh = ShardCtx(mesh)
lp = planlib.LayerPlan(name="x", kind="linear", route=planlib.PACKED)
w = L.convert_linear_for_serving({"w": torch.randn(512, 96)},
                                 uniform_policy(8, 8).lookup("x"),
                                 "serve_packed")
w = {"w_packed": w["w_packed"][:, :8], "w_scale": w["w_scale"]}
x = torch.randn(5, 512).to(torch.bfloat16)
with OpAnalysis(sh.comm, memory=False) as a:
    y = sh.lin("tp", "fsdp").apply(L._linear_packed, w, x, lp,
                                   B.resolve_backend("torch_ref"))
t = a.totals()
print(json.dumps({"kinds": t.collective_by_kind, "n": t.n_collectives,
                  "shape": list(y.shape), "k1": t.kernels,
                  "t_coll": roofline_terms(t)["t_collective_s"]}))
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH="src"),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    import json
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["n"] == {"all_reduce-torch.int32-sum": 1}
    assert got["kinds"] == {"all_reduce-torch.int32-sum": 5 * 96 * 4}
    assert got["shape"] == [5, 96] and got["k1"] == {"K1": 1}
    # ranks 0-7 share a node: NVLink's rate
    assert got["t_coll"] == 5 * 96 * 4 / W.NVLINK_BYTES_PER_S


def test_dense_prefill_flops_against_the_references_hlo():
    """The dense smoke qwen3 prefill's operations at world one against the
    reference's ``analyze_hlo`` of its jitted prefill (one attention
    block: no causal block is skipped on either side). The gap measured
    0 (10551296 operations on both sides): every product of the prefill
    is a dot in XLA's module and an ``mm`` / ``bmm`` of the port's trace,
    of the same sizes, and neither side counts the elementwise rest. Held
    equal, three times the gap."""
    from repro import configs as jconfigs
    from repro.api import build_plan as jbuild_plan
    from repro.core.policy import uniform_policy as juniform
    from repro.launch import hloanalysis
    from repro.launch import shapes as jshapes
    from repro.launch.serve import make_serve_fns
    jcfg = jconfigs.get("qwen3-1.7b", smoke=True)
    plan = jbuild_plan(jcfg, juniform(8, 8), mode="dense", backend="xla")
    prefill, _ = make_serve_fns(jcfg, plan)
    params, _ = jshapes.param_structs(jcfg)
    cell = jshapes.ShapeCell("p", "prefill", 32, 2)
    batch, _ = jshapes.batch_structs(jcfg, cell)
    cache, _ = jshapes.cache_structs(jcfg, cell)
    hlo = jax.jit(prefill).lower(params, batch["tokens"], cache).compile()
    want = hloanalysis.analyze_hlo(hlo.as_text()).flops
    cfg = configs.get("qwen3-1.7b", smoke=True)
    got = dryrun.traced_totals(cfg, shapes.ShapeCell("p", "prefill", 32, 2),
                               "dense", "dense")[0].flops
    print(f"port {got!r}, reference HLO {want!r}, gap "
          f"{(want - got) / want!r}")
    assert got == want


# -- the bound column of PERF.md's kernel table --------------------------------

def _fake(shape, dtype):
    with shapes.fake_mode():
        return torch.empty(shape, dtype=dtype)


def test_the_shared_formula_gives_the_tables_bounds():
    """K6 and K7 at the ops path's and the timing cases' shapes, and K1
    over the full qwen3-1.7b's 197 linears of a 2 x 512 prefill and of a
    decode step (the world-one dry run): ``PERF.md``'s bound column, in
    ms, to its printed digits."""
    def bound_ms(name, args, kw, out):
        return W.bound_s(*W.work(name, args, kw, out))[0] * 1e3

    k6 = sum(bound_ms("dynamic_quant", (_fake((1024, k), torch.float32),),
                      {}, (_fake((1024, k), torch.int8),
                           _fake((1024, k // 256), torch.float32),
                           _fake((1024, k // 256), torch.int32)))
             for k in (2048, 6144))
    assert round(k6, 4) == 0.0126
    for shape, window, want in (((2, 16, 512, 128), None, 0.00501),
                                ((1, 16, 4096, 128), None, 0.0695),
                                ((1, 16, 4096, 128), 1024, 0.0304),
                                ((1, 16, 32768, 128), None, 4.4471)):
        q = _fake(shape, torch.bfloat16)
        got = bound_ms("flash_attention", (q, q, q),
                       {"causal": True, "window": window}, q)
        assert round(got, len(str(want)) - 2) == want, (shape, window, got)
    lm = dryrun.serving_counts(configs.get("qwen3-1.7b"), "serve_packed",
                               2, 512, 544)
    assert lm["prefill"].kernels == {"K1": 197}
    assert round(lm["prefill"].kernel_bound_s["K1"] * 1e3, 4) == 1.5727
    assert round(lm["decode"].kernel_bound_s["K1"] * 1e3, 4) == 0.5156


def test_roofline_terms_on_the_datasheet_constants():
    from repro_torch.launch.opanalysis import Totals
    t = Totals(flops=2e12, flops_by_type={"bf16": 989e12 / 1e3,
                                          "int8": 1979e12 / 1e3},
               hbm_bytes=3.35e9, link_bytes={"node": 450e6,
                                             "network": 100e6})
    r = roofline_terms(t)
    assert r["t_compute_s"] == pytest.approx(2e-3)
    assert r["t_memory_s"] == pytest.approx(1e-3)
    assert r["t_collective_s"] == pytest.approx(1e-3 + 2e-3)
    assert r["dominant"] == "collective"
    assert np.isclose(r["bound_s"], 3e-3)
