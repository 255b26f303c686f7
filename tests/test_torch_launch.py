"""The port's launch analysis against the reference's (``repro.launch``):
the configs' fields, the shape grid and its fake-tensor inputs, the
analytic roofline figures, the mesh generality the dry run's cells need
(the sequence-split KV cache on every decode route, the ("pod", "data",
"model") mesh, the ``serve_2d_tp`` and ``long_500k`` rule overrides, on
gloo ranks of the CPU), and the dry run's own CLI on a fake world of 256
ranks.

The structs are compared leaf for leaf in shape and dtype at the
published widths with one layer group, or deepseek's pattern cut to its
dense layer and one MoE layer for the serving layouts (the reference
draws and converts its structs layer by layer, some seconds an arch),
beside a check that the port's published-depth trees are that group's
stacked over every group.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import functools
import glob
import json
import math
import os
import subprocess
import sys

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro.models import attention as jattn
from repro.models import model as jM
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch import configs, interop
from repro_torch.launch import dryrun, shapes
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig

import _dist_ranks as R
import _launch_ranks as LR

jax.config.update("jax_platform_name", "cpu")

ARCHS = configs.LM_ARCHS
MODES = ("dense", "serve_int8", "serve_packed")


def _jdryrun():
    # the reference's dryrun sets a 512-device XLA flag on import; keep it
    # from this process's environment.
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def _layout(tree) -> dict:
    """{path: (shape, dtype name)} of a port or reference tree."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in interop.flatten_with_paths(tree).items()}


def _specs(tree) -> dict:
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


def _shallow(cfg):
    """``cfg`` cut to one layer group, or a single group to its pattern's
    head and one layer of its final run (the dry run's shallower depth)."""
    variants = dryrun.depth_variants(cfg)
    return cfg if variants is None else variants[0]


# -- configs ---------------------------------------------------------------

def test_config_fields_are_the_references():
    for name in ARCHS:
        for smoke in (False, True):
            t, j = configs.get(name, smoke), jconfigs.get(name, smoke)
            assert {f.name for f in dataclasses.fields(t)} == \
                {f.name for f in dataclasses.fields(j)}, name
            assert t.sub_quadratic == j.sub_quadratic, name
    assert {f.name for f in dataclasses.fields(attn.AttnConfig)} == \
        {f.name for f in dataclasses.fields(jattn.AttnConfig)}
    for name in ARCHS:
        cfg, jcfg = configs.get(name), jconfigs.get(name)
        for spec, jspec in zip(cfg.pattern, jcfg.pattern):
            if spec.kind != "mamba":
                assert dataclasses.asdict(cfg.attn_cfg(spec)) == \
                    dataclasses.asdict(jcfg.attn_cfg(jspec)), name
    assert configs.LM_ARCHS == jconfigs.LM_ARCHS


@pytest.mark.parametrize("opt", ["kvcol", "kvrep"])
def test_kv_layout_options_move_the_kv_specs_as_the_reference(opt):
    jd = _jdryrun()
    cfg = dryrun.apply_opts(configs.get("qwen3-1.7b", smoke=True), [opt])
    jcfg = jd.apply_opts(jconfigs.get("qwen3-1.7b", smoke=True), [opt])
    _, jspecs = jshapes._eval_shape_with_specs(
        lambda: jM.init_params(jax.random.PRNGKey(0), jcfg))
    assert _specs(M.param_spec_tree(cfg)) == _specs(jspecs)


# -- the shape grid and its inputs -------------------------------------------

def test_shape_grid_and_applicability_are_the_references():
    assert shapes.SHAPE_ORDER == jshapes.SHAPE_ORDER
    for name, cell in shapes.SHAPES.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(
            jshapes.SHAPES[name])
    for a in ARCHS:
        for s in shapes.SHAPE_ORDER:
            assert shapes.cell_is_applicable(a, s) == \
                jshapes.cell_is_applicable(a, s), (a, s)


def _same_depth(whole, one, n: int, stacked) -> None:
    """``whole``'s leaves are ``one``'s, the ``stacked`` ones (by path)
    with their leading group dim n."""
    lw, lo = _layout(whole), _layout(one)
    assert lw.keys() == lo.keys()
    for key, (shape, dt) in lw.items():
        want = lo[key]
        if stacked(key):
            want = ((n,) + want[0][1:], want[1])
        assert (shape, dt) == want, key


@pytest.mark.parametrize("name", ARCHS)
def test_structs_equal_the_references(name):
    """Params (dense and each serving layout), the train state, the cache
    of every shape and the batch of every cell, leaf for leaf, and their
    spec trees, against the reference's at one layer group (deepseek's
    single group: dense, train state and caches whole, the serving
    layouts at its dense layer and one MoE layer); and the port's
    published-depth trees are that group's stacked over every group."""
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    g1 = _shallow(cfg)
    jg1 = dataclasses.replace(jcfg, n_layers=g1.n_layers, pattern=tuple(
        type(jcfg.pattern[0])(**dataclasses.asdict(s)) for s in g1.pattern))
    deep = cfg.n_groups > 1
    one, jone = (g1, jg1) if deep else (cfg, jcfg)
    n = cfg.n_groups

    def blocks(key):
        return "blocks/" in key

    for mode in MODES:
        c, jc = (one, jone) if mode == "dense" else (g1, jg1)
        p, ps = shapes.param_structs(c, serving_mode=mode)
        jp, jps = jshapes.param_structs(jc, serving_mode=mode)
        assert _layout(p) == _layout(jp), mode
        assert _specs(ps) == _specs(jps), mode
        if deep:
            _same_depth(shapes.param_structs(cfg, serving_mode=mode)[0], p,
                        n, blocks)
    st, sts = shapes.train_state_structs(one, AdamWConfig())
    jst, jsts = jshapes.train_state_structs(jone, JAdamWConfig())
    assert _layout(st) == _layout(jst)
    assert _specs(sts) == _specs(jsts)
    if deep:
        _same_depth(shapes.train_state_structs(cfg, AdamWConfig())[0], st,
                    n, blocks)
    for s in shapes.SHAPE_ORDER:
        cell, jcell = shapes.SHAPES[s], jshapes.SHAPES[s]
        c, cs = shapes.cache_structs(one, cell)
        jc, jcs = jshapes.cache_structs(jone, jcell)
        assert _layout(c) == _layout(jc), s
        assert _specs(cs) == _specs(jcs), s
        if deep:
            _same_depth(shapes.cache_structs(cfg, cell)[0], c, n,
                        lambda key: True)
        b, bs = shapes.batch_structs(cfg, cell)
        jb, jbs = jshapes.batch_structs(jcfg, jcell)
        assert _layout(b) == _layout(jb), s
        assert _specs(bs) == _specs(jbs), s


def test_structs_are_fake_and_read_no_value():
    from torch._subclasses.fake_tensor import FakeTensor
    p, _ = shapes.param_structs(configs.get("llama3-405b"),
                                serving_mode="serve_packed")
    leaves = list(interop.flatten_with_paths(p).values())
    assert all(isinstance(t, FakeTensor) for t in leaves)
    assert shapes.tree_bytes(p) > 3e11          # 405B weights, none held


# -- the analytic figures ----------------------------------------------------

@pytest.fixture(scope="module")
def jd_cached(request):
    """The reference's dryrun with its parameter count computed once per
    config (it draws the init's structs on every call)."""
    jd = _jdryrun()
    mp = pytest.MonkeyPatch()
    mp.setattr(jshapes, "active_param_count",
               functools.cache(jshapes.active_param_count))
    request.addfinalizer(mp.undo)
    return jd


def test_analytic_figures_equal_the_references(jd_cached):
    jd = jd_cached
    for name in ARCHS:
        cfg, jcfg = configs.get(name), jconfigs.get(name)
        assert shapes.active_param_count(cfg) == \
            jshapes.active_param_count(jcfg), name
        for s in shapes.SHAPE_ORDER:
            cell = shapes.SHAPES[s]
            assert dryrun.model_flops(cfg, cell) == \
                jd.model_flops(jcfg, jshapes.SHAPES[s]), (name, s)
            cache = dryrun._cache_bytes(cfg, cell)     # layouts: above
            for w in MODES:
                got = dryrun.ideal_bounds(cfg, cell, 256, w, cache)
                want = jd.ideal_bounds(jcfg, jshapes.SHAPES[s], 256, w,
                                       cache)
                assert got["ideal_mem_bytes"] == want["ideal_mem_bytes"]


def test_overrides_and_opts_are_the_references():
    jd = _jdryrun()
    for s, cell in shapes.SHAPES.items():
        for mk in ("single", "multi"):
            for tp2 in (False, True):
                assert dryrun.overrides_for(cell, mk, tp2) == \
                    jd.overrides_for(jshapes.SHAPES[s], mk, tp2)
    opts = ["kvcol", "pinseq", "kv8", "gqa", "maskupd", "kvrep",
            "attnint8", "rematdots", "flashvjp", "block256"]
    cfg = dryrun.apply_opts(configs.get("qwen3-1.7b"), opts)
    jcfg = jd.apply_opts(jconfigs.get("qwen3-1.7b"), opts)
    for f in dataclasses.fields(cfg):
        if f.name not in ("pattern", "moe", "ssm"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for o in ("moedff", "moeep", "moesm"):
        a = dryrun.apply_opts(configs.get("deepseek-moe-16b"), [o]).moe
        b = jd.apply_opts(jconfigs.get("deepseek-moe-16b"), [o]).moe
        assert (a.expert_parallel, a.shard_map_ep) == \
            (b.expert_parallel, b.shard_map_ep), o


def test_depth_variants_rebuild_the_whole_pattern():
    q = configs.get("qwen3-1.7b")
    a, b, n = dryrun.depth_variants(q)
    assert (a.n_layers, b.n_layers, n) == (1, 2, 27)
    d = configs.get("deepseek-moe-16b")
    a, b, n = dryrun.depth_variants(d)
    assert (a.n_layers, b.n_layers, n) == (2, 3, 26)
    assert a.pattern[0] == d.pattern[0] and b.pattern[1:] == d.pattern[-2:]
    assert dryrun.depth_variants(configs.get("qwen3-1.7b", smoke=True)) \
        is None


# -- meshes: the sequence-split cache, the pod mesh, the overrides ----------

SPLIT = ("split_cache", "combine_f32", "qwen_bf16", "qwen_kv8", "qwen_int8",
         "qwen_mask", "qwen_kvcol", "qwen_kvrep", "gemma_bf16", "gemma_kv8",
         "gemma_int8", "vision")
WORLDS = {
    # (1, 2) runs every check (in two entries)
    "1x2": ((1, 2), ("data", "model"), {},
            ("heads", "qwen_kvcol_heads", "qwen_kvrep_heads", "train_split")
            + SPLIT[:6]),
    "1x2b": ((1, 2), ("data", "model"), {}, SPLIT[6:]),
    "2x2": ((2, 2), ("data", "model"), {},
            ("heads", "combine_f32", "qwen_bf16", "qwen_int8", "gemma_kv8",
             "gemma_int8")),
    "pod": ((2, 1, 2), ("pod", "data", "model"), {}, ("heads", "mamba")),
    "2dtp": ((2, 2), ("data", "model"), dryrun.overrides_for(
        shapes.SHAPES["decode_32k"], "single", True),
        ("qwen", "gemma_int8", "whole_heads")),
    "long": ((1, 2), ("data", "model"), dryrun.overrides_for(
        shapes.SHAPES["long_500k"], "single"),
        ("gemma", "jamba", "mamba", "combine_f32")),
}
CASES = [(w, c) for w, spec in WORLDS.items() for c in spec[3]]


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """{world: (results, errs) by check}: the meshes of one size share a
    set of processes (a world of 2 and one of 4, started together)."""
    by_size = {}
    for w, (shape, names, ov, checks) in WORLDS.items():
        by_size.setdefault(math.prod(shape), []).append(
            (w, shape, names, ov, checks))
    started = [LR.start(meshes, str(tmp_path_factory.mktemp(f"world{n}")))
               for n, meshes in by_size.items()]
    out = {w: ({}, {}) for w in WORLDS}
    for s in started:
        for i, got in enumerate(R.collect(s)):
            for key, v in got.items():
                w, check = key.split("/")
                out[w][i][check] = v
    return out


@pytest.mark.parametrize("world,check", CASES,
                         ids=[f"{w}-{c}" for w, c in CASES])
def test_meshed_decode_matches_unsharded(mesh_results, world, check):
    results, errs = mesh_results[world]
    got = results[check]
    assert got == ["ok"] * len(got), "\n".join(r for r in got if r != "ok")
    if check in errs:
        print(f"{world} {check}: {errs[check]!r} (limits: logits "
              f"{LR.SPLIT_ATOL}, int8 route {LR.INT8_SPLIT_ATOL}; combine "
              f"float {LR.COMBINE_ATOL}, int8 {LR.INT8_COMBINE_ATOL})")


_ROLES = r"""
import json, sys
from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.dist.parallel import ShardCtx
from repro_torch.launch import dryrun, shapes
from repro_torch.models import attention as A
out = {}
for mk, shape, tp2 in (("single", "decode_32k", False),
                       ("single", "long_500k", False),
                       ("single", "decode_32k", True),
                       ("multi", "long_500k", False),
                       ("multi", "train_4k", False)):
    mesh = dryrun.production_mesh(mk)
    sharding.set_rule_overrides(dryrun.overrides_for(
        shapes.SHAPES[shape], mk, tp2))
    sh = ShardCtx(mesh)
    out[f"{mk} {shape} {tp2}"] = {
        r: [list(sh.axes(r)), sh.size(r)] for r in sh.ROLES}
    out[f"{mk} {shape} {tp2}"]["split"] = A.seq_split(
        configs.get("mixtral-8x7b"), sh)
    sharding.set_rule_overrides({})
print(json.dumps(out))
"""


def test_shardctx_resolves_the_cells_rules_on_a_fake_world():
    """On the production meshes (a fake world, in a subprocess): the
    roles' mesh axes and sizes under each cell's overrides, and the cache
    layout they select for mixtral (8 KV heads on 16 "tp" ranks)."""
    r = subprocess.run([sys.executable, "-c", _ROLES], capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH="src"),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["single decode_32k False"] == {
        "dp": [["data"], 16], "fsdp": [["data"], 16],
        "tp": [["model"], 16], "sp": [["model"], 16], "split": True}
    assert got["single long_500k False"] == {
        "dp": [[], 1], "fsdp": [["data"], 16], "tp": [["model"], 16],
        "sp": [["data", "model"], 256], "split": True}
    assert got["single decode_32k True"] == {
        "dp": [[], 1], "fsdp": [[], 1], "tp": [["data", "model"], 256],
        "sp": [["model"], 16], "split": True}
    assert got["multi long_500k False"]["sp"] == [
        ["pod", "data", "model"], 512]
    assert got["multi train_4k False"]["dp"] == [["pod", "data"], 32]


# -- the dry run's CLI on a fake world of 256 ranks --------------------------

def test_dryrun_cell_subprocess(tmp_path):
    """The reference test's own cell (``tests/test_launch.py``)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           "musicgen_large", "--shape", "decode_32k", "--mesh", "single",
           "--out-dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=".",
                       env=env, timeout=300)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    assert "OK" in r.stdout
    recs = [json.load(open(p)) for p in glob.glob(str(tmp_path) + "/*.json")]
    assert recs and recs[0]["n_devices"] == 256
    assert recs[0]["t_memory_s"] > 0 and recs[0]["flops"] > 0
    assert 0 < recs[0]["roofline_fraction"] <= 1
