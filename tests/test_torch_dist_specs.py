"""The port's logical spec trees and their resolution equal the JAX
reference's (``repro.models.*`` specs, ``repro.dist.sharding``), with no
device and no process: the reference's resolution reads only a mesh's
axis names, so a stand-in object serves, and its spec trees come from
``jax.eval_shape`` (nothing allocated)."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import os
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.policy import uniform_policy as juniform
from repro.dist import sharding as jshd
from repro.launch import shapes as jshapes
from repro.models import cnn as jcnn, model as jM
from repro_torch import configs
from repro_torch.dist import sharding as shd
from repro_torch.models import cnn, model as M

ARCHS = configs.ARCHS                      # all eleven, the CNN included
MODES = ("dense", "serve_int8", "serve_packed")


def _overrides_for(*args, **kw):
    # dryrun sets a 512-device XLA flag on import; keep it from reaching
    # this process's jax.
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun.overrides_for(*args, **kw)


def _tuples(tree, leaf):
    if leaf(tree):
        return tuple(tree)
    return {k: _tuples(v, leaf) for k, v in tree.items()}


def _jax_specs(name: str, mode: str):
    jcfg = jconfigs.get(name, smoke=True)
    key = jax.random.PRNGKey(0)
    if hasattr(jcfg, "convs"):
        structs, specs = jshapes._eval_shape_with_specs(
            lambda: jcnn.init_params(key, jcfg))
        if mode != "dense":
            _, specs = jshapes._eval_shape_with_specs(
                lambda: jM._convert_tree(jcnn.init_params(key, jcfg)[0],
                                         specs, juniform(8, 8), mode))
        return specs, None
    structs, specs = jshapes._eval_shape_with_specs(
        lambda: jM.init_params(key, jcfg))
    if mode != "dense":
        specs = jM.convert_specs_for_serving(structs, specs, mode)
    return specs, jM.cache_spec_tree(jcfg)


def _port_specs(name: str, mode: str):
    cfg = configs.get(name, smoke=True)
    if hasattr(cfg, "convs"):
        specs = cnn.param_specs(cfg)
        if mode != "dense":
            skel = {k: {"w": torch.empty(1, 1, device="meta")}
                    for k in specs}
            specs = M.convert_specs_for_serving(skel, specs, mode)
        return specs, None
    specs = M.param_spec_tree(cfg)
    if mode != "dense":
        specs = M.convert_specs_for_serving(M.param_skeleton(cfg), specs,
                                            mode)
    return specs, M.cache_spec_tree(cfg)


def _is_ps(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@pytest.fixture(scope="module")
def spec_trees():
    out = {}
    for name in ARCHS:
        for mode in MODES:
            out[name, mode] = (_jax_specs(name, mode), _port_specs(name, mode))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_spec_trees_match_reference(spec_trees, name):
    for mode in MODES:
        (jp, jc), (tp, tc) = spec_trees[name, mode]
        assert _tuples(tp, shd.is_spec) == _tuples(jp, _is_ps), (name, mode)
        if jc is not None:
            assert _tuples(tc, shd.is_spec) == _tuples(jc, _is_ps), name


def _leaves(tree, leaf):
    if leaf(tree):
        return [tree]
    return [x for v in tree.values() for x in _leaves(v, leaf)]


_MESHES = {"host": ("data", "model"), "multi": ("pod", "data", "model")}
_CELLS = [("none", None, False), ("long_500k", "long_500k", False),
          ("serve_2d_tp", "decode_32k", True)]


@pytest.mark.parametrize("mesh_kind", sorted(_MESHES))
@pytest.mark.parametrize("case", _CELLS, ids=[c[0] for c in _CELLS])
def test_resolution_matches_reference(spec_trees, mesh_kind, case):
    _, cell, serve_2d = case
    mesh = types.SimpleNamespace(axis_names=_MESHES[mesh_kind],
                                 shape=(2,) * len(_MESHES[mesh_kind]))
    ov = {} if cell is None else _overrides_for(
        jshapes.SHAPES[cell], "multi" if mesh_kind == "multi" else
        "single", serve_2d_tp=serve_2d)
    specs = {tuple(s) for (jp, jc), _ in spec_trees.values()
             for tree in (jp, jc) if tree is not None
             for s in _leaves(tree, _is_ps)}
    specs |= {("dp",), ("dp", None), ("fsdp", "fsdp"), (("dp", "tp"), "tp")}
    try:
        jshd.set_rule_overrides(ov)
        shd.set_rule_overrides(ov)
        rules = jshd.rules_for_mesh(mesh)
        assert shd.rules_for_mesh(mesh) == rules
        for s in sorted(specs, key=repr):
            want = jshd._drop_missing(jshd._dedup_axes(
                jshd.resolve_spec(jax.sharding.PartitionSpec(*s), rules)),
                mesh)
            got = shd.resolve(shd.Spec(*s), mesh)
            assert tuple(got) == tuple(want), (s, ov)
            assert shd.resolve(got, mesh) == got            # idempotent
            names = mesh.axis_names
            for i, pl in enumerate(shd.placements(shd.Spec(*s), mesh)):
                dims = [d for d, e in enumerate(got)
                        if names[i] in (e if isinstance(e, tuple) else (e,))]
                assert (pl.is_shard() and [pl.dim] == dims) or \
                    (pl.is_replicate() and not dims), (s, i, pl)
        tree = shd.resolve_tree({"a": {"b": shd.Spec("fsdp", "tp")}}, mesh)
        assert tree["a"]["b"] == shd.placements(shd.Spec("fsdp", "tp"), mesh)
    finally:
        jshd.set_rule_overrides({})
        shd.set_rule_overrides({})


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_shard_gather_round_trip(shape):
    """Every rank's shard (``shard_tree`` at each coordinate) put back
    together is the whole tree; replicated leaves pass unchanged."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=shape)
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.standard_normal((8, 12))),
            "e": torch.from_numpy(rng.standard_normal((4, 8, 4))),
            "g": torch.from_numpy(rng.standard_normal(6)),
            "both": torch.from_numpy(rng.standard_normal((16, 3)))}
    specs = {"w": shd.Spec("fsdp", "tp"), "e": shd.Spec("tp", "fsdp", None),
             "g": shd.Spec(None), "both": shd.Spec(("data", "model"), None)}
    coords = [(i, j) for i in range(shape[0]) for j in range(shape[1])]
    shards = {c: shd.shard_tree(tree, specs, mesh, coord=c) for c in coords}
    assert shards[coords[0]]["g"] is tree["g"]
    for key, t in tree.items():
        back = torch.zeros_like(t)
        for c in coords:
            back[shd.local_slices(t.shape, specs[key], mesh, c)] = \
                shards[c][key]
        assert torch.equal(back, t), key
    assert shards[(0, 0)]["both"].shape == (16 // (shape[0] * shape[1]), 3)
    with pytest.raises(ValueError, match="equal shards"):
        shd.shard_leaf(torch.zeros(3, 4), shd.Spec("tp", None),
                       types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                             shape=(1, 2)), coord=(0, 0))


def test_params_from_numpy_takes_this_ranks_shards():
    """``interop.params_from_numpy(tree, specs=, mesh=)`` carries only the
    rank's shard of each leaf of a JAX tree (bf16 leaves included), the
    slices ``shard_tree`` takes of the whole tree."""
    from repro_torch import interop
    jcfg = jconfigs.get("qwen3-1.7b", smoke=True)
    params = jax.tree.map(np.asarray,
                          jM.init_params(jax.random.PRNGKey(1), jcfg)[0])
    specs = M.param_spec_tree(configs.get("qwen3-1.7b", smoke=True))
    whole = interop.params_from_numpy(params)
    for coord in ((0, 1), (1, 0)):
        mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                     shape=(2, 2),
                                     get_coordinate=lambda c=coord: c)
        got = interop.flatten_with_paths(
            interop.params_from_numpy(params, "cpu", specs=specs, mesh=mesh))
        want = interop.flatten_with_paths(shd.shard_tree(whole, specs, mesh))
        assert list(got) == list(want)
        for key, t in want.items():
            assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
        assert got["embed/emb"].shape == (128, 32)
