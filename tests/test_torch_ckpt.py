"""PyTorch port, checkpoints in the JAX package's on-disk format
(``repro_torch.ckpt.checkpoint`` against ``repro.ckpt.checkpoint``).

Both ways, byte for byte: a directory the reference writes restores in the
port to tensors ``torch.equal`` to ``interop.params_from_numpy`` of the
same arrays, a directory the port writes restores in the reference to
equal arrays, and the two directories for one tree hold the same files
and the same manifest -- for the dense paper CNN (float32), the smoke LM
(stacked bf16 leaves) and ``compress="bf16"``. Plus the reference's own
checkpoint tests mirrored on the port (``tests/test_faults.py``: corrupt
leaf falls back, all-corrupt is loud, a crash before the rename never
shadows, an async failure surfaces on ``wait``, the manifest's CRC and
bf16 round trip; ``tests/test_audit.py``: ``verify=`` read-back).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import json
import os
import warnings

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.configs import paper_cnn as jpaper_cnn
from repro.configs import qwen3_1_7b as jqwen
from repro.models import cnn as jcnn
from repro.models import model as JM
from repro_torch import configs, interop
from repro_torch.ckpt import checkpoint as ck
from repro_torch.models import model as M
from repro_torch.runtime import faults

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    """The port's fault registry starts clean, and a test that leaks an
    armed fault fails by name."""
    faults.reset()
    yield
    leaked = faults.active_points()
    faults.reset()
    assert not leaked, f"fault(s) still armed at teardown: {leaked}"


def _jax_tree(name: str) -> dict:
    """A dense JAX tree as numpy arrays (seed 1): the paper CNN's float32
    params or the smoke LM's stacked bf16 ones."""
    if name == "cnn":
        params, _ = jcnn.init_params(jax.random.PRNGKey(1),
                                     jpaper_cnn.smoke_config())
    else:
        params, _ = JM.init_params(jax.random.PRNGKey(1), jqwen.smoke_config())
    return jax.tree.map(np.asarray, params)


CASES = [("cnn", "none"), ("lm", "none"), ("cnn", "bf16")]


def _expect(tree: dict, compress: str) -> dict:
    """What a restore must give: the tree as tensors, float32 leaves
    through bf16 when compressed."""
    out = interop.params_from_numpy(tree)
    if compress == "bf16":
        out = interop.map_with_paths(
            lambda _, t: t.to(torch.bfloat16).to(torch.float32)
            if t.dtype == torch.float32 else t, out)
    return out


def _assert_trees_equal(got: dict, want: dict) -> None:
    g, w = interop.flatten_with_paths(got), interop.flatten_with_paths(want)
    assert list(g) == list(w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        assert torch.equal(g[key], w[key]), key


@pytest.mark.parametrize("name,compress", CASES)
def test_reference_checkpoint_restores_in_the_port(tmp_path, name, compress):
    tree = _jax_tree(name)
    jck.save_checkpoint(str(tmp_path), 3, tree, compress=compress)
    like = interop.params_from_numpy(tree)
    got, step = ck.restore_checkpoint(str(tmp_path), 3, like)
    assert step == 3
    _assert_trees_equal(got, _expect(tree, compress))


@pytest.mark.parametrize("name,compress", CASES)
def test_port_checkpoint_restores_in_the_reference(tmp_path, name, compress):
    tree = _jax_tree(name)
    ck.save_checkpoint(str(tmp_path), 4, interop.params_from_numpy(tree),
                       compress=compress, verify=True)
    got, step = jck.restore_checkpoint(str(tmp_path), 4, tree)
    assert step == 4
    want = tree if compress == "none" else jax.tree.map(
        lambda a: a.astype(ml_dtypes.bfloat16).astype(np.float32)
        if a.dtype == np.float32 else a, tree)
    flat_g = interop.flatten_with_paths(jax.tree.map(np.asarray, got))
    flat_w = interop.flatten_with_paths(want)
    assert list(flat_g) == list(flat_w)
    for key, w in flat_w.items():
        assert flat_g[key].dtype == w.dtype, key
        assert np.array_equal(flat_g[key].view(np.uint8),
                              w.view(np.uint8)), key


@pytest.mark.parametrize("name,compress", CASES)
def test_both_packages_write_the_same_files(tmp_path, name, compress):
    tree = _jax_tree(name)
    meta = {"note": "x"}
    a = jck.save_checkpoint(str(tmp_path / "jax"), 7, tree, compress=compress,
                            extra_meta=meta)
    b = ck.save_checkpoint(str(tmp_path / "port"), 7,
                           interop.params_from_numpy(tree),
                           compress=compress, extra_meta=meta)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, "manifest.json")) as fa, \
            open(os.path.join(b, "manifest.json")) as fb:
        ma, mb = json.load(fa), json.load(fb)
    assert list(ma["leaves"]) == list(mb["leaves"])
    for key in ma["leaves"]:
        assert ma["leaves"][key] == mb["leaves"][key], key
    assert ma == mb
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, \
                open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f


def test_bf16_manifest_names_the_reference_storage(tmp_path):
    path = ck.save_checkpoint(str(tmp_path), 0, {
        "h": torch.tensor([1.0, -2.5, 3.140625], dtype=torch.bfloat16)})
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["leaves"]["h"]
    assert (meta["dtype"], meta["stored"]) == ("bfloat16", "bfloat16")
    assert np.load(os.path.join(path, "h.npy")).dtype == np.uint16


@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float8_e5m2"])
def test_float8_leaves_cross_both_ways(tmp_path, fmt):
    vals = np.array([0.0, 0.5, -1.75, 3.0, 448.0 if fmt.endswith("fn")
                     else 57344.0], np.float32)
    arr = vals.astype(getattr(ml_dtypes, fmt))
    jck.save_checkpoint(str(tmp_path / "jax"), 0, {"x": arr})
    got, _ = ck.restore_checkpoint(str(tmp_path / "jax"), 0, {
        "x": torch.empty(5, dtype=getattr(torch, fmt), device="meta")},
        device="cpu")
    assert got["x"].dtype == getattr(torch, fmt)
    assert np.array_equal(got["x"].view(torch.uint8).numpy(),
                          arr.view(np.uint8))
    ck.save_checkpoint(str(tmp_path / "port"), 0, got)
    back, _ = jck.restore_checkpoint(str(tmp_path / "port"), 0, {"x": arr})
    assert np.array_equal(np.asarray(back["x"]).view(np.uint8),
                          arr.view(np.uint8))


def test_restore_onto_a_meta_skeleton_and_a_device(tmp_path):
    """``model.param_skeleton`` (meta tensors, nothing drawn) is a full
    ``like`` tree: the restore puts the checkpoint's values on the
    requested device with the skeleton's dtypes."""
    cfg = configs.get("qwen3-1.7b", smoke=True)
    dense = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    skel = M.param_skeleton(cfg)
    flat_s, flat_d = (interop.flatten_with_paths(t) for t in (skel, dense))
    assert list(flat_s) == list(flat_d)
    for key, t in flat_d.items():
        assert flat_s[key].device.type == "meta"
        assert (flat_s[key].shape, flat_s[key].dtype) == (t.shape, t.dtype)
    ck.save_checkpoint(str(tmp_path), 0, dense)
    got, _ = ck.restore_checkpoint(str(tmp_path), 0, skel, device="cpu")
    _assert_trees_equal(got, dense)


def test_restore_rejects_other_shapes_and_missing_leaves(tmp_path):
    ck.save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_checkpoint(str(tmp_path), 0, {"w": torch.zeros(4, 5)})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore_checkpoint(str(tmp_path), 0, {"v": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="compress"):
        ck.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)},
                           compress="int8")


# -- the reference's checkpoint tests, on the port ----------------------------


def _tree(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32)),
            "b": torch.arange(4, dtype=torch.float32)}


def test_ckpt_leaf_corrupt_falls_back_to_previous_good(tmp_path):
    d = str(tmp_path)
    good = _tree(1)
    ck.save_checkpoint(d, 1, good)
    with faults.inject("ckpt.leaf_corrupt"):
        ck.save_checkpoint(d, 2, _tree(2))
    with pytest.raises(ck.CheckpointCorruptError):
        ck.restore_checkpoint(d, 2, _tree(0))
    with pytest.warns(RuntimeWarning, match="corrupt"):
        state, step = ck.restore_latest(d, _tree(0))
    assert step == 1
    _assert_trees_equal(state, good)


def test_ckpt_all_corrupt_fails_loudly(tmp_path):
    d = str(tmp_path)
    with faults.inject("ckpt.leaf_corrupt"):
        ck.save_checkpoint(d, 1, _tree(1))
    with pytest.warns(RuntimeWarning):
        with pytest.raises(ck.CheckpointCorruptError):
            ck.restore_latest(d, _tree(0))
    assert ck.restore_latest(str(tmp_path / "empty"), _tree(0)) == (None,
                                                                    None)


def test_ckpt_port_corruption_is_caught_by_the_reference(tmp_path):
    """The port's leaf_corrupt site flips a byte after the CRC was taken;
    the reference's restore rejects the step too, and falls back."""
    d = str(tmp_path)
    ck.save_checkpoint(d, 1, _tree(1))
    with faults.inject("ckpt.leaf_corrupt"):
        ck.save_checkpoint(d, 2, _tree(2))
    like = {k: v.numpy() for k, v in _tree(0).items()}
    with pytest.warns(RuntimeWarning, match="corrupt"):
        state, step = jck.restore_latest(d, like)
    assert step == 1
    assert np.array_equal(np.asarray(state["w"]), _tree(1)["w"].numpy())


def test_ckpt_crash_before_rename_never_shadows_previous(tmp_path):
    d = str(tmp_path)
    good = _tree(1)
    ck.save_checkpoint(d, 1, good)
    with faults.inject("ckpt.crash_rename",
                       exc=RuntimeError("simulated crash")):
        with pytest.raises(RuntimeError, match="simulated crash"):
            ck.save_checkpoint(d, 2, _tree(2))
    assert ck.latest_step(d) == 1         # torn save is invisible
    state, step = ck.restore_latest(d, _tree(0))
    assert step == 1
    _assert_trees_equal(state, good)
    ck.save_checkpoint(d, 2, _tree(2))    # clean retry reuses the tmp dir
    assert ck.latest_step(d) == 2


def test_ckpt_async_save_exception_surfaces_on_wait(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=1, keep_n=2)
    with faults.inject("ckpt.crash_rename", exc=RuntimeError("disk died"),
                       times=None):
        mgr.save_async(1, _tree(1))
        with pytest.raises(RuntimeError, match="disk died"):
            mgr.wait()
    mgr.save_async(2, _tree(2))           # manager still usable after
    mgr.wait()
    assert ck.latest_step(str(tmp_path)) == 2


def test_ckpt_manager_prunes_to_keep_n_and_snapshots(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), every=2, keep_n=2)
    assert [mgr.should_save(s) for s in range(5)] == [False, False, True,
                                                      False, True]
    state = _tree(0)
    for step in range(1, 5):
        mgr.save_async(step, state)
        state["b"] += 1                   # the save holds its own snapshot
    mgr.wait()
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000003",
                                                 "step_00000004"]
    restored, step = mgr.restore_latest(_tree(0))
    assert step == 4
    assert torch.equal(restored["b"], torch.arange(4.0) + 3)


def test_ckpt_manifest_has_crc_and_bf16_roundtrips(tmp_path):
    d = str(tmp_path)
    tree = _tree(3)
    path = ck.save_checkpoint(d, 5, tree, compress="bf16")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert all("crc32" in meta for meta in manifest["leaves"].values())
    state, step = ck.restore_latest(d, tree)
    assert step == 5
    for k in tree:
        expect = tree[k].numpy().astype(ml_dtypes.bfloat16).astype(np.float32)
        assert np.array_equal(state[k].numpy(), expect), k


def test_ckpt_save_verify_catches_silent_leaf_corruption(tmp_path):
    state = {"w": torch.arange(16, dtype=torch.float32)}
    ck.save_checkpoint(str(tmp_path / "a"), 0, state, verify=True)
    # a corrupted leaf (flipped AFTER its CRC was recorded) is caught at
    # SAVE time instead of at first restore
    with faults.inject("ckpt.leaf_corrupt", times=1):
        with pytest.raises(ck.CheckpointCorruptError) as ei:
            ck.save_checkpoint(str(tmp_path / "b"), 0, state, verify=True)
    assert "save verify" in str(ei.value)
    # without verify, the same corruption slips through the save and
    # surfaces only at restore: every step corrupt -> loud typed failure
    with faults.inject("ckpt.leaf_corrupt", times=1):
        ck.save_checkpoint(str(tmp_path / "c"), 0, state)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ck.CheckpointCorruptError):
            ck.restore_latest(str(tmp_path / "c"), state)


def test_ckpt_crash_rename_still_loud_with_verify(tmp_path):
    state = {"w": torch.arange(8, dtype=torch.float32)}
    with faults.inject("ckpt.crash_rename",
                       exc=RuntimeError("simulated crash"), times=1):
        with pytest.raises(RuntimeError, match="simulated crash"):
            ck.save_checkpoint(str(tmp_path), 0, state, verify=True)
    assert ck.restore_latest(str(tmp_path), state)[0] is None  # no torn dir


def test_ckpt_manager_verify_passthrough(tmp_path):
    mgr = ck.CheckpointManager(str(tmp_path), keep_n=2, verify=True)
    assert mgr.verify is True
    state = {"w": torch.arange(8, dtype=torch.float32)}
    mgr.save_async(0, state)
    mgr.wait()
    restored, step = ck.restore_latest(str(tmp_path), state)
    assert step == 0 and torch.equal(restored["w"], state["w"])


def test_restore_defaults_to_the_device_of_like(tmp_path):
    """With no ``device``, a restore lands where ``like``'s tensors are;
    a ``like`` of meta tensors or numpy arrays names no device, and the
    default is then the card, as the reference restores onto its default
    device (so on the CPU such a restore passes ``device="cpu"``)."""
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    ck.save_checkpoint(str(tmp_path), 0, tree)
    got, _ = ck.restore_checkpoint(str(tmp_path), 0, tree)
    assert all(t.device == torch.device("cpu")
               for t in interop.flatten_with_paths(got).values())
    _assert_trees_equal(got, tree)
    meta = interop.map_with_paths(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    assert ck._default_device(meta) == torch.device("cuda")
    assert ck._default_device({"a": np.zeros(2)}) == torch.device("cuda")
    assert ck._default_device({"m": meta["a"], "t": tree["a"]}) == \
        torch.device("cpu")
    got, _ = ck.restore_latest(str(tmp_path), meta, device="cpu")
    _assert_trees_equal(got, tree)
