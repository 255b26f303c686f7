"""The train state's spec trees on a mesh equal the JAX reference's:
``opt_state_specs`` on every smoke config's param specs (the eleven, the
CNN included), and ``train_state_specs`` (the specs ``make_train_state``
returns, with and without gradient compression) against the reference's
``make_train_state`` on the ten LMs, through ``jax.eval_shape`` (nothing
allocated); and the train state's ``like`` tree has the unsharded
state's keys, shapes and dtypes."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import shapes as jshapes, train as jtrain
from repro.models import cnn as jcnn, model as jM
from repro.optim import CompressionConfig as JCompression
from repro.optim.adamw import opt_state_specs as jopt_state_specs
from repro_torch import configs, interop
from repro_torch.launch import train
from repro_torch.models import cnn, model as M
from repro_torch.optim import CompressionConfig, opt_state_specs

LMS = tuple(a for a in configs.ARCHS if a != "paper_cnn")


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", configs.ARCHS)
def test_opt_state_specs_equal_the_reference(name):
    jcfg, cfg = jconfigs.get(name, smoke=True), configs.get(name, smoke=True)
    key = jax.random.PRNGKey(0)
    if name == "paper_cnn":
        _, jspecs = jshapes._eval_shape_with_specs(
            lambda: jcnn.init_params(key, jcfg))
        specs = cnn.param_specs(cfg)
    else:
        _, jspecs = jshapes._eval_shape_with_specs(
            lambda: jM.init_params(key, jcfg))
        specs = M.param_spec_tree(cfg)
    assert _tuples(opt_state_specs(specs)) == _tuples(jopt_state_specs(
        jspecs))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name", LMS)
def test_train_state_specs_equal_the_reference(name, compress):
    jcfg, cfg = jconfigs.get(name, smoke=True), configs.get(name, smoke=True)
    jtc = jtrain.TrainConfig(compression=JCompression(enabled=compress))
    tc = train.TrainConfig(compression=CompressionConfig(enabled=compress))
    structs, jspecs = jshapes._eval_shape_with_specs(
        lambda: jtrain.make_train_state(jax.random.PRNGKey(0), jcfg, jtc))
    assert _tuples(train.train_state_specs(cfg, tc)) == _tuples(jspecs)
    like = interop.flatten_with_paths(train.train_state_like(cfg, tc))
    want = interop.flatten_with_paths(structs)
    assert sorted(like) == sorted(want)
    for k, t in like.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert interop.dtype_name(t.dtype) == str(want[k].dtype), k
    assert like["opt/step"].dtype == torch.int32
