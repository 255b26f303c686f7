"""PyTorch port, the training forward of the SSM and hybrid architectures
at their smoke configs on the CPU, against the JAX package: mamba2-370m
(the SSD scan, differentiated by autograd) and jamba-v0.1-52b (mamba and
attention layers, MoE FFNs); mamba2-370m also at 8 layers.

Same params and batch in both packages; the loss, the auxiliary loss and
every leaf's gradient held against the un-jitted JAX ``loss_fn``
(``_train_parity.py``: the loss within 1e-2 relative, each gradient within
5% of the leaf's max).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import pytest

from _train_parity import check_loss_and_grads, lm_case


# Measured: worst leaf 1.27% (mamba2), 1.44% (jamba).
@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-v0.1-52b"])
def test_loss_and_grads_match_jax(name):
    check_loss_and_grads(lm_case(name), "dense")


def test_deep_mamba2_gradients_match_jax():
    """mamba2-370m's smoke config at 8 layers, the same seed-0 weights in
    both packages with every SSM input projection (``mix/in_*``) halved.
    At the unscaled init the deep random backward is ill-conditioned:
    bf16 rounding in another order moves the gradients by more than the
    bound, and the reference's own jitted and eager gradients disagree
    there too. Halved, the gradients
    stay finite and well-posed, and the port holds every leaf within the
    same bound as at 2 layers, so the layer loop and its per-layer
    gradients (one ``unbind`` per stacked leaf) compose at depth.
    Measured: worst leaf 2.9% (``mix/in_C``)."""
    import dataclasses

    import jax
    import numpy as np

    from repro.configs import get as jget
    from repro.models import model as JM
    from repro_torch import configs, interop
    from _train_parity import lm_batch

    jcfg = dataclasses.replace(jget("mamba2-370m", smoke=True), n_layers=8)
    cfg = dataclasses.replace(configs.get("mamba2-370m", smoke=True),
                              n_layers=8)
    params, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)

    def halve(path, v):
        if "/mix/in_" in path and v.ndim >= 2:
            return (v.astype(np.float32) * 0.5).astype(v.dtype)
        return v
    host = interop.map_with_paths(halve, jax.tree.map(np.asarray, params))
    check_loss_and_grads(dict(name="mamba2-370m, 8 layers", jcfg=jcfg,
                              cfg=cfg, params=jax.tree.map(jax.numpy.asarray,
                                                           host),
                              batch=lm_batch(jcfg),
                              tparams=interop.params_from_numpy(host)),
                         "dense")


def test_ssm_chunk_rule():
    """The training scan needs S a multiple of the SSM chunk, as the
    reference asserts."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.api import plan as planlib
    from repro_torch.models import model as M
    cfg = configs.get("mamba2-370m", smoke=True)
    tokens = torch.from_numpy(np.zeros((1, cfg.ssm.chunk + 1), np.int64))
    with pytest.raises(ValueError, match="multiple of the SSM chunk"):
        M.forward_train(M.init_params(cfg), cfg, tokens,
                        planlib.build_plan(cfg))
