"""PyTorch port, the training forward of the MoE architectures at their
smoke configs on the CPU, against the JAX package: deepseek-moe-16b
(shared experts; also in ``fake_quant``, whose MoE fake-quantizes the
dispatched tokens and the experts' hidden activations) and mixtral-8x7b.

Same params and batch in both packages; the loss, the router's auxiliary
loss and every leaf's gradient held against the un-jitted JAX ``loss_fn``
(``_train_parity.py``: the loss within 1e-2 relative, each gradient within
5% of the leaf's max).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import functools

import pytest

from _train_parity import check_loss_and_grads, lm_case

case = functools.cache(lm_case)


# Measured: worst leaf 1.15% (deepseek dense), 1.23% (mixtral dense).
@pytest.mark.parametrize("name,mode", [("deepseek-moe-16b", "dense"),
                                       ("deepseek-moe-16b", "fake_quant"),
                                       ("mixtral-8x7b", "dense")])
def test_loss_and_grads_match_jax(name, mode):
    check_loss_and_grads(case(name), mode)
