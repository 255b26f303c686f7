"""PyTorch port, the training forward of the dense variants at their
smoke configs on the CPU, against the JAX package: gemma3-12b (5:1
windowed:global attention), llama3-405b, nemotron-4-340b (relu^2, the
ungated FFN), musicgen-large (gelu) and llama-3.2-vision-90b
(cross-attention over the batch's image embeddings).

Same params and batch in both packages; the loss and every leaf's
gradient held against the un-jitted JAX ``loss_fn`` (``_train_parity.py``:
the loss within 1e-2 relative, each gradient within 5% of the leaf's
max).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import pytest

from _train_parity import check_loss_and_grads, lm_case


# Measured: worst leaf 1.05% (gemma3), 1.39% (llama3), 1.05% (nemotron),
# 1.27% (musicgen), 1.12% (llama-3.2-vision).
@pytest.mark.parametrize("name", ["gemma3-12b", "llama3-405b",
                                  "nemotron-4-340b", "musicgen-large",
                                  "llama-3.2-vision-90b"])
def test_loss_and_grads_match_jax(name):
    check_loss_and_grads(lm_case(name), "dense")
