"""PyTorch port, the dense variants at their smoke configs on the CPU,
against the JAX package: gemma3-12b (5:1 windowed:global attention),
llama3-405b, nemotron-4-340b (relu^2, the ungated FFN), musicgen-large
(gelu) and llama-3.2-vision-90b (cross-attention over image
embeddings, which its prefill takes). The MoE, SSM and hybrid archs are
in ``test_torch_archs.py``.

Same params and inputs in both packages; a prefill of 2 x 16 tokens and
3 greedy decode steps in each of ``dense``, ``serve_int8`` and
``serve_packed`` against the un-jitted JAX ``model.prefill`` /
``model.decode_step`` (``_archs_parity.py``: logits within 0.2, tokens
where the margin is clear), the param and cache trees equal JAX's, and
``serve_int8`` equals ``serve_packed`` bit for bit.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import pytest

from _archs_parity import MODES, arch_case, check_int8_equals_packed, \
    check_prefill_and_decode, check_trees

ARCHS = ("gemma3-12b", "llama3-405b", "nemotron-4-340b", "musicgen-large",
         "llama-3.2-vision-90b")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return arch_case(request.param)


def test_param_and_cache_trees_match_jax(arch):
    check_trees(arch)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_jax(arch, mode):
    check_prefill_and_decode(arch, mode)


def test_serve_int8_equals_serve_packed(arch):
    check_int8_equals_packed(arch)
