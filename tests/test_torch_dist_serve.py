"""Meshed serving of the port on the CPU: gloo ranks, one spawn per mesh
(all three at once) running every check of it (``tests/_dist_ranks.py``),
each held against the unsharded port session.

On ``serve_packed`` (K1's route), ``serve_int8`` and ``dynamic_a`` (K3's)
every rank's prefill and decode logits are ``torch.equal`` to the
unsharded session's rows, at (1, 2), (2, 1) and (2, 2); so are the
expert-parallel MoE (deepseek) and the SSM's row-parallel ``in_B`` /
``in_C`` / ``in_dt`` (jamba). ``dense`` and mixtral's d_ff-split experts
sum float partial products over "model", and are held within
``_dist_ranks.DENSE_ATOL``; each prints its largest difference and its
largest logit (``pytest -s``). Checkpoints: a restore with ``shardings=`` is
the slices of the unsharded restore; a save from (2, 2) writes the
unsharded save's bytes.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import pytest

import _dist_ranks as R

MESHES = {
    (1, 2): ("qwen_packed", "qwen_int8", "qwen_dynamic", "qwen_dense",
             "deepseek_ep", "jamba", "mixtral_dff", "ckpt_restore"),
    (2, 1): ("qwen_packed", "qwen_int8", "qwen_dynamic", "qwen_dense",
             "mixtral_dff"),
    (2, 2): ("qwen_packed", "qwen_int8", "qwen_dynamic", "qwen_dense",
             "mixtral_dff", "deepseek_ep", "deepseek_int8", "ckpt_save"),
}
CASES = [(shape, check) for shape, checks in MESHES.items()
         for check in checks]


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """Every mesh's ranks, started together, then collected."""
    started = {shape: R.start(shape, checks, str(tmp_path_factory.mktemp(
        f"mesh{shape[0]}x{shape[1]}"))) for shape, checks in MESHES.items()}
    return {shape: R.collect(s) for shape, s in started.items()}


@pytest.mark.parametrize("shape,check", CASES,
                         ids=[f"{s[0]}x{s[1]}-{c}" for s, c in CASES])
def test_meshed_serving_matches_unsharded(mesh_results, shape, check):
    results, errs = mesh_results[shape]
    got = results[check]
    assert len(got) == shape[0] * shape[1]
    assert got == ["ok"] * len(got), "\n".join(r for r in got if r != "ok")
    if check in errs:
        err, top = errs[check]
        print(f"mesh {shape} {check}: max_abs_err {err!r} (limit "
              f"{R.DENSE_ATOL}), max |logit| {top!r}")
