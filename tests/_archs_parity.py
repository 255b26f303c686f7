"""Shared by ``test_torch_archs.py`` and ``test_torch_archs_dense.py``:
one smoke architecture's JAX params carried into the port, and its
prefill and decode steps held against the un-jitted JAX
``model.prefill`` / ``model.decode_step``.

Logits are held to ``test_torch_lm.py``'s LOGIT_ATOL = 0.2 (float32 sums
in another order than XLA's move a bf16 rounding, which the next linear
requantizes), and the greedy tokens are compared where JAX's top-2 margin
exceeds twice that.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.api import plan as jplan
from repro.configs import get as jget
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import model as JM
import repro_torch
from repro_torch import configs, interop
from repro_torch.core.policy import uniform_policy
from repro_torch.models import model as M

LOGIT_ATOL = 0.2
PROMPT, STEPS = 16, 3
MODES = ("dense", "serve_int8", "serve_packed")


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def tree_layout(tree) -> dict:
    """{path: (shape, dtype name)} of a JAX or port tree."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in interop.flatten_with_paths(tree).items()}
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in
            interop.flatten_with_paths(jax.tree.map(np.asarray, tree)).items()}


def arch_case(name: str) -> dict:
    """JAX seed-0 params of ``name``'s smoke config, the same params in
    the port, 2 x PROMPT token ids (numpy seed 1) and, for the VLM, image
    embeddings (numpy seed 3)."""
    jcfg = jget(name, smoke=True)
    params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    img = None
    if jcfg.n_img_tokens:
        img = jnp.asarray(np.random.default_rng(3).normal(
            size=(2, jcfg.n_img_tokens, jcfg.d_model)), jnp.bfloat16)
    return dict(name=name, jcfg=jcfg, cfg=configs.get(name, smoke=True),
                params=params, specs=specs, tokens=tokens, img=img,
                tparams=interop.params_from_numpy(
                    jax.tree.map(np.asarray, params)))


def check_trees(case: dict) -> None:
    """The drawn param tree and the cache tree (attention K/V, the mamba
    conv history and state, the cross layer's image K/V) have JAX's
    keys, shapes and dtypes."""
    cfg, jcfg = case["cfg"], case["jcfg"]
    assert tree_layout(M.init_params(cfg)) == tree_layout(case["params"])
    assert tree_layout(M.init_cache(cfg, 3, 40)) == \
        tree_layout(JM.init_cache(jcfg, 3, 40))


def check_prefill_and_decode(case: dict, mode: str) -> None:
    """A prefill of 2 x PROMPT tokens and STEPS greedy decode steps (fed
    JAX's tokens) in ``mode``, held against the un-jitted JAX model."""
    jcfg, tokens, img = case["jcfg"], case["tokens"], case["img"]
    jpol = juniform_policy(8, 8)
    jp = case["params"]
    if mode != "dense":
        jp, _ = JM.convert_params_for_serving(jp, case["specs"], jpol, mode)
    plan = jplan.build_plan(jcfg, jpol, mode, backend="xla")
    sess = repro_torch.compile(case["cfg"], uniform_policy(8, 8), mode=mode,
                               backend="torch_ref", params=case["tparams"],
                               device="cpu")
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(tokens),
                        JM.init_cache(jcfg, 2, 64), plan, img)
    tl, tc = sess.prefill(tokens, sess.init_cache(2, 64),
                          img_embeds=None if img is None else np.asarray(img))
    jl, tl = jl[:, 0], tl[:, 0]
    for step in range(STEPS + 1):
        want, got = f32(jl), f32(tl)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"{case['name']} step {step}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        if step == STEPS:
            break
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        jl, jc = JM.decode_step(jp, jcfg, tok, jnp.int32(PROMPT + step), jc,
                                plan)
        tl, tc = sess.decode(np.array(tok), PROMPT + step, tc)


def check_int8_equals_packed(case: dict) -> None:
    """``serve_int8`` (one exact int8 product per linear; the MoE experts'
    ``{"wq", "scale"}`` layout) and ``serve_packed`` at (8, 8), compiled
    from the same params: at Pw = 8 the packed planes hold the int8
    weights bit for bit, so a prefill of 2 x PROMPT tokens and STEPS
    greedy decode steps give equal logits (``torch.equal``) at every step
    (``chip_smoke.py``'s archs phase holds the same at published width on
    the card)."""
    cfg, img = case["cfg"], case["img"]
    img = None if img is None else np.asarray(img)
    got = {}
    for mode in ("serve_int8", "serve_packed"):
        sess = repro_torch.compile(cfg, uniform_policy(8, 8), mode=mode,
                                   params=case["tparams"], device="cpu")
        y, cache = sess.prefill(case["tokens"],
                                sess.init_cache(2, PROMPT + STEPS), img)
        got[mode] = [y[:, 0]]
        for i in range(STEPS):
            y, cache = sess.decode(torch.argmax(got[mode][-1], dim=-1),
                                   PROMPT + i, cache)
            got[mode].append(y)
    for i, (a, b) in enumerate(zip(got["serve_int8"], got["serve_packed"])):
        assert a.shape[-1] == cfg.vocab and bool(torch.isfinite(a).all())
        assert torch.equal(a, b), (
            f"{case['name']} step {i}: serve_int8 differs from serve_packed "
            f"by {(a.float() - b.float()).abs().max().item()}")
