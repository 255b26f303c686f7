"""PyTorch port, the LM slice: smoke qwen3-1.7b ``serve_packed`` prefill,
decode and generate on the CPU, against the JAX package.

Same params (JAX ``init_params`` -> numpy -> ``interop.params_from_numpy``,
bf16 leaves included) and the same token ids in both packages.

What is exact: the parameter tree, the packed weights, layer 0's q/k/v
projections (quantize, the integer core, dequantize, RMSNorm, RoPE), the
bf16 silu, and the bf16 activation scales (the ``compute_scale`` repair).

What is held by tolerance: the logits. The attention products are float32
sums taken in another order than XLA's, so an attention output sometimes
rounds to the neighbouring bf16 value; the next linear requantizes it, and
the difference spreads to most logits, by up to 0.10 on logits of
magnitude 3.3 (measured over four seeds). So prefill and decode logits,
compared in float32, are held to ``LOGIT_ATOL`` = 0.2, and greedy tokens
are compared where JAX's top-2 logit margin exceeds twice that. The
jitted-scale caveat of ROADMAP queue C applies too: the session under
``jax.jit`` may divide by qmax as a multiply by its reciprocal.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.configs import qwen3_1_7b as jqwen
from repro.core import quantize as jq
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
import repro_torch
from repro_torch import configs, interop
from repro_torch.core import quantize as q
from repro_torch.core.policy import uniform_policy
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

LOGIT_ATOL = 0.2
PROMPT = 16


@pytest.fixture(scope="module")
def case():
    jcfg = jqwen.smoke_config()
    params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jsess = loom.compile(jcfg, juniform_policy(8, 8), mode="serve_packed",
                         backend="xla", params=params, specs=specs)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params))
    tsess = repro_torch.compile(configs.get("qwen3-1.7b", smoke=True),
                                uniform_policy(8, 8), mode="serve_packed",
                                backend="torch_ref", params=tparams,
                                device="cpu")
    return dict(jcfg=jcfg, params=params, specs=specs, jsess=jsess,
                tparams=tparams, tsess=tsess, tokens=tokens)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    """A JAX array as a tensor of its dtype (bf16 through its bits)."""
    return interop.params_from_numpy(np.asarray(a))


def test_config_matches_jax():
    for smoke in (True, False):
        cfg = configs.get("qwen3-1.7b", smoke=smoke)
        jcfg = jqwen.smoke_config() if smoke else jqwen.config()
        for f in ("name", "n_layers", "d_model", "vocab", "n_heads",
                  "n_kv_heads", "d_head", "d_ff", "activation", "qk_norm",
                  "rope_theta", "ffn_gated", "max_seq", "kv_cache_bits",
                  "family"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert [(s.kind, s.ffn, s.window) for s in cfg.pattern] == \
            [(s.kind, s.ffn, s.window) for s in jcfg.pattern]


def test_params_from_numpy_carries_the_stacked_bf16_tree(case):
    flat_j = jax.tree_util.tree_flatten_with_path(case["params"])[0]
    assert flat_j
    for path, leaf in flat_j:
        node = case["tparams"]
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and leaf.dtype == jnp.bfloat16
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.view(torch.int16).numpy(),
                                      np.asarray(leaf).view(np.int16))
    wq = case["tparams"]["blocks"]["p0"]["mix"]["wq"]["w"]
    assert tuple(wq.shape) == (2, 64, 64)        # [n_groups, d, H * d_head]


def test_convert_params_matches_jax(case):
    jp, _ = JM.convert_params_for_serving(case["params"], case["specs"],
                                          juniform_policy(8, 8),
                                          "serve_packed")
    tp = M.convert_params_for_serving(case["tparams"], uniform_policy(8, 8),
                                      "serve_packed")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_packed = 0
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        got, want = node.numpy() if node.dtype != torch.bfloat16 else \
            node.view(torch.int16).numpy(), np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            want = want.view(np.int16)
        np.testing.assert_array_equal(got, want)
        n_packed += path[-1].key == "w_packed"
    assert n_packed == 7 + 1                      # 7 block linears + head
    # A tree converted by JAX loads unchanged.
    again = M.convert_params_for_serving(
        interop.params_from_numpy(jax.tree.map(np.asarray, jp)),
        uniform_policy(8, 8), "serve_packed")
    assert torch.equal(again["head"]["w_packed"], tp["head"]["w_packed"])


def test_compute_scale_bf16_matches_jax():
    x = np.random.default_rng(0).normal(size=(64, 2048)) * 3
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(xj)
    want_s = np.asarray(jq.compute_scale(xj, 8, axis=-1))
    got_s = q.compute_scale(xt, 8, axis=-1)
    assert got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.view(np.int32))
    want_q, _ = jq.quantize(xj, 8, axis=-1)
    got_q, _ = q.quantize(xt, 8, axis=-1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


def test_layer0_projections_are_bit_identical(case):
    jsess, tsess = case["jsess"], case["tsess"]
    jcfg = case["jcfg"]
    tokens = case["tokens"]
    jp = jax.tree.map(lambda a: a[0], jsess.params["blocks"]["p0"])
    tp = M._index_tree(tsess.params["blocks"]["p0"], 0)
    jx = JL.embed_apply(jsess.params["embed"], jnp.asarray(tokens))
    tx = L.embed_apply(tsess.params["embed"], torch.from_numpy(tokens).long())
    jh, th = JL.rms_norm(jx, jp["ln1"]["g"]), L.rms_norm(tx, tp["ln1"]["g"])
    np.testing.assert_array_equal(_f32(th), _f32(jh))
    pos = np.arange(PROMPT, dtype=np.int32)
    jqkv = JA._project_qkv(jp["mix"], jcfg.attn_cfg(jcfg.pattern[0]), jh, jh,
                           jnp.asarray(pos), jsess.plan)
    tcfg = tsess.cfg
    tqkv = A._project_qkv(tp["mix"], tcfg.attn_cfg(tcfg.pattern[0]), th,
                          torch.from_numpy(pos), tsess.plan)
    for j, t in zip(jqkv, tqkv):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(t), _f32(j))
    g = jnp.asarray(np.random.default_rng(2).normal(size=(64, 128)) * 4,
                    jnp.bfloat16)
    np.testing.assert_array_equal(_f32(L.activation_fn("silu")(_t(g))),
                                  _f32(jax.nn.silu(g)))


@pytest.mark.parametrize("window", [None, 8])
def test_chunked_attention_matches_jax(window):
    rng = np.random.default_rng(4)
    q_, k_, v_ = (rng.normal(size=(2, 32, 3, 16)).astype(np.float32)
                  for _ in range(3))
    want = JA.chunked_attention(jnp.asarray(q_), jnp.asarray(k_),
                                jnp.asarray(v_), window=window, bq=8, bk=8)
    got = A.chunked_attention(torch.from_numpy(q_), torch.from_numpy(k_),
                              torch.from_numpy(v_), window=window, bq=8, bk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_prefill_and_decode_logits_match_jax(case):
    jsess, tsess, tokens = case["jsess"], case["tsess"], case["tokens"]
    jl, jc = jsess.prefill(jnp.asarray(tokens))
    tl, tc = tsess.prefill(tokens)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == (2, 1, 256)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=LOGIT_ATOL)
    # The cache holds the prompt's K/V at its positions.
    c0 = M._index_tree(tc["p0"], 0)
    assert torch.equal(c0["slot_pos"][:, :PROMPT],
                       torch.arange(PROMPT, dtype=torch.int32).expand(2, -1))
    assert bool((c0["slot_pos"][:, PROMPT:] == -1).all())
    tok = np.argmax(_f32(jl)[:, 0], axis=-1).astype(np.int32)
    for step in range(2):
        jl, jc = jsess.decode(jnp.asarray(tok), PROMPT + step, jc)
        tl, tc = tsess.decode(torch.from_numpy(tok), PROMPT + step, tc)
        assert tuple(tl.shape) == (2, 256)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.argmax(_f32(jl), axis=-1).astype(np.int32)


def test_vector_positions_decode_matches_jax(case):
    """Continuous batching: each row decodes at its own position."""
    jsess, tsess, tokens = case["jsess"], case["tsess"], case["tokens"]
    _, jc = jsess.prefill(jnp.asarray(tokens))
    _, tc = tsess.prefill(tokens)
    pos = np.array([PROMPT, PROMPT + 3], np.int32)
    tok = tokens[:, 0]
    jl, _ = jsess.decode(jnp.asarray(tok), jnp.asarray(pos), jc)
    tl, tc = tsess.decode(torch.from_numpy(tok), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=LOGIT_ATOL)
    sp = M._index_tree(tc["p0"], 1)["slot_pos"]
    assert sp[0, PROMPT] == PROMPT and sp[1, PROMPT + 3] == PROMPT + 3
    assert sp[0, PROMPT + 3] == -1 and sp[1, PROMPT] == -1


def test_generate_tokens_match_jax_where_the_margin_allows(case):
    jsess, tsess, tokens = case["jsess"], case["tsess"], case["tokens"]
    want = np.asarray(jsess.generate(jnp.asarray(tokens), gen_len=8))
    got = tsess.generate(tokens, gen_len=8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    # JAX's top-2 margin at each step, along its own greedy path.
    margins = []
    jl, jc = jsess.prefill(jnp.asarray(tokens))
    logits = _f32(jl)[:, 0]
    for i in range(8):
        top2 = np.sort(logits, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        if i < 7:
            jl, jc = jsess.decode(jnp.asarray(want[:, i]), PROMPT + i, jc)
            logits = _f32(jl)
    margins = np.stack(margins, axis=1)
    for row in range(2):
        for i in range(8):
            if margins[row, i] <= 2 * LOGIT_ATOL:
                break                   # later tokens follow another path
            assert got[row, i] == want[row, i], (row, i)
    assert (margins > 2 * LOGIT_ATOL).any()


def test_dynamic_a_prefill_equals_static():
    cfg = configs.get("qwen3-1.7b", smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(3))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 8))
    out = {}
    for dyn in (False, True):
        sess = repro_torch.compile(cfg, uniform_policy(8, 8, dynamic_a=dyn),
                                   mode="serve_packed", params=params,
                                   device="cpu")
        out[dyn] = sess.prefill(tokens)[0]
    assert torch.equal(out[True], out[False])
    # The dynamic linear hands on a row-major output, as the static one
    # does: attention's products may sum in another order for another
    # layout (at full width they do).
    from repro_torch.kernels import ops
    from repro_torch.core import bitpack
    x = torch.randn((2, 8, 64), generator=torch.Generator().manual_seed(6))
    wq, ws = q.quantize(torch.randn((64, 48)), 8)
    y = ops.loom_linear_serve_dynamic(x, bitpack.pack_weights(wq, 8), ws,
                                      a_bits=8, w_bits=8)
    assert y.is_contiguous() and torch.equal(
        y, ops.loom_linear_serve(x, bitpack.pack_weights(wq, 8), ws,
                                 a_bits=8, w_bits=8))


def test_session_surface():
    cfg = configs.get("qwen3-1.7b", smoke=True)
    sess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_packed",
                               device="cpu")
    cache = sess.init_cache(3, max_seq=20)
    c = cache["p0"]
    assert tuple(c["k"].shape) == (2, 3, 20, 2, 16)
    assert c["k"].dtype == torch.bfloat16
    assert tuple(c["slot_pos"].shape) == (2, 3, 20)
    lp = sess.plan.layers[("lm_head", "linear")]
    assert lp.w_group_counts is not None and len(lp.w_group_counts) == 16
    with pytest.raises(ValueError, match="not a CNN"):
        sess.classify(np.zeros((1, 16, 16, 3), np.float32))
    cnn = repro_torch.compile(configs.get("paper_cnn", smoke=True),
                              mode="serve_packed", device="cpu")
    with pytest.raises(ValueError, match="not an LM"):
        cnn.prefill(np.zeros((1, 4), np.int64))
    import dataclasses
    c8 = M.init_cache(dataclasses.replace(cfg, kv_cache_bits=8), 3, 20)["p0"]
    assert c8["k"].dtype == c8["v"].dtype == torch.int8
    assert tuple(c8["k"].shape) == tuple(c8["v"].shape) == (2, 3, 20, 2, 16)
    for key in ("k_scale", "v_scale"):
        assert c8[key].dtype == torch.float32
        assert tuple(c8[key].shape) == (2, 3, 20, 2)
    cg = M.init_cache(dataclasses.replace(cfg, gqa_decode=True), 3, 20)["p0"]
    assert sorted(cg) == ["k", "slot_pos", "v"]
    assert cg["k"].dtype == torch.bfloat16
    assert tuple(cg["k"].shape) == (2, 3, 20, 2, 16)
    # A mamba block and an MoE FFN: params and caches in JAX's layout.
    from repro.models import moe as jmoe, ssm as jssm, transformer as JT
    from repro_torch.models import moe, ssm
    from repro_torch.models.transformer import LayerSpec
    for kind, ffn in (("mamba", "dense"), ("attn", "moe")):
        tcfg = dataclasses.replace(
            cfg, pattern=(LayerSpec(kind=kind, ffn=ffn),),
            moe=moe.MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2,
                              n_shared=1, shared_d_ff=48),
            ssm=ssm.SSMConfig(d_model=64, d_state=8, head_dim=16, chunk=8))
        jcfg = dataclasses.replace(
            jqwen.smoke_config(), pattern=(JT.LayerSpec(kind=kind, ffn=ffn),),
            moe=jmoe.MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2,
                               n_shared=1, shared_d_ff=48),
            ssm=jssm.SSMConfig(d_model=64, d_state=8, head_dim=16, chunk=8))
        jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
        for got, want in ((M.init_params(tcfg), jp),
                          (M.init_cache(tcfg, 3, 20), JM.init_cache(jcfg, 3,
                                                                    20))):
            got = interop.flatten_with_paths(got)
            want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                    interop.flatten_with_paths(jax.tree.map(np.asarray,
                                                            want)).items()}
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in got.items()} == want


@pytest.mark.parametrize("change", [dict(activation="gelu"),
                                    dict(activation="relu2"),
                                    dict(ffn_gated=False)])
def test_ffn_variants_match_jax(change):
    """gelu (the tanh form), relu^2 and the ungated FFN (``act(W_up x)``):
    the dense FFN's output equals JAX's on the same bf16 params and input
    within one bf16 ulp (2^-7 relative) in dense mode, where the bf16
    products sum in another order, and within 0.02 in serve_packed (a
    requantized product); the ungated tree has no ``w_gate``, as
    JAX's. The activations alone are held bit for bit in
    ``tests/test_torch_archs.py``."""
    import dataclasses
    from repro.models import transformer as JT
    from repro.api import plan as jplan
    from repro_torch.api import plan as tplan
    from repro_torch.models import transformer as T
    jcfg = dataclasses.replace(jqwen.smoke_config(), **change)
    jp, _ = JT.ffn_init(jax.random.PRNGKey(4), 64, 128,
                        gated=jcfg.ffn_gated)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp))
    assert ("w_gate" in tp) == jcfg.ffn_gated
    x = jnp.asarray(np.random.default_rng(5).normal(size=(2, 8, 64)),
                    jnp.bfloat16)
    for mode, atol, rtol in (("dense", 0.0, 2 ** -7),
                             ("serve_packed", 0.02, 0.0)):
        jpol = juniform_policy(8, 8)
        jpm, tpm = jp, tp
        if mode != "dense":
            jpm = {k: JL.convert_linear_for_serving(v, {"w": (None, None)},
                                                    jpol.default, mode)[0]
                   for k, v in jp.items()}
            tpm = {k: L.convert_linear_for_serving(v, uniform_policy(8, 8)
                                                   .default, mode)
                   for k, v in tp.items()}
        want = JT.ffn_apply(jpm, x, jcfg.activation,
                            jplan.build_plan(None, jpol, mode))
        got = T.ffn_apply(tpm, _t(x), jcfg.activation,
                          tplan.build_plan(None, uniform_policy(8, 8), mode,
                                           "torch_ref"))
        np.testing.assert_allclose(_f32(got), _f32(want), atol=atol,
                                   rtol=rtol)
