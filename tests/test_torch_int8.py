"""PyTorch port, the bit-parallel ``serve_int8`` route (LM_8b) and the
im2col conv route, against the JAX package on the CPU.

Same dense params (JAX init -> numpy -> both packages) and the same numpy
inputs. What is exact: ``int_conv_same`` (int32, every k, stride, fold
and ``exact_f32`` setting), the converted ``{"wq", "w_scale"}`` tree, the
CNN's logits against the UN-jitted ``cnn.forward`` (the jitted one
rewrites ``absmax / qmax``, ROADMAP queue C), the LM's layer-0
projections, and the fingerprint's digest. What is held by tolerance: the
LM's logits, by ``test_torch_lm.LOGIT_ATOL`` (attention sums in another
order than XLA's). Inside the port ``serve_int8`` equals ``serve_packed``
at Pw = 8 bit for bit: both quantize the weights to 8 bits per tensor and
the activations on the same grid, and take an exact integer product.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.configs import paper_cnn as jpaper_cnn
from repro.configs import qwen3_1_7b as jqwen
from repro.core.policy import uniform_policy as juniform_policy
from repro.kernels import ops as jops
from repro.models import attention as JA
from repro.models import cnn as jcnn
from repro.models import layers as JL
from repro.models import model as JM
import repro_torch
from repro_torch import configs, interop
from repro_torch.api import plan as planlib
from repro_torch.core.policy import uniform_policy
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import cnn
from repro_torch.models import layers as L
from repro_torch.models import model as M

LOGIT_ATOL = 0.2          # tests/test_torch_lm.py's, and why
PROMPT = 16


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# int_conv_same and the int8 product
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact_f32", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel,c", [(1, 3), (3, 3), (3, 7), (5, 4),
                                      (5, 6)])
def test_int_conv_same_matches_jax(kernel, c, stride, exact_f32):
    """C <= 4 folds the window offsets into one product, C > 4 walks them;
    ragged H and W (9 x 7)."""
    rng = np.random.default_rng(kernel * 10 + c)
    x = rng.integers(-128, 128, size=(2, 9, 7, c)).astype(np.int32)
    w = rng.integers(-128, 128, size=(kernel, kernel, c, 12)).astype(np.int32)
    want = np.asarray(jops.int_conv_same(jnp.asarray(x), jnp.asarray(w),
                                         stride, exact_f32=exact_f32))
    got = ops.int_conv_same(torch.from_numpy(x), torch.from_numpy(w), stride,
                            exact_f32=exact_f32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # Folding is a layout choice only.
    other = ops.int_conv_same(torch.from_numpy(x), torch.from_numpy(w),
                              stride, exact_f32=exact_f32,
                              fold_kk=c > ops.STEM_FOLD_MAX_C)
    assert torch.equal(other, got)


@pytest.mark.parametrize("shape", [(2, 27, 10), (1, 5, 3), (40, 64, 24),
                                   (3, 4, 16, 17)])
def test_int8_matmul_pads_for_int_mm_and_is_exact(shape):
    *lead, k, n = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(-128, 128, size=(*lead, k))
                         .astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, size=(k, n)).astype(np.int8))
    got = ops.int8_matmul(x, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (*lead, n)
    assert torch.equal(got, (x.long() @ w.long()).to(torch.int32))
    assert tuple(w.shape) == (k, n)              # the operand is not padded


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

def test_plan_routes_and_validators():
    assert planlib.MODE_ROUTES["serve_int8"] == planlib.INT8
    assert planlib.MODE_ROUTES["fake_quant"] == planlib.FAKE_QUANT
    cfg = configs.get("paper_cnn", smoke=True)
    plan = planlib.build_plan(cfg, uniform_policy(8, 8), "serve_int8",
                              conv_route="im2col")
    assert plan.conv_route == "im2col"
    for c in cfg.convs:
        assert plan.layers[(c.name, "conv")].conv_route == "im2col"
        assert plan.layers[(c.name, "linear")].route == planlib.INT8
    with pytest.raises(ValueError, match="conv_route"):
        planlib.build_plan(cfg, conv_route="winograd")
    fq = repro_torch.compile(cfg, mode="fake_quant", device="cpu")
    assert all(lp.route == planlib.FAKE_QUANT
               for lp in fq.plan.layers.values())
    with pytest.raises(ValueError, match="serving conversion"):
        L.convert_linear_for_serving({"w": torch.zeros(8, 8)}, None, "dense")


# ---------------------------------------------------------------------------
# The paper CNN
# ---------------------------------------------------------------------------

def _cnn_case(size: str, seed: int = 0):
    jcfg = jpaper_cnn.smoke_config() if size == "smoke" else \
        jpaper_cnn.config()
    params, specs = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed + 1).normal(
        size=(2, jcfg.img, jcfg.img, 3)).astype(np.float32)
    cfg = configs.get("paper_cnn", smoke=size == "smoke")
    return jcfg, cfg, params, specs, x


@pytest.mark.parametrize("conv_route", ["fused", "im2col"])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_cnn_serve_int8_matches_jax_bit_for_bit(size, conv_route):
    jcfg, cfg, params, specs, x = _cnn_case(size)
    jsess = loom.compile(jcfg, juniform_policy(8, 8), mode="serve_int8",
                         backend="xla", params=params, specs=specs,
                         conv_route=conv_route)
    want = np.asarray(jcnn.forward(jsess.params, jcfg, jnp.asarray(x),
                                   jsess.plan))
    tsess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu", conv_route=conv_route)
    got = tsess.classify(x)
    assert got.shape == (2, 10) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    for name, p in tsess.params.items():
        assert sorted(p) == ["w_scale", "wq"] and p["wq"].dtype == torch.int8
        np.testing.assert_array_equal(p["wq"].numpy(),
                                      np.asarray(jsess.params[name]["wq"]))
        np.testing.assert_array_equal(p["w_scale"].numpy(),
                                      np.asarray(jsess.params[name]["w_scale"]))
    # A tree converted by JAX serves unchanged.
    again = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                                params=jax.tree.map(np.asarray, jsess.params),
                                device="cpu", conv_route=conv_route)
    np.testing.assert_array_equal(again.classify(x).numpy(), want)


@pytest.mark.parametrize("mode", ["serve_int8", "serve_packed"])
def test_cnn_fused_equals_im2col(mode):
    _, cfg, params, _, x = _cnn_case("full", seed=3)
    params = jax.tree.map(np.asarray, params)
    out = [repro_torch.compile(cfg, uniform_policy(8, 8), mode=mode,
                               params=params, device="cpu",
                               conv_route=route).classify(x)
           for route in ("fused", "im2col")]
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("a_bits", [6, 8, 16])
def test_cnn_serve_int8_equals_serve_packed_at_pw8(a_bits):
    _, cfg, params, _, x = _cnn_case("full", seed=a_bits)
    params = jax.tree.map(np.asarray, params)
    out = {mode: repro_torch.compile(cfg, uniform_policy(a_bits, 8),
                                     mode=mode, params=params,
                                     device="cpu").classify(x)
           for mode in ("serve_int8", "serve_packed")}
    assert torch.equal(out["serve_int8"], out["serve_packed"])


def test_cnn_int8_conv_routes_through_int_conv_same(monkeypatch):
    """The int8 conv takes the float32 shift-and-matmul passes wherever
    conv_accum_fits_f32 holds (all three paper convs at (8, 8)), never a
    library convolution."""
    seen = []
    real = ops.int_conv_same

    def spy(x, w4, stride, exact_f32=False, fold_kk=None):
        seen.append((tuple(w4.shape), exact_f32))
        return real(x, w4, stride, exact_f32, fold_kk)
    monkeypatch.setattr(ops, "int_conv_same", spy)
    monkeypatch.setattr(torch.nn.functional, "conv2d", None)
    _, cfg, params, _, x = _cnn_case("full")
    repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                        params=jax.tree.map(np.asarray, params),
                        device="cpu").classify(x)
    assert seen == [((3, 3, 3, 32), True), ((3, 3, 32, 64), True),
                    ((3, 3, 64, 128), True)]


# ---------------------------------------------------------------------------
# The smoke LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm():
    jcfg = jqwen.smoke_config()
    params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jsess = loom.compile(jcfg, juniform_policy(8, 8), mode="serve_int8",
                         backend="xla", params=params, specs=specs)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, size=(2, PROMPT)).astype(np.int32)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params))
    cfg = configs.get("qwen3-1.7b", smoke=True)
    tsess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                                params=tparams, device="cpu")
    return dict(jcfg=jcfg, params=params, specs=specs, jsess=jsess,
                tparams=tparams, tsess=tsess, tokens=tokens, cfg=cfg)


def test_lm_converted_tree_equals_jax(lm):
    flat_j = jax.tree_util.tree_flatten_with_path(lm["jsess"].params)[0]
    flat_t = interop.flatten_with_paths(lm["tsess"].params)
    assert len(flat_t) == len(flat_j)
    n_int8 = 0
    for path, leaf in flat_j:
        node = flat_t["/".join(k.key for k in path)]
        want = np.asarray(leaf)
        got = interop.host_array(node)
        assert got.dtype == want.dtype or want.dtype.name == "bfloat16"
        np.testing.assert_array_equal(
            got.view(np.int16) if want.dtype.name == "bfloat16" else got,
            want.view(np.int16) if want.dtype.name == "bfloat16" else want)
        n_int8 += path[-1].key == "wq" and want.dtype == np.int8
    assert n_int8 == 7 + 1                        # 7 block linears + head


def test_lm_layer0_projections_are_bit_identical(lm):
    jsess, tsess, tokens = lm["jsess"], lm["tsess"], lm["tokens"]
    jcfg, tcfg = lm["jcfg"], tsess.cfg
    jp = jax.tree.map(lambda a: a[0], jsess.params["blocks"]["p0"])
    tp = M._index_tree(tsess.params["blocks"]["p0"], 0)
    jh = JL.rms_norm(JL.embed_apply(jsess.params["embed"],
                                    jnp.asarray(tokens)), jp["ln1"]["g"])
    th = L.rms_norm(L.embed_apply(tsess.params["embed"],
                                  torch.from_numpy(tokens).long()),
                    tp["ln1"]["g"])
    pos = np.arange(PROMPT, dtype=np.int32)
    jqkv = JA._project_qkv(jp["mix"], jcfg.attn_cfg(jcfg.pattern[0]), jh, jh,
                           jnp.asarray(pos), jsess.plan)
    tqkv = A._project_qkv(tp["mix"], tcfg.attn_cfg(tcfg.pattern[0]), th,
                          torch.from_numpy(pos), tsess.plan)
    for j, t in zip(jqkv, tqkv):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(t), _f32(j))


def test_lm_serve_int8_logits_match_jax(lm):
    jsess, tsess, tokens = lm["jsess"], lm["tsess"], lm["tokens"]
    jl, jc = jsess.prefill(jnp.asarray(tokens))
    tl, tc = tsess.prefill(tokens)
    assert tl.dtype == torch.bfloat16 and tuple(tl.shape) == (2, 1, 256)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=LOGIT_ATOL)
    tok = np.argmax(_f32(jl)[:, 0], axis=-1).astype(np.int32)
    for step in range(3):
        jl, jc = jsess.decode(jnp.asarray(tok), PROMPT + step, jc)
        tl, tc = tsess.decode(torch.from_numpy(tok), PROMPT + step, tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        tok = np.argmax(_f32(jl), axis=-1).astype(np.int32)


def test_lm_serve_int8_equals_serve_packed_every_step(lm):
    packed = repro_torch.compile(lm["cfg"], uniform_policy(8, 8),
                                 mode="serve_packed", params=lm["tparams"],
                                 device="cpu")
    sessions = (lm["tsess"], packed)
    caches = [s.init_cache(2, PROMPT + 6) for s in sessions]
    out = [s.prefill(lm["tokens"], c) for s, c in zip(sessions, caches)]
    assert torch.equal(out[0][0], out[1][0])
    tok = torch.argmax(out[0][0][:, 0], dim=-1)
    for step in range(5):
        out = [s.decode(tok, PROMPT + step, c)
               for s, c in zip(sessions, caches)]
        assert torch.equal(out[0][0], out[1][0]), step
        tok = torch.argmax(out[0][0], dim=-1)


def test_lm_serve_int8_fingerprint_digest_equals_jax(lm):
    jf, tf = lm["jsess"].fingerprint, lm["tsess"].fingerprint
    assert tf is not None and jf is not None
    assert tf.leaves == jf.leaves and tf.group_counts == jf.group_counts == {}
    assert tf.digest() == jf.digest()
    from repro.core import integrity as jintegrity
    from repro_torch.core import integrity
    _, jleaf = jintegrity.flip_one_bit(lm["jsess"].params)
    _, leaf = integrity.flip_one_bit(lm["tsess"].params)
    assert leaf == jleaf
    assert lm["tsess"].verify_integrity("serve_int8") == len(tf.leaves)


def test_cnn_serve_int8_fingerprint_digest_equals_jax():
    jcfg, cfg, params, specs, _ = _cnn_case("smoke")
    jsess = loom.compile(jcfg, juniform_policy(8, 8), mode="serve_int8",
                         backend="xla", params=params, specs=specs)
    tsess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu")
    assert tsess.fingerprint.digest() == jsess.fingerprint.digest()


def test_engine_reload_converts_with_the_sessions_mode(lm):
    """A hot reload of a dense tree on a serve_int8 engine converts it to
    int8 (the session's mode): the tokens streamed after the swap equal a
    fresh session's on the new weights."""
    from repro_torch.runtime.batching import BatchingEngine
    cfg = lm["cfg"]
    sess = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                               params=lm["tparams"], device="cpu")
    new = M.init_params(cfg, torch.Generator().manual_seed(1))
    eng = BatchingEngine(sess, max_batch=2, max_seq=32)
    prompt = lm["tokens"][0, :6]
    h = eng.submit(prompt, 4)
    eng.step()
    pre = len(h.tokens_so_far())
    assert 0 < pre < 4
    eng.reload(new)
    while eng.step():
        pass
    assert sess.params["head"]["wq"].dtype == torch.int8
    fresh = repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_int8",
                                params=new, device="cpu")
    want = fresh.generate(prompt[None], 4, max_seq=32)[0]
    np.testing.assert_array_equal(h.result(timeout=30.0)[pre:], want[pre:])
    sess.verify_integrity("after reload")
