"""PyTorch port, the int8 KV cache (``kv_cache_bits=8``) and the grouped
decode routes (``gqa_decode``, ``attn_int8``), against the JAX package's
``models/attention.py`` on the CPU, and batch-invariant inside the port.

Same numpy inputs in both packages (bf16 through its bits). Exact:
``_quant_kv`` (values and scales, rounding ties included), every cache
leaf after a prefill and per-row decode writes, and ``attn_int8``'s two
integer products (QK and PV, int32) against ``jax.lax.dot_general`` on the
same operands. Within a tolerance: ``decode_attend``'s outputs, one bf16
ulp (``rtol`` 2^-7, ``atol`` 1e-6), far inside the reference's own bf16
tolerance of 2e-2 (``tests/test_perf_opts.py``): the float32 sums run in
another order than XLA's, so an output may round to the neighbouring bf16
value (measured here: equal on every route but ``int8_gqa``, 4.8e-7 off
on an output near 1e-4). The LM's logits are held to
``test_torch_lm.LOGIT_ATOL``. Inside the port the one float body (the
queries grouped, with or without ``gqa_decode``) equals the reference's
repeat route, written out here, bit for bit (the same products summed
over the same contiguous dim), and every route gives a batched row the
bits of the same row decoded alone.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.configs import qwen3_1_7b as jqwen
from repro.core.policy import uniform_policy as juniform_policy
from repro.models import attention as JA
from repro.models import model as JM
import repro_torch
from repro_torch import configs, interop
from repro_torch.core.policy import uniform_policy
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.runtime import faults
from repro_torch.runtime.batching import BatchingEngine, KVPool
from repro_torch.runtime.serving import ServingSupervisor
from repro_torch.runtime.supervisor import TransientWorkerError

LOGIT_ATOL = 0.2          # tests/test_torch_lm.py's, and why
DECODE_TOL = dict(rtol=2 ** -7, atol=1e-6)
PROMPT = 16

# The four route settings on top of the bf16 cache's defaults. In the
# port ``gqa_decode`` selects no route: its settings run the same float
# body as those without it.
ROUTES = {"gqa": dict(gqa_decode=True),
          "int8": dict(kv_cache_bits=8),
          "int8_gqa": dict(kv_cache_bits=8, gqa_decode=True),
          "int8_attn": dict(kv_cache_bits=8, attn_int8=True)}


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    faults.reset()
    yield
    leaked = faults.active_points()
    faults.reset()
    assert not leaked, f"fault(s) still armed at teardown: {leaked}"


def _np(a) -> np.ndarray:
    """Either package's array as numpy, bf16 as its raw bits."""
    if isinstance(a, torch.Tensor):
        return interop.host_array(a)
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bf16(x: np.ndarray):
    """The same bf16 values in both packages."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, interop.params_from_numpy(np.asarray(j))


def _cfgs(**change):
    base = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16)
    return (JA.AttnConfig(**base, **change), A.AttnConfig(**base, **change))


def _assert_caches_equal(jc: dict, tc: dict):
    assert sorted(jc) == sorted(tc)
    for key in jc:
        assert tc[key].dtype == {"bfloat16": torch.bfloat16,
                                 "int8": torch.int8, "float32": torch.float32,
                                 "int32": torch.int32}[jc[key].dtype.name]
        np.testing.assert_array_equal(_np(tc[key]), _np(jc[key]),
                                      err_msg=key)


# ---------------------------------------------------------------------------
# The int8 cache's writes
# ---------------------------------------------------------------------------

def test_quant_kv_matches_jax_with_rounding_ties():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 16)) * rng.uniform(0.01, 8, (3, 5, 4, 1))
    # Row [0, 0, h]: absmax 127 -> scale 1, and values on .5 boundaries
    # (ties round to even); row [0, 1, 0]: all zero (the scale's floor).
    x[0, 0, :, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[0, 0, :, 8:] = 0
    x[0, 1, 0] = 0
    xj, xt = _bf16(x)
    kj, sj = JA._quant_kv(xj)
    kt, st = A._quant_kv(xt)
    assert kt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert kt[0, 0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    assert float(st[0, 1, 0]) == np.float32(1e-20)


@pytest.mark.parametrize("bits", [16, 8])
def test_prefill_and_per_row_updates_write_the_references_cache(bits):
    """Layer 0 of the smoke LM: apply_prefill of a 16-token prompt, then 5
    per-row cache_updates (rows at different positions); every leaf
    equals JAX's after each write."""
    jcfg = dataclasses.replace(jqwen.smoke_config(), kv_cache_bits=bits)
    params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jsess = loom.compile(jcfg, juniform_policy(8, 8), mode="serve_packed",
                         backend="xla", params=params, specs=specs)
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True),
                              kv_cache_bits=bits)
    tsess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu")
    jac, tac = jcfg.attn_cfg(jcfg.pattern[0]), cfg.attn_cfg(cfg.pattern[0])
    jp = jax.tree.map(lambda a: a[0], jsess.params["blocks"]["p0"]["mix"])
    tp = M._index_tree(tsess.params["blocks"]["p0"]["mix"], 0)
    rng = np.random.default_rng(1)
    xj, xt = _bf16(rng.normal(size=(2, PROMPT, 64)))
    pos = np.arange(PROMPT, dtype=np.int32)
    jc = JA.init_cache(jac, 2, 32)
    tc = A.init_cache(tac, 2, 32)
    _assert_caches_equal(jc, tc)
    _, jc = JA.apply_prefill(jp, jac, xj, jnp.asarray(pos), jsess.plan, jc)
    _, tc = A.apply_prefill(tp, tac, xt, torch.from_numpy(pos), tsess.plan,
                            tc)
    _assert_caches_equal(jc, tc)
    for i in range(5):
        kj, kt = _bf16(rng.normal(size=(2, 1, 2, 16)) * 3)
        vj, vt = _bf16(rng.normal(size=(2, 1, 2, 16)))
        rows = np.array([PROMPT + i, PROMPT + 2 * i + 3], np.int32)
        jc = JA.cache_update(jc, jac, kj, vj, jnp.asarray(rows))
        tc = A.cache_update(tc, tac, kt, vt, torch.from_numpy(rows))
        _assert_caches_equal(jc, tc)
    # A scalar position writes the whole batch at one slot.
    jc = JA.cache_update(jc, jac, kj, vj, 30)
    tc = A.cache_update(tc, tac, kt, vt, 30)
    _assert_caches_equal(jc, tc)


# ---------------------------------------------------------------------------
# decode_attend, per route
# ---------------------------------------------------------------------------

def _filled_caches(jac, tac, batch=3, s_cache=40, seed=3):
    """Equal caches in both packages: a few whole-batch writes, then
    per-row ones, leaving each row at its own position."""
    rng = np.random.default_rng(seed)
    jc, tc = JA.init_cache(jac, batch, s_cache), A.init_cache(tac, batch,
                                                             s_cache)
    for t in range(12):
        kj, kt = _bf16(rng.normal(size=(batch, 1, 2, 16)) * 2)
        vj, vt = _bf16(rng.normal(size=(batch, 1, 2, 16)))
        jc = JA.cache_update(jc, jac, kj, vj, t)
        tc = A.cache_update(tc, tac, kt, vt, t)
    pos = np.arange(12, 12 + batch, dtype=np.int32)
    for t in range(14):
        kj, kt = _bf16(rng.normal(size=(batch, 1, 2, 16)) * 2)
        vj, vt = _bf16(rng.normal(size=(batch, 1, 2, 16)))
        rows = pos + t
        jc = JA.cache_update(jc, jac, kj, vj, jnp.asarray(rows))
        tc = A.cache_update(tc, tac, kt, vt, torch.from_numpy(rows))
    _assert_caches_equal(jc, tc)
    return jc, tc, pos + 13


@pytest.mark.parametrize("route", ["bf16", "bf16_attn"] + list(ROUTES))
def test_decode_attend_matches_jax(route):
    change = {"bf16": {}, "bf16_attn": dict(attn_int8=True)}.get(
        route, ROUTES.get(route))
    jac, tac = _cfgs(**change)
    jc, tc, pos = _filled_caches(jac, tac)
    rng = np.random.default_rng(4)
    qj, qt = _bf16(rng.normal(size=(3, 1, 4, 16)) * 2)
    want = JA.decode_attend(qj, jc, jac, jnp.asarray(pos))
    got = A.decode_attend(qt, tc, tac, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 1, 4, 16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **DECODE_TOL)
    # Scalar position: the same row positions for the whole batch.
    want = JA.decode_attend(qj, jc, jac, int(pos[0]))
    got = A.decode_attend(qt, tc, tac, int(pos[0]))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **DECODE_TOL)


def test_attn_int8_integer_products_equal_dot_general(monkeypatch):
    """The route's QK and PV products, on the operands it really forms,
    equal JAX's int32 ``dot_general`` bit for bit; its quantized q equals
    the reference's too."""
    jac, tac = _cfgs(**ROUTES["int8_attn"])
    jc, tc, pos = _filled_caches(jac, tac)
    calls = []
    real = A.int8_dot

    def spy(a, b):
        out = real(a, b)
        calls.append((a, b, out))
        return out
    monkeypatch.setattr(A, "int8_dot", spy)
    qj, qt = _bf16(np.random.default_rng(5).normal(size=(3, 1, 4, 16)))
    A.decode_attend(qt, tc, tac, torch.from_numpy(pos))
    (qi, kt, logits_i), (pi, vq, out_i) = calls
    assert qi.dtype == pi.dtype == torch.int8
    assert logits_i.dtype == out_i.dtype == torch.int32
    # The reference's quantized q, from the same q.
    qf = qj.reshape(3, 2, 2, 16).astype(jnp.float32) * 16 ** -0.5
    qs = jnp.maximum(jnp.max(jnp.abs(qf), -1, keepdims=True) / 127.0, 1e-20)
    want_qi = jnp.clip(jnp.round(qf / qs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qi.numpy(), np.asarray(want_qi))
    kq = jnp.asarray(kt.transpose(-1, -2).numpy())        # [B, G, S, D]
    np.testing.assert_array_equal(
        logits_i.numpy(), np.asarray(jax.lax.dot_general(
            want_qi, kq, (((3,), (3,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.int32)))
    np.testing.assert_array_equal(
        out_i.numpy(), np.asarray(jax.lax.dot_general(
            jnp.asarray(pi.numpy()), jnp.asarray(vq.numpy()),
            (((3,), (2,)), ((0, 1), (0, 1))),
            preferred_element_type=jnp.int32)))


@pytest.mark.parametrize("s_", [7, 1024, 1025, 1033, 2500])
@pytest.mark.parametrize("extreme", [False, True])
def test_int8_dot_is_exact_past_the_float32_bound(s_, extreme):
    """PV sums S products of up to 127 * 128: past 1032 of them a float32
    sum is no longer exact, so int8_dot sums runs of 1024 in int32 (a
    ragged last run zero-padded)."""
    rng = np.random.default_rng(s_)
    if extreme:
        p_ = np.full((2, 2, 3, s_), 127, np.int8)
        v = np.full((2, 2, s_, 16), -128, np.int8)
    else:
        p_ = rng.integers(0, 128, size=(2, 2, 3, s_)).astype(np.int8)
        v = rng.integers(-128, 128, size=(2, 2, s_, 16)).astype(np.int8)
    got = A.int8_dot(torch.from_numpy(p_), torch.from_numpy(v))
    want = jax.lax.dot_general(jnp.asarray(p_), jnp.asarray(v),
                               (((3,), (2,)), ((0, 1), (0, 1))),
                               preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _repeat_route(q, cache, cfg, pos):
    """The reference's repeat route (KV heads repeated to [B, Hq, S, D])
    in decode_attend's batch-invariant form: elementwise products and
    sums over the contiguous last dim."""
    k, v = cache["k"], cache["v"]
    if cfg.kv_cache_bits == 8:
        k = k.float() * cache["k_scale"][..., None]
        v = v.float() * cache["v_scale"][..., None]
    d, n_rep = q.shape[-1], q.shape[2] // cfg.n_kv_heads
    f32 = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    kh = A._repeat_kv(k, n_rep).permute(0, 2, 1, 3).to(**f32)
    vt = A._repeat_kv(v, n_rep).permute(0, 2, 3, 1).to(**f32)
    qt = q.permute(0, 2, 1, 3).to(torch.float32) * d ** -0.5
    logits = (qt * kh).sum(-1)[:, :, None, :]
    valid = A._valid_slots(cache, cfg, pos)
    p_ = torch.softmax(torch.where(valid[:, None, None, :], logits,
                                   A.NEG_INF), dim=-1)
    out = (p_ * vt).sum(-1)[:, :, None, :]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("bits", [16, 8])
def test_gqa_decode_equals_the_repeat_route_bit_for_bit(bits):
    """The grouped float body, taken with or without ``gqa_decode``,
    gives the repeat route's bits."""
    _, tac = _cfgs(kv_cache_bits=bits)
    _, gac = _cfgs(kv_cache_bits=bits, gqa_decode=True)
    _, tc, pos = _filled_caches(*_cfgs(kv_cache_bits=bits))
    q = torch.randn(3, 1, 4, 16, generator=torch.Generator().manual_seed(6))
    q = q.to(torch.bfloat16)
    pos = torch.from_numpy(pos)
    want = _repeat_route(q, tc, tac, pos)
    assert torch.equal(A.decode_attend(q, tc, gac, pos), want)
    assert torch.equal(A.decode_attend(q, tc, tac, pos), want)


@pytest.mark.parametrize("bits", [16, 8])
def test_float_decode_sums_run_over_contiguous_tensors(bits, monkeypatch):
    """The float body's two sums reduce the last dim of contiguous
    tensors on either cache. On the card a sum over a strided dim takes
    a reduction laid out by the batch: with the dequantized cache's K and
    V left as permuted views, a row at batch 8 differed from the row
    alone at 2048 cache slots."""
    _, tac = _cfgs(kv_cache_bits=bits)
    _, tc, pos = _filled_caches(*_cfgs(kv_cache_bits=bits))
    q = torch.randn(3, 1, 4, 16, generator=torch.Generator().manual_seed(6))
    summed = []
    real = torch.Tensor.sum

    def spy(t, *args, **kw):
        summed.append(t.is_contiguous())
        return real(t, *args, **kw)
    monkeypatch.setattr(torch.Tensor, "sum", spy)
    A.decode_attend(q.to(torch.bfloat16), tc, tac, torch.from_numpy(pos))
    assert summed == [True, True]


@pytest.mark.parametrize("route", ["bf16_attn"] + list(ROUTES))
def test_decode_attend_is_batch_invariant(route):
    """Row b attended with the other rows equals row b attended alone."""
    change = ROUTES.get(route, dict(attn_int8=True))
    _, tac = _cfgs(**change)
    _, tc, pos = _filled_caches(*_cfgs(**change), batch=4, seed=8)
    q = torch.randn(4, 1, 4, 16, generator=torch.Generator().manual_seed(9))
    q = q.to(torch.bfloat16)
    out = A.decode_attend(q, tc, tac, torch.from_numpy(pos))
    for b in range(4):
        one = {k: v[b:b + 1] for k, v in tc.items()}
        assert torch.equal(out[b:b + 1],
                           A.decode_attend(q[b:b + 1], one, tac, int(pos[b])))


def test_rms_norm_reduces_over_at_least_16_rows(monkeypatch):
    """RMSNorm's mean of squares runs over at least 16 rows (a decode
    batch is zero-padded), where the card's reduction sums each row in
    one order whatever the batch; on the CPU the result is the unpadded
    mean's, bit for bit."""
    from repro_torch.models import layers as L
    seen = []
    real = torch.mean

    def spy(t, *args, **kw):
        seen.append(t.shape[0])
        return real(t, *args, **kw)
    g = torch.Generator().manual_seed(10)
    for shape in [(1, 1, 64), (4, 1, 64), (2, 16, 64), (3, 1, 4, 16)]:
        x = (torch.randn(shape, generator=g) * 7).to(torch.bfloat16)
        gamma = (torch.randn(shape[-1], generator=g) * 0.1).to(torch.bfloat16)
        xf = x.float()
        want = (xf * torch.rsqrt(real(xf * xf, -1, keepdim=True) + 1e-6)
                * (1.0 + gamma.float())).to(torch.bfloat16)
        seen.clear()
        monkeypatch.setattr(torch, "mean", spy)
        got = L.rms_norm(x, gamma)
        monkeypatch.setattr(torch, "mean", real)
        assert seen and min(seen) >= 16, (shape, seen)
        assert torch.equal(got, want), shape
        for b in range(shape[0]):
            assert torch.equal(got[b:b + 1], L.rms_norm(x[b:b + 1], gamma))


# ---------------------------------------------------------------------------
# The smoke LM on each route
# ---------------------------------------------------------------------------

def _lm_pair(change: dict):
    jcfg = dataclasses.replace(jqwen.smoke_config(), **change)
    params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jsess = loom.compile(jcfg, juniform_policy(8, 8), mode="serve_packed",
                         backend="xla", params=params, specs=specs)
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True), **change)
    tsess = repro_torch.compile(cfg, uniform_policy(8, 8),
                                mode="serve_packed",
                                params=jax.tree.map(np.asarray, params),
                                device="cpu")
    return jsess, tsess


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("route", list(ROUTES))
def test_lm_route_logits_and_greedy_tokens_match_jax(route):
    jsess, tsess = _lm_pair(ROUTES[route])
    tokens = np.random.default_rng(1).integers(
        0, tsess.cfg.vocab, size=(2, PROMPT)).astype(np.int32)
    jl, jc = jsess.prefill(jnp.asarray(tokens))
    tl, tc = tsess.prefill(tokens)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=LOGIT_ATOL)
    # JAX's greedy path, decoded by both; tokens compared where JAX's
    # top-2 margin exceeds twice the tolerance.
    logits = _f32(jl)[:, 0]
    agree, live = 0, np.ones(2, bool)
    for i in range(6):
        tok = np.argmax(logits, axis=-1).astype(np.int32)
        top2 = np.sort(logits, axis=-1)[:, -2:]
        live &= top2[:, 1] - top2[:, 0] > 2 * LOGIT_ATOL
        ours = np.argmax(_f32(tl).reshape(2, -1), axis=-1)
        assert (ours[live] == tok[live]).all(), (route, i)
        agree += int(live.sum())
        jl, jc = jsess.decode(jnp.asarray(tok), PROMPT + i, jc)
        tl, tc = tsess.decode(torch.from_numpy(tok), PROMPT + i, tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0,
                                   atol=LOGIT_ATOL)
        logits = _f32(jl)
    assert agree > 0


def test_block_cache_is_stacked_with_scale_leaves():
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True),
                              kv_cache_bits=8)
    cache = M.init_cache(cfg, 3, 20)
    c = cache["p0"]
    assert sorted(c) == ["k", "k_scale", "slot_pos", "v", "v_scale"]
    assert c["k"].dtype == c["v"].dtype == torch.int8
    assert tuple(c["k"].shape) == (cfg.n_groups, 3, 20, 2, 16)
    for key in ("k_scale", "v_scale"):
        assert c[key].dtype == torch.float32
        assert tuple(c[key].shape) == (cfg.n_groups, 3, 20, 2)
    jc = JM.init_cache(dataclasses.replace(jqwen.smoke_config(),
                                           kv_cache_bits=8), 3, 20)
    for key in c:
        assert tuple(c[key].shape) == jc["p0"][key].shape, key
    # A cross-attention layer's cache: the image embeddings' K/V in bf16
    # and slot_pos zeros, JAX's shapes and dtypes (on the bf16 cache).
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T
    xcfg = dataclasses.replace(cfg, kv_cache_bits=16, n_img_tokens=12)
    jx = dataclasses.replace(jqwen.smoke_config(), n_img_tokens=12)
    got = T.block_cache_init(xcfg, T.LayerSpec(kind="cross"), 3, 20)
    want = JT.block_cache_init(jx, JT.LayerSpec(kind="cross"), 3, 20)
    assert sorted(got) == sorted(want) == ["k", "slot_pos", "v"]
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype) == f"torch.{want[key].dtype}", key
        assert not got[key].float().abs().sum()


# ---------------------------------------------------------------------------
# The batching engine on each route
# ---------------------------------------------------------------------------

def _route_session(route: str):
    cfg = dataclasses.replace(configs.get("qwen3-1.7b", smoke=True),
                              **ROUTES[route])
    return repro_torch.compile(cfg, uniform_policy(8, 8), mode="serve_packed",
                               device="cpu")


def _prompts(cfg, n, seed=21):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=(5 + 2 * j,)).astype(np.int32)
            for j in range(n)]


def test_kvpool_scatter_writes_the_scale_leaves():
    sess = _route_session("int8")
    pool = KVPool(sess, max_batch=3, max_seq=24)
    c1 = sess.init_cache(1, 24)
    _, c1 = sess.prefill(np.arange(1, 7)[None], c1)
    pool.scatter_prefill(2, c1)
    for key in ("k", "v", "k_scale", "v_scale", "slot_pos"):
        assert torch.equal(pool.cache["p0"][key][:, 2], c1["p0"][key][:, 0])
        assert not pool.cache["p0"][key][:, 0].any() or key == "slot_pos"
    assert bool((c1["p0"]["k_scale"][:, 0, :6] > 0).all())


@pytest.mark.parametrize("route", list(ROUTES))
def test_engine_batched_rows_equal_solo_on_every_route(route):
    """4 requests into 3 slots (one queues and joins mid-flight): every
    stream and every batched decode row's logits equal a solo run's."""
    sess = _route_session(route)
    prompts = _prompts(sess.cfg, 4)
    rows, ref = [], []
    decode = sess._decode

    def recorded(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        for slot, req in ref[0].active.items():
            rows.append((req.request_id, req.n_generated, logits[slot]))
        return logits, cache
    eng = BatchingEngine(dataclasses.replace(sess, _decode=recorded),
                         max_batch=3, max_seq=24)
    ref.append(eng)
    handles = []
    for p_ in prompts:
        handles.append(eng.submit(p_, 5))
        eng.step()
    while eng.step():
        pass
    solos = []
    for p_ in prompts:
        logits, cache = sess.prefill(p_[None], sess.init_cache(1, 24))
        out = [logits[0, 0]]
        tok = torch.argmax(logits[:, 0], dim=-1)
        for i in range(4):
            logits, cache = sess.decode(tok, len(p_) + i, cache)
            out.append(logits[0])
            tok = torch.argmax(logits, dim=-1)
        solos.append(out)
    assert len(rows) == 4 * 4
    for rid, idx, row in rows:
        assert torch.equal(row, solos[rid][idx]), (route, rid, idx)
    for h, p_ in zip(handles, prompts):
        np.testing.assert_array_equal(
            h.result(timeout=30.0),
            sess.generate(p_[None], 5, max_seq=24)[0])


@pytest.mark.chaos
def test_engine_restart_rewrites_the_int8_rows():
    """A decode fault restarts the engine on the same pool: the replayed
    prefills rewrite each row's values and scales, and the streams equal
    the solo runs."""
    sess = _route_session("int8_attn")
    prompts = _prompts(sess.cfg, 2, seed=31)
    solos = [sess.generate(p_[None], 5, max_seq=32)[0] for p_ in prompts]
    eng = BatchingEngine(ServingSupervisor(sess), max_batch=2, max_seq=32)
    handles = [eng.submit(p_, 5) for p_ in prompts]
    eng.step()
    eng.step()
    with faults.inject("serve.step", exc=TransientWorkerError("kill"),
                       times=1, match="decode"):
        eng.run(max_steps=100)
    for h, want in zip(handles, solos):
        np.testing.assert_array_equal(h.result(timeout=30.0), want)
    assert eng.stats.n_engine_restarts == 1
