"""PyTorch port, the serving runtime: the continuous-batching engine on the
CPU at smoke size (``device="cpu"``: the ``cuda`` backend's kernel
wrappers take their plain versions).

Mirrors ``tests/test_batching.py`` and ``tests/test_lifecycle.py`` (the
hot swap in ``tests/test_torch_reload.py``). The bar inside the port: every request's
stream, and every batched decode row's logits, equal a solo batch-1
``session.generate`` over a cache of the pool's ``max_seq`` slots, bit for
bit, across {cuda, torch_ref} x {static, dynamic_a, w_group}. Against the
JAX package's ``BatchingEngine`` on the same weights and prompts the
streams are held token for token wherever JAX's top-2 logit margin
exceeds 2 x 0.2 (``tests/test_torch_lm.py``'s rule: the float32 attention
sums run in another order than XLA's).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import threading
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.api import guards
from repro_torch.core.policy import uniform_policy
from repro_torch.runtime import audit, faults
from repro_torch.runtime.batching import BatchingEngine, KVPool, StreamCancelled
from repro_torch.runtime.batching import engine as enginelib
from repro_torch.runtime.batching import streams as streams_mod
from repro_torch.runtime.batching.scheduler import FCFSScheduler
from repro_torch.runtime.serving import DEGRADED, FAILED, ServingSupervisor
from repro_torch.runtime.supervisor import TransientWorkerError

LOGIT_ATOL = 0.2

POLICIES = {
    "static": uniform_policy(8, 8),
    "dynamic_a": uniform_policy(8, 8, dynamic_a=True),
    # runtime activation trimming composed with pack-time per-filter-group
    # weight-plane skipping
    "w_group": uniform_policy(8, 8, dynamic_a=True, w_group=8),
}


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    """The port's fault registry starts clean, and a test that leaks an
    armed fault fails by name."""
    faults.reset()
    yield
    leaked = faults.active_points()
    faults.reset()
    assert not leaked, f"fault(s) still armed at teardown: {leaked}"


@functools.lru_cache(maxsize=None)
def _lm_session(backend: str = "cuda", policy_name: str = "static",
                guarded: bool = False):
    cfg = configs.get("qwen3-1.7b", smoke=True)
    return repro_torch.compile(cfg, POLICIES[policy_name],
                               mode="serve_packed", backend=backend,
                               guarded=guarded, device="cpu")


def _prompts(cfg, n, base_len=5, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=(base_len + j,)).astype(np.int32)
            for j in range(n)]


def _solo(sess, prompt, gen_len, max_seq=None):
    return sess.generate(prompt[None, :], gen_len, max_seq=max_seq)[0]


def _solo_logits(sess, prompt, gen_len, max_seq):
    """Solo generate's logits: the prefill's [V] and each decode step's."""
    logits, cache = sess.prefill(prompt[None, :],
                                 sess.init_cache(1, max_seq))
    out = [logits[0, 0]]
    tok = torch.argmax(logits[:, 0], dim=-1)
    for i in range(gen_len - 1):
        logits, cache = sess.decode(tok, len(prompt) + i, cache)
        out.append(logits[0])
        tok = torch.argmax(logits, dim=-1)
    return out


def _recording(sess, eng_ref: list, rows: list):
    """``sess`` with its decode entry point recording, per batched step,
    each active request's (id, token index) and its logits row."""
    decode = sess._decode

    def recorded(params, token, pos, cache):
        logits, cache = decode(params, token, pos, cache)
        for slot, req in eng_ref[0].active.items():
            rows.append((req.request_id, req.n_generated, logits[slot]))
        return logits, cache
    return dataclasses.replace(sess, _decode=recorded)


# -- the byte-identity bar ---------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch_ref"])
@pytest.mark.parametrize("policy_name", ["static", "dynamic_a", "w_group"])
def test_batched_streams_and_logits_byte_identical_to_solo(backend,
                                                           policy_name):
    """Mixed-length co-batched traffic == solo batch-1, bit for bit: the
    streams, and every batched decode row's logits against the solo
    run's at the same step."""
    sess = _lm_session(backend, policy_name)
    prompts = _prompts(sess.cfg, 3)
    gen_lens = [4, 3, 4]
    max_seq = 40
    solos = [_solo(sess, p, g, max_seq) for p, g in zip(prompts, gen_lens)]
    solo_logits = [_solo_logits(sess, p, g, max_seq)
                   for p, g in zip(prompts, gen_lens)]
    eng_ref, rows = [], []
    eng = BatchingEngine(_recording(sess, eng_ref, rows), max_batch=4,
                         max_seq=max_seq)
    eng_ref.append(eng)
    handles = [eng.submit(p, g) for p, g in zip(prompts, gen_lens)]
    eng.run(max_steps=100)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=30.0), solos[i],
                                      err_msg=f"request {i}")
    assert eng.stats.batch_occupancy > 1.0   # traffic really was co-batched
    assert len(rows) == sum(g - 1 for g in gen_lens)
    for rid, idx, row in rows:
        assert torch.equal(row, solo_logits[rid][idx]), (rid, idx)


def test_ragged_join_and_leave_mid_generation():
    """Requests join a RUNNING batch (staggered) and retire mid-flight
    without disturbing co-tenants -- every stream still solo-identical."""
    sess = _lm_session("cuda", "dynamic_a")
    prompts = _prompts(sess.cfg, 4, seed=23)
    gen_lens = [6, 2, 4, 3]                  # retire at different steps
    solos = [_solo(sess, p, g) for p, g in zip(prompts, gen_lens)]
    eng = BatchingEngine(sess, max_batch=3)  # 4 requests > 3 slots: queueing
    handles = []
    for p, g in zip(prompts, gen_lens):
        handles.append(eng.submit(p, g))
        eng.step()                           # join mid-flight, no drain
    eng.run(max_steps=100)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=30.0), solos[i],
                                      err_msg=f"request {i}")
    assert eng.stats.n_ok == 4


def test_slot_reuse_after_retirement():
    """2 slots, 5 requests: slots cycle through tenants; late requests land
    in reused (dirty) slots and still match solo exactly."""
    sess = _lm_session()
    prompts = _prompts(sess.cfg, 5, seed=31)
    solos = [_solo(sess, p, 3) for p in prompts]
    eng = BatchingEngine(sess, max_batch=2)
    handles = [eng.submit(p, 3) for p in prompts]
    eng.run(max_steps=200)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=30.0), solos[i],
                                      err_msg=f"request {i}")
    assert eng.pool.n_free == 2              # every slot returned
    assert eng.stats.n_ok == 5


def test_cancellation_mid_stream():
    sess = _lm_session()
    prompts = _prompts(sess.cfg, 2, seed=41)
    solo_keep = _solo(sess, prompts[1], 6)
    solo_cancelled = _solo(sess, prompts[0], 6)
    eng = BatchingEngine(sess, max_batch=2)
    h_cancel = eng.submit(prompts[0], 6)
    h_keep = eng.submit(prompts[1], 6)
    eng.step()
    eng.step()
    h_cancel.cancel()
    eng.run(max_steps=100)
    assert h_cancel.state == streams_mod.CANCELLED
    with pytest.raises(StreamCancelled):
        h_cancel.result(timeout=5.0)
    got = h_cancel.tokens_so_far()
    assert 1 <= got.size < 6                 # stopped mid-stream...
    np.testing.assert_array_equal(got, solo_cancelled[:got.size])  # ...clean
    np.testing.assert_array_equal(h_keep.result(timeout=30.0), solo_keep)


def test_stream_iterator_and_cancel_from_queue():
    sess = _lm_session()
    prompts = _prompts(sess.cfg, 3, seed=47)
    eng = BatchingEngine(sess, max_batch=1)  # 3rd request waits in queue
    h0 = eng.submit(prompts[0], 3)
    h1 = eng.submit(prompts[1], 3)
    h2 = eng.submit(prompts[2], 3)
    h2.cancel()                              # cancelled while still queued
    eng.run(max_steps=100)
    assert list(h0) == h0.result().tolist()  # iterator drains the stream
    assert h1.state == streams_mod.DONE
    assert h2.state == streams_mod.CANCELLED and h2.n_tokens == 0


# -- pool + decode-path units ------------------------------------------------

def test_kvpool_alloc_free_determinism():
    pool = KVPool(_lm_session(), max_batch=3)
    assert [pool.alloc(), pool.alloc()] == [0, 1]
    pool.free(0)
    assert pool.alloc() == 0                 # lowest-first, deterministic
    assert pool.alloc() == 2 and pool.alloc() is None
    with pytest.raises(ValueError):
        pool.free(5)
    pool.free(1)
    with pytest.raises(ValueError):
        pool.free(1)                         # double-free is loud


def test_kvpool_scatter_prefill_writes_exact_row_in_place():
    sess = _lm_session()
    pool = KVPool(sess, max_batch=3, max_seq=24)
    leaves = [pool.cache["p0"][k] for k in ("k", "v", "slot_pos")]
    before = [t.clone() for t in leaves]
    rng = np.random.default_rng(3)
    c1 = sess.init_cache(1, pool.max_seq)
    _, c1 = sess.prefill(rng.integers(1, sess.cfg.vocab, size=(1, 6)),
                         cache=c1)
    pool.scatter_prefill(1, c1)
    for key, leaf, old in zip(("k", "v", "slot_pos"), leaves, before):
        assert pool.cache["p0"][key] is leaf            # written in place
        assert torch.equal(leaf[:, 1], c1["p0"][key][:, 0]), key
        assert torch.equal(leaf[:, 0], old[:, 0])       # neighbours intact
        assert torch.equal(leaf[:, 2], old[:, 2])
    assert torch.equal(c1["p0"]["slot_pos"][0, 0, :6],
                       torch.arange(6, dtype=torch.int32))


def test_vector_pos_decode_matches_scalar():
    """decode(pos=[B] all equal) == decode(pos=int), bit for bit."""
    sess = _lm_session("cuda", "dynamic_a")
    tokens = np.random.default_rng(5).integers(1, sess.cfg.vocab, size=(2, 6))
    logits, cache_a = sess.prefill(tokens)
    _, cache_b = sess.prefill(tokens)
    tok = torch.argmax(logits[:, 0], dim=-1)
    la, _ = sess.decode(tok, 6, cache_a)
    lb, _ = sess.decode(tok, np.full((2,), 6, np.int32), cache_b)
    assert torch.equal(la, lb)


def test_decode_attend_is_batch_invariant_and_matches_einsum():
    """decode_attend: row b attended with three other rows equals row b
    attended alone, bit for bit; and it equals the float32 einsum form
    within float32 rounding (other summation orders)."""
    from repro_torch.models import attention as A
    cfg = A.AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16)
    g = torch.Generator().manual_seed(7)
    cache = A.init_cache(cfg, 4, 40)
    cache["k"].copy_(torch.randn(cache["k"].shape, generator=g))
    cache["v"].copy_(torch.randn(cache["v"].shape, generator=g))
    pos = torch.tensor([5, 17, 39, 22], dtype=torch.int32)
    for b in range(4):
        cache["slot_pos"][b, :int(pos[b]) + 1] = torch.arange(int(pos[b]) + 1)
    q = torch.randn(4, 1, 4, 16, generator=g).to(torch.bfloat16)
    out = A.decode_attend(q, cache, cfg, pos)
    for b in range(4):
        one = {k: v[b:b + 1] for k, v in cache.items()}
        assert torch.equal(out[b:b + 1],
                           A.decode_attend(q[b:b + 1], one, cfg, int(pos[b])))
    kh = A._repeat_kv(cache["k"], 2).permute(0, 2, 1, 3).float()
    vh = A._repeat_kv(cache["v"], 2).permute(0, 2, 1, 3).float()
    logits = torch.einsum("bhqd,bhkd->bhqk",
                          q.permute(0, 2, 1, 3).float() * 16 ** -0.5, kh)
    valid = A._valid_slots(cache, cfg, pos)
    p_ = torch.softmax(torch.where(valid[:, None, None, :], logits,
                                   A.NEG_INF), dim=-1)
    want = torch.einsum("bhqk,bhkd->bhqd", p_, vh).permute(0, 2, 1, 3)
    torch.testing.assert_close(out.float(), want.to(torch.bfloat16).float(),
                               rtol=2 ** -7, atol=1e-6)


def test_generate_transfers_once_byte_identical():
    """generate() keeps the tokens on the device and transfers once: equal
    to a loop that takes each step's tokens to the host."""
    sess = _lm_session()
    tokens = np.random.default_rng(9).integers(1, sess.cfg.vocab, size=(2, 5))
    got = sess.generate(tokens, 4)
    logits, cache = sess.prefill(tokens)
    tok = torch.argmax(logits[:, 0], dim=-1)
    out = [tok.numpy()]
    for i in range(3):
        logits, cache = sess.decode(tok, 5 + i, cache)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok.numpy())
    np.testing.assert_array_equal(got, np.stack(out, axis=1))


def test_engine_rejects_cnn_and_oversized_requests():
    cnn = repro_torch.compile(configs.get("paper-cnn", smoke=True),
                              POLICIES["static"], mode="serve_packed",
                              device="cpu")
    with pytest.raises(ValueError, match="not an LM session"):
        BatchingEngine(cnn, max_batch=2)
    eng = BatchingEngine(_lm_session(), max_batch=1, max_seq=8)
    h = eng.submit(np.arange(1, 7, dtype=np.int32), 5)   # 6 + 5 > 8
    eng.run(max_steps=10)
    with pytest.raises(ValueError, match="exceeds the pool's max_seq"):
        h.result(timeout=5.0)


def test_engine_metrics_feed_supervisor_health():
    sess = _lm_session()
    sup = ServingSupervisor(sess)
    eng = BatchingEngine(sup, max_batch=2)
    for p in _prompts(sess.cfg, 2, seed=51):
        eng.submit(p, 3)
    eng.run(max_steps=100)
    health = eng.health()
    stats = health["stats"]
    assert stats["n_tokens_streamed"] == 6
    assert stats["batch_occupancy"] == pytest.approx(2.0)
    assert stats["tokens_per_s"] > 0
    assert stats["mean_request_latency_s"] > 0
    assert stats["queue_depth"] == 0
    assert health["state"] == "healthy" and health["fallbacks"] == {}
    assert eng.n_decode_steps == 2


@pytest.mark.parametrize("kwargs", [dict(audit_rate=0.5),
                                    dict(integrity_every=4),
                                    dict(heal_dir="ckpt")])
def test_a9b_options_raise(kwargs):
    """The options of the second half of the runtime (ROADMAP A.9b) build
    their machinery; none of them raises any more."""
    eng = BatchingEngine(_lm_session(), max_batch=2, **kwargs)
    if "audit_rate" in kwargs:
        assert eng.auditor.rate == 0.5
        assert audit.REF_BACKEND == "torch_ref"
        assert eng.auditor._ref_session is None     # built on first audit
        assert eng.auditor.max_seq == eng.max_seq
    else:
        assert eng.auditor is None
    assert eng.integrity_every == kwargs.get("integrity_every")
    assert eng.heal_dir == kwargs.get("heal_dir")


def test_a9b_hot_swap_raises_and_defaults_build_nothing(tmp_path):
    """A hot swap raises only the typed refusals now; the defaults build
    nothing."""
    eng = BatchingEngine(_lm_session(), max_batch=2, audit_rate=0.0,
                         integrity_every=None)
    with pytest.raises(guards.ReloadMismatchError):
        eng.reload({})
    with pytest.raises(guards.ReloadMismatchError, match="no checkpoints"):
        eng.reload_checkpoint(str(tmp_path / "ckpt"))
    assert eng.auditor is None and eng.integrity_every is None
    assert eng.stats.n_reloads == 0


# -- against the JAX package's engine ----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pair(policy_name: str):
    """The JAX smoke session and the port's, on the JAX package's seed-0
    weights."""
    import jax

    import repro.api as loom
    from repro.configs import qwen3_1_7b as jqwen
    from repro.core.policy import uniform_policy as juniform
    from repro.models import model as JM
    from repro_torch import interop
    jcfg = jqwen.smoke_config()
    params, specs = JM.init_params(jax.random.PRNGKey(0), jcfg)
    dyn = policy_name == "dynamic_a"
    jsess = loom.compile(jcfg, juniform(8, 8, dynamic_a=dyn),
                         mode="serve_packed", backend="xla", params=params,
                         specs=specs)
    tsess = repro_torch.compile(
        configs.get("qwen3-1.7b", smoke=True), POLICIES[policy_name],
        mode="serve_packed",
        params=interop.params_from_numpy(jax.tree.map(np.asarray, params)),
        device="cpu")
    return jsess, tsess


def _jax_margins(jsess, prompt, stream):
    """JAX's top-2 logit margin at each token of its own greedy stream."""
    import jax.numpy as jnp
    logits, cache = jsess.prefill(jnp.asarray(prompt[None, :]))
    row = np.asarray(logits[0, 0], np.float32)
    margins = []
    for i in range(len(stream)):
        top2 = np.sort(row)[-2:]
        margins.append(top2[1] - top2[0])
        if i + 1 < len(stream):
            logits, cache = jsess.decode(jnp.asarray(stream[i:i + 1]),
                                         len(prompt) + i, cache)
            row = np.asarray(logits[0], np.float32)
    return margins


@pytest.mark.parametrize("policy_name", ["static", "dynamic_a"])
def test_engine_streams_match_jax_engine_where_the_margin_allows(policy_name):
    from repro.runtime.batching import BatchingEngine as JaxEngine
    jsess, tsess = _jax_pair(policy_name)
    prompts = _prompts(tsess.cfg, 3, base_len=8, seed=13)
    gen_len = 6
    jeng = JaxEngine(jsess, max_batch=2)
    jh = [jeng.submit(p, gen_len) for p in prompts]
    jeng.run(max_steps=100)
    teng = BatchingEngine(tsess, max_batch=2)
    th = [teng.submit(p, gen_len) for p in prompts]
    teng.run(max_steps=100)
    compared = 0
    for j, (p, a, b) in enumerate(zip(prompts, jh, th)):
        want, got = a.result(timeout=30.0), b.result(timeout=30.0)
        for i, margin in enumerate(_jax_margins(jsess, p, want)):
            if margin <= 2 * LOGIT_ATOL:
                break                   # later tokens follow another path
            assert got[i] == want[i], (j, i)
            compared += 1
    assert compared > 0


# -- chaos: a faulted step degrades the session, not the queue ---------------

@pytest.mark.chaos
def test_backend_op_fault_queue_survives():
    """An injected backend.op transient during the engine's first prefill
    heals via the engine's per-request retry: every request still
    completes with solo-identical streams."""
    ref = _lm_session()
    guarded = _lm_session(guarded=True)
    prompts = _prompts(ref.cfg, 2, seed=61)
    solos = [_solo(ref, p, 3) for p in prompts]
    eng = BatchingEngine(ServingSupervisor(guarded), max_batch=2)
    with faults.inject("backend.op", exc=guards.BackendTransientError("inj"),
                       times=1):
        handles = [eng.submit(p, 3) for p in prompts]
        eng.run(max_steps=100)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=30.0), solos[i],
                                      err_msg=f"request {i}")
    assert eng.stats.n_ok == 2
    assert eng.stats.n_retries >= 1          # the fault really fired
    assert guarded.plan.fallback_report() == {}


@pytest.mark.chaos
def test_decode_fault_restart_and_replay_byte_identical():
    """A decode-step kill triggers restart-and-replay: slots freed,
    re-prefill, deterministic regeneration with already-delivered tokens
    suppressed -- streams stay byte-identical, supervisor degrades."""
    sess = _lm_session("cuda", "dynamic_a")
    prompts = _prompts(sess.cfg, 2, seed=71)
    solos = [_solo(sess, p, 5) for p in prompts]
    sup = ServingSupervisor(sess)
    eng = BatchingEngine(sup, max_batch=2)
    handles = [eng.submit(p, 5) for p in prompts]
    eng.step()                               # prefill + first decode, clean
    with faults.inject("serve.step", exc=TransientWorkerError("kill"),
                       times=1, match="decode"):
        eng.run(max_steps=100)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=30.0), solos[i],
                                      err_msg=f"request {i}")
    assert eng.stats.n_engine_restarts == 1
    assert sup.state == DEGRADED


@pytest.mark.chaos
def test_fault_mid_decode_half_written_pool_is_replaced(monkeypatch):
    """The cache is written in place: a fault after layer 0 of a decode
    step has written its K/V leaves the pool half written. Nothing writes
    it after the fault, so the restart keeps the pool and replaces every
    half-written row whole with its replayed prefill's; the streams stay
    byte-identical."""
    sess = _lm_session(guarded=True)
    prompts = _prompts(sess.cfg, 2, seed=73)
    solos = [_solo(_lm_session(), p, 5) for p in prompts]
    eng = BatchingEngine(sess, max_batch=2)
    handles = [eng.submit(p, 5) for p in prompts]
    eng.step()
    old_pool = eng.pool
    written = old_pool.cache["p0"]["slot_pos"].clone()
    # The decode's 5th backend op is layer 0's ffn_up: layer 0's K/V are
    # already in the pool.
    calls = {"n": 0}
    at_fault = {}
    fire = faults.fire

    def fire_from_the_fifth(point, detail=""):
        if point == "backend.op":
            calls["n"] += 1
            if calls["n"] < 5:
                return
            at_fault.setdefault("slot_pos",
                                old_pool.cache["p0"]["slot_pos"].clone())
        fire(point, detail)
    monkeypatch.setattr(faults, "fire", fire_from_the_fifth)
    with faults.inject("backend.op", exc=TransientWorkerError("mid-step"),
                       times=1) as fault:
        eng.step()
    monkeypatch.setattr(faults, "fire", fire)
    assert fault.fired == 1 and eng.stats.n_engine_restarts == 1
    half = at_fault["slot_pos"]
    assert not torch.equal(half[0], written[0])    # layer 0 was written
    assert torch.equal(half[1], written[1])        # layer 1 was not
    assert eng.pool is old_pool                    # no second pool held
    plain = _lm_session()
    for slot, p in enumerate(prompts):             # each row rewritten whole
        _, row = plain.prefill(p[None, :], plain.init_cache(1, eng.max_seq))
        for key in ("k", "v", "slot_pos"):
            assert torch.equal(eng.pool.cache["p0"][key][:, slot],
                               row["p0"][key][:, 0]), (slot, key)
    eng.run(max_steps=100)
    for i, h in enumerate(handles):
        np.testing.assert_array_equal(h.result(timeout=30.0), solos[i],
                                      err_msg=f"request {i}")


@pytest.mark.chaos
@pytest.mark.parametrize("point", ["backend.op", "engine.step_stall"])
def test_restart_holds_one_pool_at_a_time(monkeypatch, point):
    """A restart never holds two pools: after a fault the pool is kept;
    after a stall (whose abandoned call may still write the old pool) a
    new one is allocated only once the engine has dropped the old."""
    sess = _lm_session(guarded=True)
    prompts = _prompts(sess.cfg, 2, seed=79)
    solos = [_solo(_lm_session(), p, 4) for p in prompts]
    stall = point == "engine.step_stall"
    eng = BatchingEngine(sess, max_batch=2,
                         step_timeout_s=0.5 if stall else None)
    built = []

    class CountingPool(KVPool):
        def __init__(self, *args, **kwargs):
            built.append(eng.pool)       # what the engine still held
            super().__init__(*args, **kwargs)
    monkeypatch.setattr(enginelib, "KVPool", CountingPool)
    first = eng.pool
    hs = [eng.submit(p, 4) for p in prompts]
    eng.step()
    kw = (dict(exc=TransientWorkerError("lost"), match="matmul_planes")
          if not stall else dict(delay=1.5))
    with faults.inject(point, times=1, **kw) as fault:
        eng.run(max_steps=100)
    assert fault.fired == 1 and eng.stats.n_engine_restarts == 1
    if stall:
        assert built == [None] and eng.pool is not first
    else:
        assert built == [] and eng.pool is first
    for h, want in zip(hs, solos):
        np.testing.assert_array_equal(h.result(timeout=30.0), want)
    eng.drain()


@pytest.mark.chaos
def test_restart_exhaustion_fails_active_but_queue_serves_on():
    """Restarts beyond max_restarts fail the ACTIVE streams loudly with the
    typed error -- but the engine keeps serving new requests."""
    sess = _lm_session()
    prompts = _prompts(sess.cfg, 2, seed=81)
    sup = ServingSupervisor(sess)
    eng = BatchingEngine(sup, max_batch=2, max_restarts=1)
    h0 = eng.submit(prompts[0], 4)
    with faults.inject("serve.step", exc=TransientWorkerError("dead"),
                       times=None, match="decode"):
        eng.run(max_steps=100)
    assert h0.state == streams_mod.FAILED
    with pytest.raises(TransientWorkerError):
        h0.result(timeout=5.0)
    assert sup.state == FAILED
    solo = _solo(sess, prompts[1], 3)
    h1 = eng.submit(prompts[1], 3)
    eng.run(max_steps=100)
    np.testing.assert_array_equal(h1.result(timeout=30.0), solo)
    assert eng.stats.n_ok >= 1


@pytest.mark.chaos
def test_sticky_cuda_error_fails_loudly_without_looping():
    """A sticky CUDA context error is fatal: the guarded chain tries
    torch_ref on these CPU tensors, which fails as well (on the card the
    chain ends at the kernels), and the engine stops with every stream
    failed -- no restart loop."""
    sess = _lm_session(guarded=True)
    eng = BatchingEngine(ServingSupervisor(sess), max_batch=2)
    hs = [eng.submit(p, 4) for p in _prompts(sess.cfg, 2, seed=83)]
    eng.step()                               # both prefilled, one decode
    err = RuntimeError("CUDA error: an illegal memory access was encountered")
    with pytest.warns(RuntimeWarning, match="falling back"):
        with faults.inject("backend.op", exc=err, times=None):
            with pytest.raises(guards.FallbackExhaustedError):
                eng.run(max_steps=20)
    assert eng.stats.n_engine_restarts == 0
    assert eng.state == enginelib.STOPPED
    for h in hs:
        assert h.state == streams_mod.FAILED and h.n_tokens == 2
    assert guards.classify_error(err) == guards.FATAL


# -- admission control -------------------------------------------------------

def test_queue_full_typed_rejection():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2, max_queue=2)
    ps = _prompts(sess.cfg, 3)
    eng.submit(ps[0], 2)
    eng.submit(ps[1], 2)
    with pytest.raises(guards.QueueFullError):
        eng.submit(ps[2], 2)
    assert eng.stats.n_rejected == 1
    assert isinstance(guards.QueueFullError("x"), guards.ServingFault)
    eng.drain()


def test_blocking_submit_times_out_with_typed_error():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2, max_queue=1)
    ps = _prompts(sess.cfg, 2)
    eng.submit(ps[0], 2)
    t0 = time.monotonic()
    with pytest.raises(guards.QueueFullError):
        eng.submit(ps[1], 2, block=True, timeout=0.2)
    assert time.monotonic() - t0 >= 0.2       # it actually waited
    assert eng.stats.n_rejected == 1
    eng.drain()


def test_blocking_submit_succeeds_when_assembly_frees_a_slot():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2, max_queue=1)
    ps = _prompts(sess.cfg, 2)
    h0 = eng.submit(ps[0], 2)
    done = threading.Event()

    def driver():
        while not done.wait(0.01):
            eng.step()

    t = threading.Thread(target=driver, daemon=True)
    t.start()
    try:
        h1 = eng.submit(ps[1], 2, block=True, timeout=30.0)
    finally:
        done.set()
        t.join(timeout=30.0)
    assert not t.is_alive()
    eng.drain()
    np.testing.assert_array_equal(h0.result(), _solo(sess, ps[0], 2))
    np.testing.assert_array_equal(h1.result(), _solo(sess, ps[1], 2))


@pytest.mark.chaos
def test_queued_deadline_shed_before_prefill_typed():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2)
    h = eng.submit(_prompts(sess.cfg, 1)[0], 4, deadline_s=0.0)
    eng.step()
    assert h.state == streams_mod.FAILED
    with pytest.raises(guards.RequestTimeoutError):
        h.result(timeout=1.0)
    assert h.n_tokens == 0                    # shed BEFORE prefill
    assert eng.stats.n_shed == 1
    assert eng.stats.n_failed == 0            # shed is overload, not fault


def test_expired_head_never_blocks_request_behind_it():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=1)
    ps = _prompts(sess.cfg, 2)
    dead = eng.submit(ps[0], 2, deadline_s=0.0)
    live = eng.submit(ps[1], 2)
    eng.step()     # ONE step: the expired head must not eat the slot
    assert dead.state == streams_mod.FAILED
    assert live.state in (streams_mod.DECODING, streams_mod.DONE)
    eng.drain()
    np.testing.assert_array_equal(live.result(), _solo(sess, ps[1], 2))


@pytest.mark.chaos
def test_inflight_deadline_retires_with_partial_tokens():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2)
    p = _prompts(sess.cfg, 1)[0]
    h = eng.submit(p, 6)
    eng.step()
    eng.step()
    partial = list(h.tokens_so_far())
    assert 0 < len(partial) < 6
    next(iter(eng.active.values())).deadline_t = 0.0
    eng.step()
    assert h.state == streams_mod.FAILED
    with pytest.raises(guards.RequestTimeoutError, match="in flight"):
        h.result(timeout=1.0)
    assert list(h.tokens_so_far()) == partial
    assert partial == list(_solo(sess, p, 6)[:len(partial)])
    assert eng.stats.n_deadline_expired == 1
    assert len(eng.active) == 0 and eng.pool.n_free == 2   # slot freed


# -- graceful lifecycle ------------------------------------------------------

def test_drain_finishes_work_then_refuses_submits():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2)
    ps = _prompts(sess.cfg, 3)
    hs = [eng.submit(p, 3) for p in ps]
    eng.drain()
    assert eng.state == enginelib.STOPPED
    assert eng.health()["engine_state"] == "stopped"
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(), _solo(sess, p, 3))
    with pytest.raises(guards.EngineClosedError):
        eng.submit(ps[0], 3)
    assert eng.last_drain_s > 0


@pytest.mark.chaos
def test_shutdown_bounded_fails_residual_streams_loudly():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2)
    hs = [eng.submit(p, 64) for p in _prompts(sess.cfg, 4)]
    eng.step()                                    # some partial progress
    t0 = time.monotonic()
    summary = eng.shutdown(timeout=0.0)
    assert time.monotonic() - t0 < 5.0            # bounded wall-clock
    assert summary["drained"] is False
    assert summary["n_failed_residual"] == 4
    assert eng.state == enginelib.STOPPED
    for h in hs:
        with pytest.raises(guards.EngineClosedError):
            h.result(timeout=1.0)                 # typed, and NO hang
    assert any(h.n_tokens > 0 for h in hs)


def test_shutdown_after_drain_is_idempotent():
    eng = BatchingEngine(_lm_session(), max_batch=2)
    eng.drain()
    out = eng.shutdown(timeout=1.0)
    assert out == {"drained": True, "n_failed_residual": 0, "elapsed_s": 0.0}


@pytest.mark.chaos
def test_engine_death_fails_all_streams_with_typed_cause():
    """Poisoned step loop: every live stream fails with the cause --
    result()/iterators never block on a dead engine."""
    boom = RuntimeError("poisoned beyond repair")

    def poisoned(*a, **k):
        raise boom

    sess = _lm_session()
    eng = BatchingEngine(dataclasses.replace(sess, _decode=poisoned),
                         max_batch=2)
    hs = [eng.submit(p, 4) for p in _prompts(sess.cfg, 3)]
    with pytest.raises(RuntimeError, match="poisoned"):
        eng.run(max_steps=100)
    assert eng.state == enginelib.STOPPED
    for h in hs:
        assert h.state == streams_mod.FAILED
        with pytest.raises(RuntimeError, match="poisoned"):
            h.result(timeout=1.0)


# -- decode watchdog ---------------------------------------------------------

@pytest.mark.chaos
def test_stalled_step_trips_watchdog_and_replays_byte_identical():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2, step_timeout_s=0.25)
    ps = _prompts(sess.cfg, 2)
    hs = [eng.submit(p, 4) for p in ps]
    with faults.inject("engine.step_stall", delay=1.5, times=1) as fault:
        eng.run(max_steps=200)
    assert fault.fired == 1
    assert eng.stats.n_engine_restarts == 1
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(), _solo(sess, p, 4))
    assert eng.health()["state"] == "degraded"
    eng.drain()


@pytest.mark.chaos
def test_persistent_stall_exhausts_max_restarts_typed():
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=1, step_timeout_s=0.2,
                         max_restarts=1)
    h = eng.submit(_prompts(sess.cfg, 1)[0], 4)
    with faults.inject("engine.step_stall", delay=1.0, times=None):
        eng.run(max_steps=50)
    with pytest.raises(guards.StepStallError):
        h.result(timeout=1.0)
    assert eng.stats.n_engine_restarts == 2       # 1 allowed + the fatal one
    eng.drain()


@pytest.mark.parametrize("backend", ["cuda", "torch_ref"])
def test_fault_free_path_with_watchdog_byte_identical(backend):
    """The watchdog arms a deadline, not a different computation: the
    decode runs on the watchdog's thread and every stream still equals
    solo."""
    sess = _lm_session(backend)
    eng = BatchingEngine(sess, max_batch=2, max_queue=8, step_timeout_s=60.0)
    ps = _prompts(sess.cfg, 3)
    hs = [eng.submit(p, 4) for p in ps]
    eng.run(max_steps=300)
    for h, p in zip(hs, ps):
        np.testing.assert_array_equal(h.result(), _solo(sess, p, 4))
    st = eng.stats
    assert st.p95_request_latency_s >= st.p50_request_latency_s > 0
    assert st.p95_queue_wait_s >= st.p50_queue_wait_s >= 0
    assert eng._watchdog is not None              # the worker really ran it
    eng.drain()
    assert eng._watchdog is None


# -- scheduler edge cases ----------------------------------------------------

def test_cancel_while_queued_frees_the_queue_slot():
    sched = FCFSScheduler(max_queue=1)
    a = sched.submit([1, 2, 3], 2)
    a.stream.cancel()
    b = sched.submit([4, 5, 6], 2)                # purge makes room: no raise
    assert a.stream.state == streams_mod.CANCELLED
    admitted, dropped, expired = sched.assemble(4)
    assert [r.request_id for r in admitted] == [b.request_id]
    assert dropped == [] and expired == []


def test_assemble_full_pool_empty_queue_is_noop():
    sched = FCFSScheduler(max_queue=4)
    assert sched.assemble(0) == ([], [], [])      # full pool
    assert sched.assemble(4) == ([], [], [])      # empty queue
    assert sched.depth == 0


def test_scheduler_expired_head_shed_without_consuming_slot():
    sched = FCFSScheduler()
    dead = sched.submit([1, 2], 2, deadline_s=0.0)
    live = sched.submit([3, 4], 2)
    admitted, dropped, expired = sched.assemble(1)   # ONE slot
    assert [r.request_id for r in expired] == [dead.request_id]
    assert [r.request_id for r in admitted] == [live.request_id]
    assert dropped == []


# -- overload burst ----------------------------------------------------------

@pytest.mark.chaos
@pytest.mark.overload
def test_overload_burst_typed_rejections_sheds_no_hangs_health_recovers():
    """Burst 4x max_queue submissions with short deadlines: exact typed
    rejections + sheds, zero hangs, health degraded-then-recovered."""
    sess = _lm_session()
    eng = BatchingEngine(sess, max_batch=2, max_queue=4,
                         overload_window_s=0.4)
    ps = _prompts(sess.cfg, 1)
    burst = 4 * eng.max_queue
    t0 = time.monotonic()
    handles, rejected = [], 0
    for _ in range(burst):
        try:
            handles.append(eng.submit(ps[0], 2, deadline_s=0.0))
        except guards.QueueFullError:
            rejected += 1
    assert rejected == burst - eng.max_queue      # exactly the overflow
    assert eng.stats.n_rejected == rejected
    eng.step()                                    # sheds the expired queue
    assert eng.stats.n_shed == eng.max_queue
    assert eng.health()["state"] == "degraded"    # overload visible
    for h in handles:
        with pytest.raises(guards.RequestTimeoutError):
            h.result(timeout=1.0)
    h = eng.submit(ps[0], 2)
    eng.run(max_steps=100)
    np.testing.assert_array_equal(h.result(), _solo(sess, ps[0], 2))
    time.sleep(eng.overload_window_s + 0.05)
    assert eng.health()["state"] == "healthy"
    assert time.monotonic() - t0 < 60.0           # bounded end to end
    eng.drain()


def test_supervisor_close_joins_worker_threads():
    sess = _lm_session()
    sup = ServingSupervisor(sess, timeout_s=30.0)
    sup.generate(_prompts(sess.cfg, 1)[0][None, :], 2)
    workers = [t for t in threading.enumerate()
               if t.name.startswith("serve-supervisor")]
    assert workers                                # executor actually used
    sup.close()
    assert sup._executor is None
    for t in workers:
        assert not t.is_alive()                   # joined, not abandoned
    sup.close()                                   # idempotent
