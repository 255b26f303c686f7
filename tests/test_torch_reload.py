"""PyTorch port, hot weight swap (``BatchingEngine.reload`` /
``reload_checkpoint``) and the checkpoint handoff between the two packages
(mirrors ``tests/test_lifecycle.py``'s hot-swap tests on the port, on the
CPU at smoke size).

The slice as a whole: the JAX package saves the smoke LM's dense params;
a port engine serving other weights hot-swaps that directory mid-traffic,
and every token after the swap equals what a fresh port engine compiled
on the same arrays (through ``interop``) emits at that position. The
paper CNN compiled from a checkpoint the JAX package wrote gives logits
bit-identical to the un-jitted JAX ``cnn.forward``.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as loom
from repro.ckpt import checkpoint as jck
from repro.configs import paper_cnn as jpaper_cnn
from repro.configs import qwen3_1_7b as jqwen
from repro.core.policy import uniform_policy as juniform
from repro.models import cnn as jcnn
from repro.models import model as JM
import repro_torch
from repro_torch import configs, interop
from repro_torch.api import guards
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.policy import uniform_policy
from repro_torch.models import cnn, model as M
from repro_torch.runtime import faults
from repro_torch.runtime.batching import BatchingEngine

POLICY = uniform_policy(8, 8)


@pytest.fixture(autouse=True)
def _no_fault_leaks():
    """The port's fault registry starts clean, and a test that leaks an
    armed fault fails by name."""
    faults.reset()
    yield
    leaked = faults.active_points()
    faults.reset()
    assert not leaked, f"fault(s) still armed at teardown: {leaked}"


def _cfg():
    return configs.get("qwen3-1.7b", smoke=True)


def _compile(params=None, policy=POLICY):
    return repro_torch.compile(_cfg(), policy, mode="serve_packed",
                               params=params, device="cpu")


@functools.lru_cache(maxsize=None)
def _lm_session():
    return _compile()


@functools.lru_cache(maxsize=None)
def _alt_checkpoint():
    """A second LM checkpoint (dense layout, seed 1) + a session compiled
    on it -- the newly profiled weights a hot swap deploys."""
    dense = M.init_params(_cfg(), torch.Generator().manual_seed(1), "cpu")
    return dense, _compile(dense)


def _prompts(n, base_len=5, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, _cfg().vocab, size=(base_len + j,)).astype(
        np.int32) for j in range(n)]


def _solo(sess, prompt, gen_len):
    return sess.generate(prompt[None, :], gen_len)[0]


def _swap_mid_traffic(sess_a, sess_b, swap, **engine_kw):
    """Serve 3 requests on ``sess_a``, call ``swap(engine)`` after 3 steps
    (2 requests in flight), serve on; every post-swap token must equal
    ``sess_b``'s solo run at that position."""
    ps = _prompts(3)
    solo_a = [_solo(sess_a, p, 6) for p in ps]
    solo_b = [_solo(sess_b, p, 6) for p in ps]
    eng = BatchingEngine(sess_a, max_batch=2, **engine_kw)
    h0, h1 = eng.submit(ps[0], 6), eng.submit(ps[1], 6)
    for _ in range(3):
        eng.step()
    pre0 = list(h0.tokens_so_far())
    pre1 = len(h1.tokens_so_far())
    assert 0 < len(pre0) < 6
    assert pre0 == list(solo_a[0][:len(pre0)])     # old weights until swap
    swap(eng)
    h2 = eng.submit(ps[2], 6)                      # post-swap admission
    eng.run(max_steps=300)
    r0 = h0.result(timeout=5.0)
    assert list(r0[:len(pre0)]) == pre0            # delivered prefix kept
    assert np.array_equal(r0[len(pre0):], solo_b[0][len(pre0):])
    r1 = h1.result(timeout=5.0)
    assert np.array_equal(r1[pre1:], solo_b[1][pre1:])
    assert np.array_equal(h2.result(timeout=5.0), solo_b[2])
    assert eng.stats.n_reloads == 1
    eng.drain()
    return eng


@pytest.mark.chaos
def test_reload_mid_traffic_byte_identical_to_fresh_engine():
    dense1, sess_b = _alt_checkpoint()
    eng = _swap_mid_traffic(_compile(), sess_b,
                            lambda e: e.reload(dense1))
    # the swap re-anchored the fingerprint on the new weights
    assert eng.session.fingerprint.digest() == sess_b.fingerprint.digest()


@pytest.mark.chaos
def test_reload_mismatch_refused_typed_old_weights_keep_serving():
    sess = _compile()
    dense1, _ = _alt_checkpoint()
    bad = dict(dense1, head={"w": torch.zeros((3, 3), dtype=torch.bfloat16)})
    eng = BatchingEngine(sess, max_batch=2)
    p = _prompts(1)[0]
    h = eng.submit(p, 4)
    with pytest.raises(guards.ReloadMismatchError):
        eng.reload(bad)
    missing = {k: v for k, v in dense1.items() if k != "final_norm"}
    with pytest.raises(guards.ReloadMismatchError, match="structure"):
        eng.reload(missing)
    wrong_dtype = dict(dense1, embed={"emb": dense1["embed"]["emb"].float()})
    with pytest.raises(guards.ReloadMismatchError, match="dtype"):
        eng.reload(wrong_dtype)
    eng.run(max_steps=200)
    assert np.array_equal(h.result(timeout=5.0), _solo(_lm_session(), p, 4))
    assert eng.stats.n_reloads == 0
    assert eng.session.verify_integrity() > 0      # old weights untouched


@pytest.mark.chaos
def test_reload_refuses_changed_weight_group_counts():
    """Pack-time counts are plan constants: new weights whose head packs
    to other counts need a recompile, not a hot swap."""
    policy = uniform_policy(8, 8, w_group=16)
    sess = _compile(policy=policy)
    assert sess.plan.layers[("lm_head", "linear")].w_group_counts
    dense1, _ = _alt_checkpoint()
    w = dense1["head"]["w"].clone()
    w[:, :16] /= 32                                 # one group: fewer planes
    eng = BatchingEngine(sess, max_batch=2)
    with pytest.raises(guards.ReloadMismatchError, match="counts"):
        eng.reload(dict(dense1, head={"w": w}))
    eng.reload(dense1)                              # same counts: accepted
    assert eng.stats.n_reloads == 1


@pytest.mark.chaos
def test_reload_checkpoint_crc_corrupt_falls_back_to_good_step(tmp_path):
    dense1, sess_b = _alt_checkpoint()
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 1, dense1)
    dense2 = M.init_params(_cfg(), torch.Generator().manual_seed(2), "cpu")
    with faults.inject("ckpt.leaf_corrupt"):
        ckpt.save_checkpoint(d, 2, dense2)          # newest step is corrupt
    eng = BatchingEngine(_compile(), max_batch=2)
    with pytest.warns(RuntimeWarning, match="corrupt"):
        got = eng.reload_checkpoint(d)
    assert got == 1                                 # fell back, CRC-verified
    p = _prompts(1)[0]
    h = eng.submit(p, 4)
    eng.run(max_steps=200)
    assert np.array_equal(h.result(timeout=5.0), _solo(sess_b, p, 4))
    assert eng.reload_checkpoint(d, step=1) == 1    # an explicit step
    with pytest.raises(ckpt.CheckpointCorruptError):
        eng.reload_checkpoint(d, step=2)
    with pytest.raises(guards.ReloadMismatchError, match="no checkpoints"):
        eng.reload_checkpoint(str(tmp_path / "empty"))


def test_reload_refused_on_stopped_engine():
    dense1, _ = _alt_checkpoint()
    eng = BatchingEngine(_lm_session(), max_batch=2)
    eng.drain()
    with pytest.raises(guards.EngineClosedError):
        eng.reload(dense1)


@pytest.mark.chaos
def test_reload_drops_the_auditors_pending_records():
    dense1, sess_b = _alt_checkpoint()
    eng = BatchingEngine(_compile(), max_batch=2, audit_rate=1.0)
    h = eng.submit(_prompts(1)[0], 2)
    while len(eng.active) or eng.scheduler.depth:
        eng._retire_cancelled()
        eng._admit()
        eng._decode_once()            # retire without the audit tick
    assert h.state == "done" and eng.auditor.n_pending == 1
    eng.reload(dense1)
    assert eng.auditor.n_pending == 0 and eng.auditor._ref_session is None
    h2 = eng.submit(_prompts(1)[0], 3)
    eng.run(max_steps=100)
    assert eng.stats.n_audits == 1 and eng.stats.n_divergences == 0
    assert np.array_equal(h2.result(timeout=5.0),
                          _solo(sess_b, _prompts(1)[0], 3))


@pytest.mark.chaos
def test_reload_audits_no_stream_begun_before_the_swap():
    """The 2 requests in flight at the swap keep the old weights' prefix,
    so no replay under the new weights can match them: the auditor skips
    them, and a healthy engine auditing every request finds no divergence
    (only the request admitted after the swap is audited)."""
    dense1, sess_b = _alt_checkpoint()
    eng = _swap_mid_traffic(_compile(), sess_b, lambda e: e.reload(dense1),
                            audit_rate=1.0)
    st = eng.stats
    assert (st.n_audits, st.n_divergences, st.n_quarantines) == (1, 0, 0)
    assert eng.health()["state"] == "healthy"


# -- the checkpoint handoff between the packages ----------------------------


@functools.lru_cache(maxsize=None)
def _jax_dense_lm() -> dict:
    params, _ = JM.init_params(jax.random.PRNGKey(1), jqwen.smoke_config())
    return jax.tree.map(np.asarray, params)


@pytest.mark.chaos
def test_reload_checkpoint_written_by_the_reference(tmp_path):
    """The JAX package saves its dense smoke-LM params; a port engine
    serving the port's seed-0 weights hot-swaps that directory
    mid-traffic; every post-swap token equals a fresh port engine's on the
    same arrays."""
    jck.save_checkpoint(str(tmp_path), 5, _jax_dense_lm())
    fresh = _compile(interop.params_from_numpy(_jax_dense_lm()))
    got = []
    _swap_mid_traffic(_compile(), fresh,
                      lambda e: got.append(e.reload_checkpoint(str(tmp_path))))
    assert got == [5]


@pytest.mark.chaos
def test_port_checkpoint_heals_a_reference_trained_session(tmp_path):
    """The other way: a port checkpoint of the JAX arrays restores in the
    JAX package to the same arrays, and compiles there to the port's
    fingerprint digest."""
    ckpt.save_checkpoint(str(tmp_path), 0,
                         interop.params_from_numpy(_jax_dense_lm()))
    jparams, specs = JM.init_params(jax.random.PRNGKey(0),
                                    jqwen.smoke_config())
    restored, _ = jck.restore_checkpoint(str(tmp_path), 0, jparams)
    jsess = loom.compile(jqwen.smoke_config(), juniform(8, 8),
                         mode="serve_packed", backend="xla",
                         params=restored, specs=specs)
    fresh = _compile(interop.params_from_numpy(_jax_dense_lm()))
    assert jsess.fingerprint.digest() == fresh.fingerprint.digest()


def test_cnn_from_a_reference_checkpoint_matches_unjitted_jax(tmp_path):
    jcfg = jpaper_cnn.smoke_config()
    params, specs = jcnn.init_params(jax.random.PRNGKey(4), jcfg)
    jck.save_checkpoint(str(tmp_path), 0, jax.tree.map(np.asarray, params))
    cfg = configs.get("paper_cnn", smoke=True)
    like = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    restored, _ = ckpt.restore_checkpoint(str(tmp_path), 0, like)
    x = np.random.default_rng(5).normal(
        size=(2, jcfg.img, jcfg.img, 3)).astype(np.float32)
    jsess = loom.compile(jcfg, juniform(8, 8), mode="serve_packed",
                         backend="xla", params=params, specs=specs)
    eager = np.asarray(jcnn.forward(jsess.params, jcfg, jnp.asarray(x),
                                    jsess.plan))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsess = repro_torch.compile(cfg, POLICY, mode="serve_packed",
                                    params=restored, device="cpu")
    np.testing.assert_array_equal(tsess.classify(x).numpy(), eager)
    assert tsess.fingerprint.digest() == jsess.fingerprint.digest()
