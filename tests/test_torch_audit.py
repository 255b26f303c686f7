"""PyTorch port, the silent-corruption defense: integrity cadence, shadow
audit, quarantine + self-heal (mirrors ``tests/test_audit.py`` on the
port, on the CPU at smoke size).

The engine serves a ``cuda`` session on CPU tensors (the kernels' plain
versions), and the auditor's oracle is ``torch_ref``:

  * storage -- ``weights.bitflip`` at an integrity tick is caught on that
    tick, before the decode, and self-heals from a checkpoint when
    ``heal_dir`` is set (the streams equal an uncorrupted run), else the
    engine fails loudly;
  * compute -- ``backend.silent_corrupt`` on the inner ``cuda`` backend
    (the port dispatches eagerly, so the fault is armed for the whole run
    with ``match=":cuda"``; in the reference it is baked into a jit
    cache) is caught by the audit, the backend is quarantined (on the
    CPU: every op demoted to ``torch_ref``; on the card nothing is
    demoted), and a repro bundle replays;
  * the clean audit path is byte-identical and counted; rate 0 builds
    nothing; the sampler is a deterministic counter.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import os
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.api import backend as backendlib
from repro_torch.api import guards
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.policy import uniform_policy
from repro_torch.models import model as M
from repro_torch.runtime import faults
from repro_torch.runtime.audit import (AuditRecord, ShadowAuditor,
                                       load_bundle, replay_bundle)
from repro_torch.runtime.batching import BatchingEngine
from repro_torch.runtime.serving import DEGRADED, ServingSupervisor

pytestmark = pytest.mark.chaos

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


def _compile(backend: str = "cuda", guarded: bool = False):
    """A fresh smoke-LM session on ``compile``'s seed-0 weights."""
    return repro_torch.compile(_cfg(), POLICY, mode="serve_packed",
                               backend=backend, guarded=guarded,
                               device="cpu")


@functools.lru_cache(maxsize=None)
def _lm_session():
    return _compile()


def _prompts(n, base_len=6, seed=13):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, _cfg().vocab, size=(base_len + j,)).astype(
        np.int32) for j in range(n)]


def _solo(sess, prompt, gen_len):
    return sess.generate(prompt[None, :], gen_len)[0]


def _run_all(eng):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        while eng.step():
            pass
        eng.shutdown(30.0)


@pytest.fixture(scope="module")
def heal_dir(tmp_path_factory):
    """Dense seed-0 checkpoint matching ``compile``'s default weights."""
    path = str(tmp_path_factory.mktemp("heal"))
    ckpt.save_checkpoint(path, 0, M.init_params(_cfg(), None, "cpu"),
                         verify=True)
    return path


# -- storage half: fingerprints + weights.bitflip ---------------------------

def test_engine_bitflip_detected_and_self_healed(heal_dir):
    ref = _lm_session()
    prompts = _prompts(3)
    clean = [_solo(ref, p, 4) for p in prompts]
    eng = BatchingEngine(_compile(), max_batch=2, integrity_every=1,
                         heal_dir=heal_dir)
    handles = [eng.submit(p, 4) for p in prompts]
    with faults.inject("weights.bitflip", times=1) as fault:
        _run_all(eng)
    st = eng.stats
    assert fault.fired == 1
    assert st.n_integrity_checks > 0
    assert st.n_reloads == 1                       # healed exactly once
    # the flip happened at an integrity tick BEFORE decode and was caught
    # on the same tick, so every stream equals an uncorrupted run
    for h, c in zip(handles, clean):
        assert np.array_equal(h.tokens_so_far(), c)
    assert eng.session.verify_integrity() > 0


def test_engine_bitflip_without_heal_dir_fails_loudly():
    eng = BatchingEngine(_compile(), max_batch=2, integrity_every=1)
    h = eng.submit(_prompts(1)[0], 4)
    with faults.inject("weights.bitflip", times=1):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(guards.WeightIntegrityError):
                while eng.step():
                    pass
    assert eng.stats.n_integrity_checks >= 1
    assert "WeightIntegrityError" in (eng.stats.last_error or "")
    assert eng.state == "stopped"
    with pytest.raises(guards.WeightIntegrityError):
        h.result(timeout=5.0)                      # the stream failed too


def test_integrity_cadence_counts_ticks():
    eng = BatchingEngine(_lm_session(), max_batch=2, integrity_every=2)
    h = eng.submit(_prompts(1)[0], 4)
    steps = 0
    while eng.step():
        steps += 1
    steps += 1
    assert eng.stats.n_integrity_checks == -(-steps // 2)
    assert len(h.result(timeout=5.0)) == 4


# -- compute half: backend.silent_corrupt + shadow audit --------------------

def test_silent_corruption_audited_quarantined_bundled(tmp_path):
    ref = _lm_session()
    prompts = _prompts(4)
    clean = [_solo(ref, p, 4) for p in prompts]
    sess = _compile(guarded=True)
    eng = BatchingEngine(sess, max_batch=2, audit_rate=1.0,
                         audit_bundle_dir=str(tmp_path / "bundles"))
    with faults.inject("backend.silent_corrupt", times=None,
                       match=":cuda") as fault:
        handles = [eng.submit(p, 4) for p in prompts]
        _run_all(eng)
    assert fault.fired > 0
    st = eng.stats
    assert st.n_audits == len(prompts)
    assert st.n_divergences >= 1                  # the corruption was seen
    assert st.n_quarantines >= 1
    # quarantine went through the sticky-fallback machinery: every op
    # demoted off the corrupted inner backend (on CPU tensors)
    be = sess.plan.backend
    assert set(be.fallbacks_by_op) == set(backendlib.BACKEND_OPS)
    assert all(name == "torch_ref" for name in be.fallbacks_by_op.values())
    # post-quarantine serving equals the clean oracle
    post = [h.tokens_so_far() for h in handles]
    assert any(np.array_equal(p, c) for p, c in zip(post, clean))
    # a repro bundle was written and replays: the stored served stream
    # diverges from the reference, and a fresh oracle reproduces the
    # stored reference exactly
    bundles = sorted((tmp_path / "bundles").glob("*.npz"))
    assert bundles, "divergence produced no repro bundle"
    b = replay_bundle(str(bundles[0]))
    assert b["diverged"] and b["reproduced"]
    assert b["meta"]["params_src"] == "rng:0"
    assert b["meta"]["device"] == "cpu"
    assert b["meta"]["max_seq"] == eng.max_seq
    assert b["meta"]["backend"].startswith("guarded:")
    health = eng.health()
    assert health["state"] == DEGRADED            # sticky: quarantined
    assert health["fallbacks"] == be.fallbacks_by_op
    assert health["stats"]["n_divergences"] == st.n_divergences
    assert health["stats"]["n_quarantines"] == st.n_quarantines


def test_supervised_quarantine_reinstruments_and_degrades(tmp_path):
    """With a supervisor the quarantine re-instruments the fresh entry
    points (fault points stay attached) and the health degrades."""
    sess = _compile(guarded=True)
    sup = ServingSupervisor(sess)
    eng = BatchingEngine(sup, max_batch=2, audit_rate=1.0,
                         audit_bundle_dir=str(tmp_path))
    prompts = _prompts(2)
    with faults.inject("backend.silent_corrupt", times=2,
                       match="matmul_planes:cuda"):
        handles = [eng.submit(p, 3) for p in prompts]
        _run_all(eng)
    assert eng.stats.n_quarantines == 1
    assert eng.health()["state"] == DEGRADED
    with faults.inject("serve.step", exc=RuntimeError("still wired"),
                       times=1) as fault:
        with pytest.raises(RuntimeError, match="still wired"):
            sup.session.decode(np.zeros(1, np.int32), 0,
                               sup.session.init_cache(1, 8))
    assert fault.fired == 1
    ref = _lm_session()
    assert np.array_equal(handles[-1].tokens_so_far(),
                          _solo(ref, prompts[-1], 3))


def test_audit_clean_path_byte_identical_and_counted():
    ref = _lm_session()
    prompts = _prompts(3)
    clean = [_solo(ref, p, 4) for p in prompts]
    eng = BatchingEngine(_compile(), max_batch=2, audit_rate=1.0)
    handles = [eng.submit(p, 4) for p in prompts]
    _run_all(eng)
    st = eng.stats
    assert st.n_audits == len(prompts)
    assert st.n_divergences == 0
    assert st.n_quarantines == 0
    assert st.p95_audit_lag_s >= 0.0
    assert eng.auditor.max_seq == eng.max_seq
    assert eng.health()["state"] == "healthy"
    for h, c in zip(handles, clean):
        assert np.array_equal(h.tokens_so_far(), c)


def test_audit_rate_zero_builds_nothing():
    eng = BatchingEngine(_lm_session(), max_batch=2)  # audit off (default)
    assert eng.auditor is None                        # zero hot-path surface
    h = eng.submit(_prompts(1)[0], 3)
    _run_all(eng)
    assert eng.stats.n_audits == 0
    assert len(h.tokens_so_far()) == 3


def test_audit_sampler_is_deterministic_counter():
    class _Req:
        def __init__(self, i):
            self.request_id = i
            self.prompt = np.arange(4, dtype=np.int32)
            self.gen_len = 2
            self.stream = self

        def tokens_so_far(self):
            return np.zeros(2, np.int32)

    aud = ShadowAuditor(rate=0.5)
    picks = [aud.observe(_Req(i)) for i in range(1, 9)]
    assert picks == [False, True] * 4                # every 2nd, exactly
    assert ShadowAuditor(rate=0.0).observe(_Req(0)) is False
    aud_all = ShadowAuditor(rate=1.0)
    assert all(aud_all.observe(_Req(i)) for i in range(5))
    assert aud_all.n_pending == 5
    aud_all.invalidate_reference()
    assert aud_all.n_pending == 0                    # hot swap drops pending
    assert ShadowAuditor(rate=3.0).rate == 1.0       # clamped to [0, 1]


def _planted_bundle(tmp_path) -> tuple:
    """A divergence planted in one record (token 2 flipped) and audited:
    returns (the typed error, the clean stream, the record)."""
    aud = ShadowAuditor(rate=1.0, bundle_dir=str(tmp_path))
    sess = _lm_session()
    prompt = _prompts(1)[0]
    served = _solo(sess, prompt, 4)
    wrong = served.copy()
    wrong[2] ^= 1                                    # silent single-token flip
    rec = AuditRecord(request_id=7, prompt=prompt, gen_len=4,
                      served=wrong, done_t=0.0)
    with pytest.raises(guards.SilentDivergenceError) as ei:
        aud.audit_one(sess, rec)
    return ei.value, served, rec


def test_replay_saved_bundle(tmp_path):
    """One-command repro: ``LOOM_AUDIT_BUNDLE=<bundle.npz> pytest
    tests/test_torch_audit.py -k replay_saved_bundle``. Without the
    variable it replays a bundle planted here."""
    path = os.environ.get("LOOM_AUDIT_BUNDLE") or \
        _planted_bundle(tmp_path)[0].bundle_path
    b = replay_bundle(path)
    assert b["diverged"], "bundle's served stream matches its reference"
    assert b["reproduced"], "reference oracle did not reproduce the bundle"


def test_bundle_roundtrip_silent_metadata(tmp_path):
    err, served, rec = _planted_bundle(tmp_path)
    assert err.diverged_at == 2 and err.request_id == 7
    b = load_bundle(err.bundle_path)
    assert np.array_equal(b["prompt"], rec.prompt)
    assert np.array_equal(b["served"], rec.served)
    assert np.array_equal(b["ref"], served)
    assert b["meta"]["diverged_at"] == 2
    assert b["meta"]["arch"] == "qwen3-smoke"
    assert b["meta"]["weights_fingerprint"] == \
        _lm_session().fingerprint.digest()


def test_bundle_replays_on_the_sessions_attention_route(tmp_path,
                                                         monkeypatch):
    """A bundle from an int8-cache ``attn_int8`` session records its
    attention fields and conv route, and replays on that route (its
    integer decode attention runs), not on the bf16 cache's defaults."""
    from repro_torch.models import attention as A
    cfg = dataclasses.replace(_cfg(), kv_cache_bits=8, attn_int8=True)
    sess = repro_torch.compile(cfg, POLICY, mode="serve_packed",
                               device="cpu")
    prompt = _prompts(1)[0]
    served = _solo(sess, prompt, 4)
    wrong = served.copy()
    wrong[1] ^= 1
    aud = ShadowAuditor(rate=1.0, bundle_dir=str(tmp_path))
    with pytest.raises(guards.SilentDivergenceError) as ei:
        aud.audit_one(sess, AuditRecord(request_id=3, prompt=prompt,
                                        gen_len=4, served=wrong, done_t=0.0))
    meta = load_bundle(ei.value.bundle_path)["meta"]
    assert meta["attention"] == {"kv_cache_bits": 8, "gqa_decode": False,
                                 "attn_int8": True}
    assert meta["conv_route"] == "fused"
    calls = []
    real = A._decode_attend_gqa_int8
    monkeypatch.setattr(A, "_decode_attend_gqa_int8",
                        lambda *a: calls.append(1) or real(*a))
    b = replay_bundle(ei.value.bundle_path)
    assert calls, "the replay did not run the attn_int8 route"
    assert b["diverged"] and b["reproduced"]
    assert np.array_equal(b["regenerated"], served)


def test_card_bundle_replays_only_on_the_card(tmp_path, monkeypatch):
    err, _, _ = _planted_bundle(tmp_path)
    b = load_bundle(err.bundle_path)
    meta = dict(b["meta"], device="cuda")
    path = str(tmp_path / "card.npz")
    import json
    np.savez(path, prompt=b["prompt"], served=b["served"], ref=b["ref"],
             meta=np.asarray(json.dumps(meta)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        replay_bundle(path)


# -- quarantine ---------------------------------------------------------------

def test_silent_quarantine_advances_every_op_sticky():
    be = backendlib.GuardedBackend("cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        n = be.quarantine("test", device="cpu")
    assert n == len(backendlib.BACKEND_OPS)
    for op in backendlib.BACKEND_OPS:
        assert be.active_backend(op).name == "torch_ref"
        assert be.fallbacks_by_op[op] == "torch_ref"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert be.quarantine("again", device="cpu") == 0  # chain exhausted


def test_quarantine_on_the_card_demotes_nothing():
    """On the card the chain ends at the kernels (``_usable_chain``), so
    a quarantine there demotes nothing and the plain version never takes
    over serving: it returns 0 and ``fallback_report()`` stays empty."""
    be = backendlib.GuardedBackend("cuda")
    assert [b.name for b in be._usable_chain(torch.device("cuda"))] == \
        ["cuda"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")               # and warns nothing
        assert be.quarantine("divergence on the card", device="cuda") == 0
    assert be.fallbacks_by_op == {}
    plan = repro_torch.build_plan(None, POLICY, "serve_packed", be)
    assert plan.fallback_report() == {}
    # the same backend off the card still demotes
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert be.quarantine("cpu", device="cpu") == len(
            backendlib.BACKEND_OPS)


def test_unguarded_quarantine_counts_and_degrades(tmp_path):
    """An unguarded backend cannot demote: the divergence is still
    counted, bundled and the health degrades while serving goes on."""
    sess = _compile()
    eng = BatchingEngine(sess, max_batch=2, audit_rate=1.0,
                         audit_bundle_dir=str(tmp_path))
    err, _, _ = _planted_bundle(tmp_path / "planted")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng._quarantine(err)
    assert eng.stats.n_quarantines == 1
    assert eng.health()["state"] == DEGRADED
    assert sess.plan.fallback_report() == {}
    h = eng.submit(_prompts(1)[0], 3)
    _run_all(eng)
    assert np.array_equal(h.tokens_so_far(), _solo(_lm_session(),
                                                   _prompts(1)[0], 3))


# -- stats surface ----------------------------------------------------------

def test_audit_stats_fields_surface_in_health():
    eng = BatchingEngine(_lm_session(), max_batch=2)
    stats = eng.health()["stats"]
    for fieldname in ("n_audits", "n_divergences", "n_integrity_checks",
                      "n_quarantines", "p95_audit_lag_s", "n_reloads"):
        assert fieldname in stats
    eng.shutdown(5.0)
