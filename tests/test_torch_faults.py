"""PyTorch port, the fault model: every registered fault point with a site
heals or fails loudly, on the CPU at smoke size.

Mirrors the non-checkpoint half of ``tests/test_faults.py`` (the
checkpoint points in ``tests/test_torch_ckpt.py``, the integrity and audit
points in ``tests/test_torch_audit.py``; the training supervisor's in
``tests/test_torch_train_optim.py``):

    backend.op         -> sticky fallback down ``cuda -> torch_ref`` on the
                          CPU, or a typed FallbackExhaustedError; on the
                          card a typed compile/resource/exhausted error,
                          never the plain version; transients re-raise
    serve.step         -> supervisor retry (kill-and-resume byte-identical)
                          / typed RequestTimeoutError on slow steps
    serve.nan_poison   -> typed NumericIntegrityError, healed by retry
    backend.silent_corrupt
                       -> wrong-but-finite values, raising nothing

plus the typed taxonomy (with the port's CUDA and build markers), the
accumulator bound against the JAX package's, and bit-transparency:
guarded serving (GuardedBackend + ServingSupervisor) is byte-identical to
unguarded serving on the fault-free path, for the LM and the paper CNN.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import functools
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.api import backend as backendlib
from repro_torch.api import guards
from repro_torch.core import bitpack
from repro_torch.core.policy import uniform_policy
from repro_torch.runtime import faults
from repro_torch.runtime.serving import (DEGRADED, FAILED, HEALTHY,
                                         ServingSupervisor)
from repro_torch.runtime.supervisor import StepMonitor, TransientWorkerError

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


@functools.lru_cache(maxsize=None)
def _cnn_session(backend: str, guarded: bool):
    return repro_torch.compile(configs.get("paper_cnn", smoke=True), POLICY,
                               mode="serve_packed", backend=backend,
                               guarded=guarded, device="cpu")


@functools.lru_cache(maxsize=None)
def _lm_session(backend: str, guarded: bool):
    return repro_torch.compile(configs.get("qwen3-1.7b", smoke=True), POLICY,
                               mode="serve_packed", backend=backend,
                               guarded=guarded, device="cpu")


def _cnn_inputs(batch: int = 2) -> np.ndarray:
    cfg = configs.get("paper_cnn", smoke=True)
    rng = np.random.default_rng(0)
    return rng.normal(size=(batch, cfg.img, cfg.img,
                            cfg.in_ch)).astype(np.float32)


def _lm_tokens(batch: int = 2, s: int = 8) -> np.ndarray:
    cfg = configs.get("qwen3-1.7b", smoke=True)
    return np.random.default_rng(0).integers(1, cfg.vocab, size=(batch, s))


def _matmul_operands(m: int = 4, k: int = 16, n: int = 8, w_bits: int = 8):
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-(1 << (w_bits - 1)),
                                       1 << (w_bits - 1), size=(k, n)))
    return xq, bitpack.pack_weights(wq.to(torch.int32), w_bits)


# -- fault registry semantics ----------------------------------------------

def test_registry_matches_the_reference():
    from repro.runtime import faults as jfaults
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert len(faults.FAULT_POINTS) == 8


def test_unknown_fault_point_rejected():
    with pytest.raises(faults.UnknownFaultPoint):
        with faults.inject("no.such.point"):
            pass
    with pytest.raises(faults.UnknownFaultPoint):
        faults.fire("no.such.point")          # fast path still validates
    with pytest.raises(faults.UnknownFaultPoint):
        faults.take("no.such.point")
    with pytest.raises(faults.UnknownFaultPoint):
        faults.active("no.such.point")


def test_fault_times_match_and_fired_counter():
    with faults.inject("serve.step", exc=RuntimeError("boom"), times=2,
                       match="decode") as fault:
        faults.fire("serve.step", detail="prefill")       # match filter
        for _ in range(2):
            with pytest.raises(RuntimeError):
                faults.fire("serve.step", detail="decode")
        faults.fire("serve.step", detail="decode")        # times exhausted
        assert fault.fired == 2
    assert faults.active("serve.step") is None            # context exit


def test_take_counts_without_raising():
    with faults.inject("ckpt.leaf_corrupt") as fault:     # no exc: effect
        assert faults.take("ckpt.leaf_corrupt") is True   # site applies it
        assert faults.take("ckpt.leaf_corrupt") is False  # times=1 default
        assert fault.fired == 1
    assert faults.take("ckpt.leaf_corrupt") is False


def test_inject_restores_registry_when_body_raises():
    with pytest.raises(RuntimeError, match="body died"):
        with faults.inject("weights.bitflip", times=None):
            assert faults.active_points() == ("weights.bitflip",)
            raise RuntimeError("body died")
    assert faults.active("weights.bitflip") is None
    assert faults.active_points() == ()


def test_step_monitor_flags_a_straggler():
    mon = StepMonitor(k_sigma=4.0, warmup=8)
    assert not any(mon.observe(0.01 + 1e-4 * (i % 3)) for i in range(20))
    assert mon.observe(1.0)


# -- typed error taxonomy ---------------------------------------------------

@pytest.mark.parametrize("exc,kind", [
    (TransientWorkerError("kill"), guards.TRANSIENT),
    (RuntimeError("connection reset by peer"), guards.TRANSIENT),
    (TimeoutError("slow"), guards.TRANSIENT),
    (RuntimeError("Mosaic lowering failed"), guards.COMPILE),
    (RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH"),
     guards.COMPILE),
    (RuntimeError("kernel build failed:\nbitserial_matmul: nvcc exited 1"),
     guards.COMPILE),
    (RuntimeError("RESOURCE_EXHAUSTED: vmem"), guards.RESOURCE),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     guards.RESOURCE),
    (torch.cuda.OutOfMemoryError("allocator says no"), guards.RESOURCE),
    (guards.BackendShapeError("bad"), guards.SHAPE),
    (ValueError("operand shape mismatch"), guards.SHAPE),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     guards.FATAL),
    (RuntimeError("CUDA error: unspecified launch failure (transient?)"),
     guards.FATAL),
    (RuntimeError("???"), guards.FATAL),
])
def test_classify_error_taxonomy(exc, kind):
    assert guards.classify_error(exc) == kind


def test_classify_error_agrees_with_the_reference_on_its_markers():
    from repro.api import guards as jguards
    for msg in ("connection reset by peer", "Mosaic lowering failed",
                "RESOURCE_EXHAUSTED: vmem", "operand shape mismatch", "???",
                "XLA compilation failed", "out of memory"):
        for cls in (RuntimeError, ValueError):
            assert guards.classify_error(cls(msg)) == \
                jguards.classify_error(cls(msg)), msg


def test_accum_bound_math_agrees_with_the_reference_and_kernels():
    from repro.api import guards as jguards
    from repro_torch.kernels.ops import conv_accum_fits_f32
    for k, a, w in [(9 * 9 * 64, 8, 8), (576, 4, 4), (1 << 20, 8, 11),
                    (27, 2, 2), (4096, 8, 8), (6144, 8, 8), (1, 16, 16)]:
        assert guards.accum_fits_f32(k, a, w) == conv_accum_fits_f32(k, a, w)
        assert guards.accum_fits_f32(k, a, w) == jguards.accum_fits_f32(k, a, w)
        assert guards.accum_magnitude_bits(k, a, w) == \
            jguards.accum_magnitude_bits(k, a, w)
    guards.check_accum_bound(4096, 8, 8)                  # fits int32
    with pytest.raises(guards.AccumulatorOverflowError):
        guards.check_accum_bound(1 << 20, 8, 11)          # 37 bits > 31


def test_check_finite_reduces_on_the_tensor():
    guards.check_finite(torch.ones(3, 5, dtype=torch.bfloat16), "ok")
    guards.check_finite(torch.tensor([1, 2], dtype=torch.int32))  # not float
    x = torch.zeros(2, 256, dtype=torch.bfloat16)
    x[1, 7] = float("inf")
    x[0, 3] = float("nan")
    with pytest.raises(guards.NumericIntegrityError, match="2/512"):
        guards.check_finite(x, "logits")
    with pytest.raises(guards.NumericIntegrityError):
        guards.check_finite(np.array([np.nan], np.float32))


# -- guarded prechecks -------------------------------------------------------

def test_guarded_accum_overflow_fails_loudly():
    xq, wp = _matmul_operands()
    gb = backendlib.GuardedBackend("torch_ref")
    with pytest.raises(guards.AccumulatorOverflowError):
        gb.matmul_planes(xq, wp, w_bits=8, a_bits=25)
    assert gb.fallbacks_by_op == {}       # fail-loud, never fall back


def test_guarded_shape_guard_fails_loudly():
    xq, wp = _matmul_operands(k=16)
    gb = backendlib.GuardedBackend("torch_ref")
    with pytest.raises(guards.BackendShapeError):
        gb.matmul_planes(torch.zeros((4, 32), dtype=torch.int8), wp, w_bits=8)
    assert gb.fallbacks_by_op == {}


def test_guarded_count_prechecks_fail_loudly():
    xq, wp = _matmul_operands(n=32)
    gb = backendlib.GuardedBackend("cuda")
    with pytest.raises(guards.BackendShapeError, match="pass law"):
        gb.matmul_planes(xq, wp, w_bits=8, w_counts=(8,), w_group=16)
    with pytest.raises(guards.WeightIntegrityError):
        gb.matmul_planes(xq, wp, w_bits=8, w_counts=(8, 9), w_group=16)
    with pytest.raises(guards.WeightIntegrityError, match="runtime plane"):
        gb.matmul_planes_dynamic(xq, wp, torch.tensor([0, 8],
                                                      dtype=torch.int32),
                                 w_bits=8, bn=16)
    assert gb.fallbacks_by_op == {}


def test_guarded_dynamic_quant_rejects_nonfinite_input():
    gb = backendlib.GuardedBackend("cuda")
    x = torch.tensor([[1.0, float("nan"), 2.0, 3.0]])
    with pytest.raises(guards.NumericIntegrityError):
        gb.dynamic_quant(x, group_size=4, bits=8)


def test_guarded_ops_return_the_inner_results_unchanged():
    xq, wp = _matmul_operands(n=32)
    gb = backendlib.guard_backend("cuda")
    assert backendlib.guard_backend(gb) is gb             # idempotent
    assert [b.name for b in gb.chain] == ["cuda", "torch_ref"]
    assert [b.name for b in backendlib.GuardedBackend("torch_ref").chain] \
        == ["torch_ref"]
    inner = backendlib.resolve_backend("cuda")
    assert torch.equal(gb.matmul_planes(xq, wp, w_bits=8),
                       inner.matmul_planes(xq, wp, w_bits=8))
    counts = torch.tensor([3, 8], dtype=torch.int32)
    assert torch.equal(
        gb.matmul_planes_dynamic(xq, wp, counts, w_bits=8, bn=16),
        inner.matmul_planes_dynamic(xq, wp, counts, w_bits=8, bn=16))
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    for a, b in zip(gb.dynamic_quant(x, group_size=8, bits=8),
                    inner.dynamic_quant(x, group_size=8, bits=8)):
        assert torch.equal(a, b)


def test_silent_corrupt_point_flips_values_without_raising():
    xq, wp = _matmul_operands(n=32)
    gb = backendlib.GuardedBackend("cuda")
    want = gb.matmul_planes(xq, wp, w_bits=8)
    with faults.inject("backend.silent_corrupt", match="matmul_planes:cuda"):
        got = gb.matmul_planes(xq, wp, w_bits=8)
    assert torch.equal(got, torch.flip(want, dims=(-1,)))
    assert not torch.equal(got, want) and gb.fallbacks_by_op == {}


# -- backend.op: fallback chain --------------------------------------------

def test_backend_op_transient_reraises_then_heals():
    xq, wp = _matmul_operands()
    gb = backendlib.GuardedBackend("cuda")
    with faults.inject("backend.op", exc=TransientWorkerError("preempted"),
                       times=1, match="matmul_planes"):
        with pytest.raises(TransientWorkerError):
            gb.matmul_planes(xq, wp, w_bits=8)
        assert gb.fallbacks_by_op == {}   # transient: substrate is fine
        out = gb.matmul_planes(xq, wp, w_bits=8)          # retry heals
    ref = backendlib.resolve_backend("torch_ref").matmul_planes(xq, wp,
                                                                w_bits=8)
    assert torch.equal(out, ref)


def test_backend_op_fallback_exhausted_typed_error():
    xq, wp = _matmul_operands()
    gb = backendlib.GuardedBackend("torch_ref")   # chain is [torch_ref] only
    with faults.inject("backend.op", exc=RuntimeError("kernel build failed"),
                       times=None, match="matmul_planes"):
        with pytest.raises(guards.FallbackExhaustedError):
            gb.matmul_planes(xq, wp, w_bits=8)


class _OnCard:
    """An operand that reports itself on the card (the dispatcher reads
    ``is_cuda`` only; the planted fault raises before any op runs)."""
    is_cuda = True


@pytest.mark.parametrize("msg,typed", [
    ("kernel build failed:\nbitserial_matmul: nvcc exited 1",
     guards.BackendCompileError),
    ("nvcc not found: set CUDA_HOME or put nvcc on PATH",
     guards.BackendCompileError),
    ("CUDA out of memory. Tried to allocate 2.00 GiB",
     guards.BackendResourceError),
    ("CUDA error: an illegal memory access was encountered",
     guards.FallbackExhaustedError),
    ("???", guards.FallbackExhaustedError),
])
def test_backend_op_on_the_card_raises_typed_never_plain(msg, typed):
    """On CUDA tensors the chain ends at ``cuda``: a failed kernel raises
    its typed fault, and ``torch_ref`` is neither tried nor recorded."""
    gb = backendlib.GuardedBackend("cuda")
    assert [b.name for b in gb._usable_chain(_OnCard())] == ["cuda"]
    with faults.inject("backend.op", exc=RuntimeError(msg), times=None,
                       match="matmul_planes") as fault:
        with warnings.catch_warnings():
            warnings.simplefilter("error")         # no fallback warning
            with pytest.raises(typed, match="on CUDA tensors"):
                gb._dispatch("matmul_planes", _OnCard(), None, w_bits=8)
    assert fault.fired == 1                        # torch_ref never tried
    assert gb.fallbacks_by_op == {}
    assert gb.active_backend("matmul_planes").name == "cuda"
    xq, wp = _matmul_operands()                    # the CPU keeps the step
    assert [b.name for b in gb._usable_chain(xq)] == ["cuda", "torch_ref"]


def test_backend_op_sticky_fallback_is_exact():
    """A permanent ``cuda`` failure degrades every op to torch_ref --
    recorded on the plan -- and the degraded output is exactly the
    torch_ref session's (fallback never changes values), on the same
    device."""
    sess = repro_torch.compile(configs.get("paper_cnn", smoke=True), POLICY,
                               mode="serve_packed", backend="cuda",
                               guarded=True, device="cpu")
    ref = _cnn_session("torch_ref", False).classify(_cnn_inputs())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject("backend.op",
                           exc=RuntimeError("kernel build failed: nvcc"),
                           times=None, match=":cuda") as fault:
            out = sess.classify(_cnn_inputs())
            again = sess.classify(_cnn_inputs())   # sticky: no new attempt
    assert fault.fired == len(sess.plan.fallback_report()) >= 1
    report = sess.plan.fallback_report()
    assert set(report) == {"conv_planes", "matmul_planes"}
    assert all(v == "torch_ref" for v in report.values())
    assert sess.plan.backend.active_backend("conv_planes").name == "torch_ref"
    assert any("falling back" in str(w.message) for w in caught)
    assert torch.equal(out, ref) and torch.equal(again, ref)
    assert out.device == ref.device


# -- bit-transparency: guarded == unguarded ---------------------------------

@pytest.mark.parametrize("backend", ["cuda", "torch_ref"])
def test_guarded_cnn_bit_identical(backend):
    base = _cnn_session(backend, False).classify(_cnn_inputs())
    sess = _cnn_session(backend, True)
    assert torch.equal(base, sess.classify(_cnn_inputs()))
    assert sess.plan.fallback_report() == {}
    sup = ServingSupervisor(sess)
    assert torch.equal(base, sup.classify(_cnn_inputs()))
    assert sup.health()["state"] == HEALTHY


@pytest.mark.parametrize("backend", ["cuda", "torch_ref"])
def test_guarded_lm_bit_identical(backend):
    base = _lm_session(backend, False).generate(_lm_tokens(), 4)
    sess = _lm_session(backend, True)
    assert np.array_equal(base, sess.generate(_lm_tokens(), 4))
    assert sess.plan.fallback_report() == {}
    sup = ServingSupervisor(sess)
    assert np.array_equal(base, sup.generate(_lm_tokens(), 4))
    assert sup.health()["state"] == HEALTHY
    assert sess.layer_plan("lm_head").w_group_counts is not None
    fresh = sess.rejit()
    assert fresh.plan is sess.plan and fresh._decode is not sess._decode
    assert np.array_equal(base, fresh.generate(_lm_tokens(), 4))


# -- serve.step: kill-and-resume / timeout / health -------------------------

def test_kill_and_resume_generate_byte_identical():
    """A TransientWorkerError mid-generate is retried and the healed token
    stream is byte-identical to an uninterrupted run."""
    sess = _lm_session("cuda", False)
    base = sess.generate(_lm_tokens(), 4)
    sup = ServingSupervisor(sess, backoff_s=0.001)
    with faults.inject("serve.step",
                       exc=TransientWorkerError("worker killed mid-decode"),
                       times=1, match="decode") as fault:
        out = sup.generate(_lm_tokens(), 4)
    assert fault.fired == 1
    assert np.array_equal(base, out)
    assert sup.stats.n_retries == 1 and sup.stats.n_ok == 1
    assert sup.state == DEGRADED          # the episode stays visible


def test_slow_step_times_out_typed_then_heals():
    sess = _cnn_session("cuda", False)
    base = sess.classify(_cnn_inputs())
    sup = ServingSupervisor(sess, timeout_s=0.5, backoff_s=0.001)
    sup2 = ServingSupervisor(sess, timeout_s=0.3, max_retries=0)
    try:
        with faults.inject("serve.step", delay=1.5, times=1,
                           match="classify"):
            out = sup.classify(_cnn_inputs())
        assert sup.stats.n_timeouts == 1 and sup.stats.n_retries == 1
        assert torch.equal(base, out)
        with faults.inject("serve.step", delay=1.5, times=None,
                           match="classify"):
            with pytest.raises(guards.RequestTimeoutError):
                sup2.classify(_cnn_inputs())
        assert sup2.state == FAILED
    finally:
        sup.close()
        sup2.close()


def test_nan_poison_caught_and_healed():
    sess = _cnn_session("cuda", False)
    base = sess.classify(_cnn_inputs())
    sup = ServingSupervisor(sess, backoff_s=0.001)
    with faults.inject("serve.nan_poison", times=1, match="classify"):
        out = sup.classify(_cnn_inputs())
    assert sup.stats.n_numeric_faults == 1
    assert torch.equal(base, out)


def test_nan_poison_on_lm_logits_caught_and_healed():
    sess = _lm_session("cuda", False)
    base = sess.generate(_lm_tokens(), 4)
    sup = ServingSupervisor(sess, backoff_s=0.001)
    with faults.inject("serve.nan_poison", times=1, match="decode") as fault:
        out = sup.generate(_lm_tokens(), 4)
    assert fault.fired == 1 and sup.stats.n_numeric_faults == 1
    assert np.array_equal(base, out)


def test_nan_poison_exhausted_fails_loudly_then_degraded():
    """Persistent poisoning -> typed error (never argmax over NaN); a later
    clean request moves failed -> degraded, never back to healthy."""
    sess = _cnn_session("cuda", False)
    sup = ServingSupervisor(sess, max_retries=1, backoff_s=0.001)
    with faults.inject("serve.nan_poison", times=None, match="classify"):
        with pytest.raises(guards.NumericIntegrityError):
            sup.classify(_cnn_inputs())
    assert sup.state == FAILED
    out = sup.classify(_cnn_inputs())     # fault gone: serving works again
    assert torch.equal(out, sess.classify(_cnn_inputs()))
    assert sup.state == DEGRADED


def test_session_level_degrade_rebuilds_on_compile_fault():
    """A permanent (compile-class) fault escaping the session degrades the
    WHOLE session down fallback_backends via the rebuild hook, and the
    rebuilt backend serves the same answer."""
    base = _cnn_session("torch_ref", False).classify(_cnn_inputs())
    sup = ServingSupervisor(_cnn_session("cuda", False),
                            rebuild=lambda name: _cnn_session(name, False))
    assert sup.fallback_backends == ["torch_ref"]         # the default chain
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with faults.inject("serve.step",
                           exc=RuntimeError("kernel build failed: nvcc "
                                            "exited 1"),
                           times=1, match="classify"):
            out = sup.classify(_cnn_inputs())
    assert torch.equal(base, out)
    assert sup.stats.n_session_fallbacks == 1
    assert sup.health()["backend"] == "torch_ref"
    assert sup.state == DEGRADED
    assert any("rebuilding" in str(w.message) for w in caught)


def test_session_level_degrade_refused_on_the_card():
    """A session on the card never degrades to the plain version: the
    compile fault fails the request loudly and the hook is not called."""
    import dataclasses
    on_card = dataclasses.replace(_cnn_session("cuda", False),
                                  device=torch.device("cuda"))
    rebuilt = []
    sup = ServingSupervisor(on_card, rebuild=rebuilt.append)
    with faults.inject("serve.step",
                       exc=RuntimeError("kernel build failed: nvcc exited 1"),
                       times=1, match="classify"):
        with pytest.raises(RuntimeError, match="kernel build failed"):
            # the entry point itself: the fault fires before any tensor
            # would reach the (absent) card
            sup._request(lambda s: s._classify(s.params, None))
    assert rebuilt == [] and sup.stats.n_session_fallbacks == 0
    assert sup.state == FAILED and sup.health()["backend"] == "cuda"


def test_unhealable_fault_fails_typed_without_rebuild():
    sup = ServingSupervisor(_cnn_session("cuda", False))
    with faults.inject("serve.step", exc=RuntimeError("???"), times=1,
                       match="classify"):
        with pytest.raises(RuntimeError, match=r"\?\?\?"):
            sup.classify(_cnn_inputs())
    assert sup.state == FAILED and sup.stats.n_failed == 1
