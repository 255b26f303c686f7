"""Typed fault taxonomy + numeric-integrity checks for guarded serving.

PyTorch-port counterpart of ``repro/api/guards.py``. The serving stack's
failure contract: every fault is either *healed* (retry, backend
fallback) or surfaced as one of the typed errors below -- never a silent
wrong answer. Two mechanisms consume this module:

  * :class:`repro_torch.api.backend.GuardedBackend` classifies exceptions
    from an inner backend op (:func:`classify_error`) to decide between
    re-raising (transient: the supervisor retries the request) and
    degrading down the fallback chain (compile/resource/shape/unknown:
    the op is re-dispatched on the next backend and *stays* there; on
    the card, where the chain ends before the plain version, it raises
    the typed compile / resource / exhausted fault instead).
  * :class:`repro_torch.runtime.serving.ServingSupervisor` retries
    transient faults with backoff and checks that every output is finite
    (:func:`check_finite`, reduced on the tensor's device).

Accumulator-overflow guard: the int32 accumulation of the bit-serial
kernels is exact only while every partial sum fits it.
:func:`check_accum_bound` recomputes the bound from the actual (Pa, Pw,
K) of the operands about to be dispatched and raises
:class:`AccumulatorOverflowError` when int32 can wrap (fail loudly: every
backend of the chain shares the same int32 accumulator).
"""
from __future__ import annotations

import torch

# -- Typed error taxonomy ---------------------------------------------------


class ServingFault(RuntimeError):
    """Base of every typed serving-stack fault."""


class BackendFault(ServingFault):
    """Base of faults attributed to a backend op dispatch."""


class BackendTransientError(BackendFault):
    """A fault a plain retry should heal (no substrate change needed)."""


class BackendCompileError(BackendFault):
    """Kernel build/compilation failed on this substrate (permanent)."""


class BackendResourceError(BackendFault):
    """Device memory exhausted on this substrate (permanent at this
    shape)."""


class BackendShapeError(BackendFault):
    """Operand shapes are incoherent for the op (caller bug; permanent)."""


class FallbackExhaustedError(BackendFault):
    """Every backend in the fallback chain failed for an op."""


class NumericIntegrityError(ServingFault):
    """NaN/Inf detected where the serve path guarantees finite values."""


class AccumulatorOverflowError(NumericIntegrityError):
    """(Pa, Pw, K) can overflow the int32 accumulator: wrong logits."""


class WeightIntegrityError(NumericIntegrityError):
    """In-memory serving weights no longer match their compile-time CRC32
    fingerprint (bit flip / bad swap), or their pass-law metadata is
    corrupt (plane counts outside [1, Pw]). Detected by the periodic
    integrity check (``core.integrity``); the engine self-heals by
    reloading the last good checkpoint when one is configured, else fails
    loudly."""


class SilentDivergenceError(NumericIntegrityError):
    """A shadow-audited request's token stream diverged from the
    reference-oracle replay (``runtime.audit``): the serving backend
    returned wrong-but-finite values. The engine quarantines the backend
    down the fallback chain usable on its device and writes a replayable
    repro bundle."""


class RequestTimeoutError(ServingFault):
    """A supervised request exceeded its per-request timeout/deadline."""


class StepStallError(RequestTimeoutError):
    """A single engine decode step exceeded its watchdog deadline.

    Subclasses :class:`RequestTimeoutError` so the stall rides the
    retryable path: the batching engine routes it into restart-and-replay
    instead of letting a hung backend freeze the whole queue.
    """


class QueueFullError(ServingFault):
    """Admission refused: the engine's bounded request queue is full.

    Overload backpressure, not a server fault -- the caller sheds load or
    retries later (``submit(block=True, timeout=...)`` waits for a slot
    with a bound before raising this).
    """


class EngineClosedError(ServingFault):
    """A request reached an engine that is draining or stopped, or a
    stream was failed because the engine shut down before finishing it."""


class ReloadMismatchError(ServingFault):
    """A hot checkpoint swap was refused: the new param tree does not
    match the compiled plan (tree structure / leaf shape / dtype / packed
    weight-group counts). The engine keeps serving the old weights."""


# Message markers of foreign exceptions. XLA's and Mosaic's markers are
# the reference's; the port adds PyTorch's and CUDA's: the kernel build's
# failures (``kernels/_build.py``) are compile faults, and CUDA's sticky
# context errors are fatal -- after one, every later call on the device
# fails, so nothing may retry it.
_FATAL_MESSAGE_MARKERS = ("illegal memory access",
                          "unspecified launch failure",
                          "device-side assert", "misaligned address",
                          "illegal instruction")
_TRANSIENT_MESSAGE_MARKERS = ("transient", "preempt", "connection reset",
                              "unavailable", "deadline exceeded")
_COMPILE_MESSAGE_MARKERS = ("mosaic", "lowering", "compil", "pallas",
                            "unsupported primitive", "unimplemented",
                            "nvcc not found", "kernel build failed",
                            "no kernel image")
_RESOURCE_MESSAGE_MARKERS = ("resource_exhausted", "resource exhausted",
                             "out of memory", "vmem", "oom",
                             "allocation failure")

TRANSIENT, COMPILE, RESOURCE, SHAPE, FATAL = (
    "transient", "compile", "resource", "shape", "fatal")


def classify_error(exc: BaseException) -> str:
    """Map an exception from a backend op to a fault category.

    Returns one of ``transient | compile | resource | shape | fatal``.
    Typed errors classify by type (``torch.cuda.OutOfMemoryError`` is a
    resource fault); foreign exceptions by message markers. ``fatal``
    means "cause unknown" or a sticky CUDA context error: the guarded
    dispatcher still walks its chain (on the CPU the op may work on a
    simpler substrate; on the card the chain ends at the kernels and
    raises :class:`FallbackExhaustedError`), but a supervisor must not
    blind-retry it.
    """
    from repro_torch.runtime.supervisor import TransientWorkerError
    if isinstance(exc, (TransientWorkerError, BackendTransientError,
                        TimeoutError, ConnectionError)):
        return TRANSIENT
    if isinstance(exc, BackendCompileError):
        return COMPILE
    if isinstance(exc, (BackendResourceError, MemoryError,
                        torch.cuda.OutOfMemoryError)):
        return RESOURCE
    if isinstance(exc, BackendShapeError):
        return SHAPE
    msg = str(exc).lower()
    if any(m in msg for m in _FATAL_MESSAGE_MARKERS):
        return FATAL
    if any(m in msg for m in _TRANSIENT_MESSAGE_MARKERS):
        return TRANSIENT
    if any(m in msg for m in _RESOURCE_MESSAGE_MARKERS):
        return RESOURCE
    if any(m in msg for m in _COMPILE_MESSAGE_MARKERS):
        return COMPILE
    if isinstance(exc, (TypeError, ValueError, AssertionError)) and (
            "shape" in msg or "dim" in msg or "rank" in msg):
        return SHAPE
    return FATAL


# -- Numeric-integrity checks ----------------------------------------------

# int32 accumulates exactly up to 2^31 - 1; the f32 fast path up to 2^24.
_INT32_BITS = 31
_F32_MANTISSA_BITS = 24


def accum_magnitude_bits(k: int, a_bits: int, w_bits: int) -> int:
    """Bits needed for the worst-case |sum of k products| of signed
    ``a_bits`` x ``w_bits`` operands: ceil(log2(k * 2^(Pa-1) * 2^(Pw-1)))."""
    return (max(int(k), 1) - 1).bit_length() + (a_bits - 1) + (w_bits - 1)


def accum_fits_f32(k: int, a_bits: int, w_bits: int) -> bool:
    """The f32-mantissa predicate, recomputed from first principles (must
    agree with ``kernels.ops.conv_accum_fits_f32``)."""
    return max(int(k), 1) << (a_bits - 1 + w_bits - 1) <= 1 << _F32_MANTISSA_BITS


def check_accum_bound(k: int, a_bits: int, w_bits: int,
                      where: str = "") -> None:
    """Raise :class:`AccumulatorOverflowError` when the int32 accumulator
    of a k-deep (Pa, Pw) reduction can wrap. Called by the guarded
    backend with K derived from the actual operands, not from config."""
    need = accum_magnitude_bits(k, a_bits, w_bits)
    if need > _INT32_BITS:
        raise AccumulatorOverflowError(
            f"{where or 'reduction'}: K={k} at (Pa={a_bits}, Pw={w_bits}) "
            f"needs {need} accumulator bits > int32's {_INT32_BITS}; "
            f"the result would wrap silently -- refusing to dispatch")


def check_finite(x, where: str = "") -> None:
    """Raise :class:`NumericIntegrityError` if ``x`` holds NaN/Inf.

    Float tensors (or arrays) only. The reduction runs on the tensor's
    device and one bool crosses to the host: a ``[B, vocab]`` logits
    tensor never leaves the card. The value path is never modified.
    """
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if not x.is_floating_point():
        return
    finite = torch.isfinite(x)
    if not bool(finite.all()):
        n_bad = int(x.numel() - int(finite.sum()))
        raise NumericIntegrityError(
            f"{where or 'output'}: {n_bad}/{x.numel()} non-finite values "
            f"(NaN/Inf) -- refusing to serve a silent wrong answer")
