"""Backend registry: one object per kernel substrate, one uniform op surface.

PyTorch-port counterpart of ``repro/api/backend.py``. Model code asks its
:class:`~repro_torch.api.plan.LayerPlan` for the backend and calls one of
six ops:

    matmul_planes          static bit-serial matmul over packed planes
    matmul_planes_dynamic  plane-count-gated variant (runtime trimming)
    conv_planes            fused bit-serial convolution
    conv_planes_dynamic    conv with runtime activation-plane trimming
    dynamic_quant          per-group activation quantization
    attention              full-sequence attention

Built-ins:

    torch_ref   the plain PyTorch oracles, on any device
    cuda        the hand-written Hopper kernels (K1-K7); on CPU tensors
                their wrappers take the plain versions. The default.

Pack-time weight-group counts (``w_counts``, Python ints from the plan)
that are all full keep the static kernels (K1, K2); a count below Pw
routes ``matmul_planes`` to K3 with bn = the filter group and
``conv_planes`` to K4. ``dynamic_quant`` runs K6 and ``attention`` K7.

:class:`GuardedBackend` (``compile(..., guarded=True)``) wraps either one
with typed fault classification, numeric-integrity prechecks and a
sticky per-op fallback chain ``cuda -> torch_ref``.
"""
from __future__ import annotations

import functools
import warnings

import torch

from repro_torch.api import guards
from repro_torch.core import bitpack, quantize as q
from repro_torch.core.weightgroups import truncate_columns_grouped
from repro_torch.kernels import ref
from repro_torch.kernels.bitserial_conv import (bitserial_conv,
                                                bitserial_conv_dynamic,
                                                bitserial_conv_wgroup)
from repro_torch.kernels.bitserial_matmul import (bitserial_matmul,
                                                  bitserial_matmul_dynamic)
from repro_torch.kernels.dynamic_quant import dynamic_quant
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.runtime import tracing


def _trims(w_counts, w_bits: int) -> bool:
    """The all-full-counts guard: only a count below Pw trims anything;
    otherwise the static kernels run."""
    return w_counts is not None and any(c < w_bits for c in w_counts)


@functools.cache
def _counts_tensor(counts: tuple, device: torch.device) -> torch.Tensor:
    """Plan-constant plane counts as int32 on ``device``, made once."""
    return torch.tensor(counts, dtype=torch.int32, device=device)


def dense_weights(w_packed, w_bits: int, w_counts=None, w_group: int = 16):
    """The dense operand of the dynamic ops: the packed weights unpacked to
    int32 [K8, N] and, where a pack-time count lies below Pw, truncated per
    filter group at its count (value-preserving for OR-tree counts; full
    counts truncate nothing)."""
    with tracing.span("trim.dense_weights"):
        wq = bitpack.unpack_weights(w_packed, w_bits)
        if _trims(w_counts, w_bits):
            wq = truncate_columns_grouped(
                wq, _counts_tensor(tuple(w_counts), wq.device), w_group)
        return wq


def sum_int8_subplanes(wq, w_bits: int, run):
    """``run`` over Pw-bit weights ``wq`` as an int8 kernel operand:
    ``run(wq)`` for Pw <= 8, else the sum of ``2^(7p) * run(plane_p)``
    over ceil(Pw/7) 7-bit subplanes (an unsigned 8-bit low plane would not
    fit int8). Exact for a ``run`` linear in its weights, in wrap-around
    int32 as the reference accumulates."""
    if w_bits <= 8:
        return run(wq.to(torch.int8))
    planes, _ = q.group_planes(wq, w_bits, 7)
    y = run(planes[0].to(torch.int8))
    for p in range(1, planes.shape[0]):
        y = y + run(planes[p].to(torch.int8)) * (1 << (7 * p))
    return y


class Backend:
    """The ``torch_ref`` backend: plain PyTorch, any device. Also the base
    class of the kernel backends."""

    name = "torch_ref"

    def matmul_planes(self, xq, w_packed, *, w_bits: int, w_counts=None,
                      w_group: int = 16):
        """int8 [M, K] @ packed uint8 [Pw, K//8, N] -> exact int32 [M, N].
        ``w_counts``: pack-time plane counts per group of ``w_group``
        columns."""
        if not _trims(w_counts, w_bits):
            return ref.bitserial_matmul_ref(xq, w_packed, w_bits)
        return ref.bitserial_matmul_wgroup_ref(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device), w_bits,
            w_group)

    def matmul_planes_dynamic(self, xq, w_packed, plane_counts, *,
                              w_bits: int, bn: int):
        """Like matmul_planes, but column group j (``bn`` columns) uses only
        plane_counts[j] planes (int32 tensor on xq's device)."""
        return ref.bitserial_matmul_dynamic_ref(xq, w_packed, plane_counts,
                                                w_bits, bn)

    def conv_planes(self, xq, w_packed, *, kernel: int, stride: int,
                    w_bits: int, conv_tile: int | None = None,
                    w_counts=None, w_group: int = 16):
        """Fused bit-serial "same" conv: int8 [B,H,W,C] x packed planes ->
        exact int32 [B, Ho, Wo, N]. ``conv_tile`` (rows per band) only
        matters to the kernels."""
        if not _trims(w_counts, w_bits):
            return ref.bitserial_conv_ref(xq, w_packed, kernel=kernel,
                                          stride=stride, w_bits=w_bits)
        return ref.bitserial_conv_wgroup_ref(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device),
            kernel=kernel, stride=stride, w_bits=w_bits, w_group=w_group)

    def conv_planes_dynamic(self, xq, w_packed, counts, *, kernel: int,
                            stride: int, w_bits: int, group_size: int,
                            conv_tile: int | None = None, w_counts=None,
                            w_group: int = 16):
        """Like conv_planes, but window group g of image b (``group_size``
        row-major output windows) uses only counts[b, g] activation planes
        (int32 [B, G] on xq's device). ``w_counts`` composes static
        weight-group trimming in by truncating the dense weights."""
        return ref.conv_dynamic_dense_ref(
            xq, dense_weights(w_packed, w_bits, w_counts, w_group), counts,
            kernel=kernel, stride=stride, group_size=group_size)

    def dynamic_quant(self, x2, *, group_size: int, bits: int):
        """f32 [M, K] -> (xq int8 [M, K], scale f32 [M, G], eff_bits int32
        [M, G]) per group of ``group_size`` along K."""
        return ref.dynamic_quant_ref(x2, group_size, bits)

    def attention(self, q_, k_, v_, *, causal: bool = True,
                  window: int | None = None):
        """Full-sequence attention over [B, H, S, D] (KV head-repeated)."""
        return ref.flash_attention_ref(q_, k_, v_, causal=causal,
                                       window=window)


class CudaBackend(Backend):
    """The hand-written Hopper kernels: K1 ``bitserial_matmul``, K2
    ``bitserial_conv``, K3 ``bitserial_matmul_dynamic``, K4
    ``bitserial_conv_wgroup``, K5 ``bitserial_conv_dynamic``, K6
    ``dynamic_quant`` and K7 ``flash_attention``."""

    name = "cuda"

    def matmul_planes(self, xq, w_packed, *, w_bits, w_counts=None,
                      w_group=16):
        if not _trims(w_counts, w_bits):
            return bitserial_matmul(xq, w_packed, w_bits=w_bits)
        return bitserial_matmul_dynamic(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device),
            w_bits=w_bits, bn=w_group)

    def matmul_planes_dynamic(self, xq, w_packed, plane_counts, *, w_bits,
                              bn):
        return bitserial_matmul_dynamic(xq, w_packed, plane_counts,
                                        w_bits=w_bits, bn=bn)

    def conv_planes(self, xq, w_packed, *, kernel, stride, w_bits,
                    conv_tile=None, w_counts=None, w_group=16):
        if not _trims(w_counts, w_bits):
            return bitserial_conv(xq, w_packed, kernel=kernel, stride=stride,
                                  w_bits=w_bits, rows_per_band=conv_tile)
        return bitserial_conv_wgroup(
            xq, w_packed, _counts_tensor(tuple(w_counts), xq.device),
            kernel=kernel, stride=stride, w_bits=w_bits, w_group=w_group,
            rows_per_band=conv_tile)

    def conv_planes_dynamic(self, xq, w_packed, counts, *, kernel, stride,
                            w_bits, group_size, conv_tile=None, w_counts=None,
                            w_group=16):
        # K5 takes int8 weights: Pw > 8 runs once per 7-bit subplane.
        return sum_int8_subplanes(
            dense_weights(w_packed, w_bits, w_counts, w_group), w_bits,
            lambda plane: bitserial_conv_dynamic(
                xq, plane, counts, kernel=kernel, stride=stride,
                group_size=group_size, rows_per_band=conv_tile))

    def dynamic_quant(self, x2, *, group_size, bits):
        return dynamic_quant(x2, group_size=group_size, bits=bits)

    def attention(self, q_, k_, v_, *, causal=True, window=None):
        return flash_attention(q_, k_, v_, causal=causal, window=window)


# -- Guarded dispatch -------------------------------------------------------

# Degradation order: the kernels first, the plain PyTorch oracles last. A
# GuardedBackend's chain is the suffix of this list after its inner
# backend (an out-of-tree inner falls straight to the built-ins). Every
# member runs on the operands' device: a fallback never moves a tensor.
# The plain version (``_PLAIN``) is a step of the chain on the CPU only.
DEFAULT_FALLBACK_CHAIN = ("cuda", "torch_ref")
_PLAIN = "torch_ref"

# The uniform op surface a Backend exposes (= what a GuardedBackend guards).
BACKEND_OPS = ("matmul_planes", "matmul_planes_dynamic", "conv_planes",
               "conv_planes_dynamic", "dynamic_quant", "attention")


def _silent_corrupt(out):
    """``backend.silent_corrupt`` fault effect: wrong-but-finite values.

    Reverses the last axis of the op's (primary) output: shape- and
    dtype-preserving, deterministic, raising nothing and making no
    NaN/Inf -- the corruption every loud guard is blind to."""
    if isinstance(out, tuple):
        return (torch.flip(out[0], dims=(-1,)),) + tuple(out[1:])
    return torch.flip(out, dims=(-1,))


class GuardedBackend(Backend):
    """Fault-classifying wrapper: fallback chain + numeric-integrity guards.

    Wraps any registered backend. Every op dispatch:

    1. runs the *numeric-integrity prechecks* -- operand-shape coherence
       against the packed layout and the accumulator-overflow bound
       recomputed from the ACTUAL (Pa, Pw, K) of the operands (typed
       :class:`~repro_torch.api.guards.AccumulatorOverflowError` /
       ``BackendShapeError``; these fail loudly rather than fall back,
       because every chain member shares the same int32 accumulator);
    2. fires the ``backend.op`` fault point (chaos testing);
    3. delegates to the innermost non-failed backend in the chain. A
       non-transient failure (compile / resource / shape / unknown, per
       :func:`~repro_torch.api.guards.classify_error`) degrades the op to
       the next chain member with a one-line warning, and the op STAYS
       fallen back (sticky per op, recorded in ``fallbacks_by_op`` and
       read through the owning plan's ``fallback_report()``). Transient
       failures re-raise unchanged: the serving supervisor owns the
       retry, and the substrate is not the problem.

    On the card the chain ends before ``torch_ref``: a kernel that fails
    on CUDA tensors raises (:class:`~repro_torch.api.guards.
    BackendCompileError` for a failed build,
    :class:`~repro_torch.api.guards.BackendResourceError` for device
    memory, :class:`~repro_torch.api.guards.FallbackExhaustedError`
    otherwise) and is never replaced by its plain version there. The
    ``torch_ref`` step serves CPU tensors only, or a session that asked
    for ``torch_ref`` itself.

    The port's ops take no activation precision (the int8 kernel ABI
    caps it at 8), so the accumulator bound is taken at ``a_bits`` = 8
    unless a caller passes one.

    :meth:`quarantine` demotes every op one step at once (the shadow
    auditor's response to a silent divergence), along the same chain.

    Bit-transparency contract: on the fault-free path every op returns
    the inner backend's tensors unchanged -- guarded serving is
    byte-identical to unguarded serving.
    """

    def __init__(self, inner):
        inner = resolve_backend(inner)
        self.inner = inner
        self.name = f"guarded:{inner.name}"
        names = list(DEFAULT_FALLBACK_CHAIN)
        if inner.name in names:
            names = names[names.index(inner.name) + 1:]
        self.chain: list[Backend] = [inner] + [
            b for b in map(resolve_backend, names) if b is not inner]
        self.fallbacks_by_op: dict[str, str] = {}   # op -> serving backend
        self._active_idx: dict[str, int] = {}

    def __repr__(self):
        return (f"<GuardedBackend {self.inner.name} "
                f"chain={[b.name for b in self.chain[1:]]} "
                f"fallbacks={self.fallbacks_by_op}>")

    def active_backend(self, op: str) -> Backend:
        """The chain member currently serving ``op``."""
        return self.chain[self._active_idx.get(op, 0)]

    def _usable_chain(self, where) -> list[Backend]:
        """The chain members that may serve an op on the device of
        ``where`` (an operand, or a ``torch.device``): on the card, the
        chain ends before the plain version (a prefix, so the sticky
        indices hold on either device)."""
        on_card = where.type == "cuda" if isinstance(where, torch.device) \
            else where.is_cuda
        plain = [i for i, b in enumerate(self.chain) if i and b.name == _PLAIN]
        if on_card and plain:
            return self.chain[:plain[0]]
        return self.chain

    def quarantine(self, reason: str = "", *, device) -> int:
        """Sticky-demote EVERY op one member down the chain usable on
        ``device`` (the shadow auditor's response to a silent divergence:
        the active backend returned wrong-but-finite values, so no single
        op can be trusted and no error classification exists to react
        to). Reuses the same per-op sticky state as fault-driven
        fallback -- ``fallback_report()`` shows the quarantine. Returns the
        number of ops demoted: 0 once the chain is exhausted, and always
        on the card, where the chain ends at the kernels (the plain
        version never takes over serving there)."""
        chain = self._usable_chain(torch.device(device))
        n = 0
        for op in BACKEND_OPS:
            i = self._active_idx.get(op, 0)
            if i + 1 < len(chain):
                self._active_idx[op] = i + 1
                self.fallbacks_by_op[op] = chain[i + 1].name
                n += 1
        if n:
            warnings.warn(
                f"[guarded] QUARANTINE: {self.chain[0].name!r} demoted for "
                f"all ops ({reason or 'silent divergence'}) -- serving "
                f"continues on the fallback chain (sticky)",
                RuntimeWarning, stacklevel=3)
        return n

    def _dispatch(self, op: str, *args, **kwargs):
        from repro_torch.runtime import faults
        chain = self._usable_chain(args[0])
        start = self._active_idx.get(op, 0)
        last_exc = None
        for i in range(start, len(chain)):
            b = chain[i]
            try:
                faults.fire("backend.op", detail=f"{op}:{b.name}")
                out = getattr(b, op)(*args, **kwargs)
                if faults.take("backend.silent_corrupt",
                               detail=f"{op}:{b.name}"):
                    out = _silent_corrupt(out)
                return out
            except Exception as exc:  # noqa: BLE001 -- classified below
                kind = guards.classify_error(exc)
                if kind == guards.TRANSIENT:
                    raise   # substrate is fine; the supervisor retries
                last_exc = exc
                if i + 1 < len(chain):
                    nxt = chain[i + 1]
                    warnings.warn(
                        f"[guarded] {op}: backend {b.name!r} failed "
                        f"({kind}: {exc}) -- falling back to {nxt.name!r} "
                        f"(sticky)", RuntimeWarning, stacklevel=3)
                    self._active_idx[op] = i + 1
                    self.fallbacks_by_op[op] = nxt.name
        names = [b.name for b in chain]
        if len(chain) < len(self.chain):
            kind = guards.classify_error(last_exc)
            typed = {guards.COMPILE: guards.BackendCompileError,
                     guards.RESOURCE: guards.BackendResourceError}.get(
                         kind, guards.FallbackExhaustedError)
            raise typed(
                f"{op}: {names} failed on CUDA tensors ({kind}: "
                f"{last_exc}); the plain version does not stand in for a "
                f"kernel on the card") from last_exc
        raise guards.FallbackExhaustedError(
            f"{op}: every backend in the fallback chain {names} "
            f"failed") from last_exc

    @staticmethod
    def _check_packed_k(k_logical: int, w_packed, op: str) -> int:
        """Packed-layout coherence: the packed K dim must be the logical
        reduction length rounded up to the 8-row pack quantum."""
        k8 = int(w_packed.shape[1]) * 8
        if not 0 <= k8 - k_logical < 8:
            raise guards.BackendShapeError(
                f"{op}: packed operand covers K={k8} but the logical "
                f"reduction length is {k_logical} (pad quantum is 8 rows) "
                f"-- operands are incoherent")
        return k8

    @staticmethod
    def _check_w_counts(w_counts, w_group: int, n: int, w_bits: int,
                        op: str) -> None:
        """Pass-law precheck on the static weight-group counts (Python
        ints from the plan): one count per group of ``w_group`` output
        columns, every count in [1, w_bits]. A violation means corrupt
        plan metadata -- the dispatch would execute the wrong plane
        partitions, silently."""
        if w_counts is None:
            return
        want = -(-n // w_group)
        if len(w_counts) != want:
            raise guards.BackendShapeError(
                f"{op}: {len(w_counts)} weight-group counts for N={n} at "
                f"w_group={w_group} (pass law needs {want} groups) -- "
                f"operands and plan metadata are incoherent")
        bad = sorted({int(c) for c in w_counts if not 1 <= int(c) <= w_bits})
        if bad:
            raise guards.WeightIntegrityError(
                f"{op}: weight-group plane counts {bad} outside "
                f"[1, {w_bits}] -- corrupt pass-law metadata; refusing to "
                f"dispatch wrong plane partitions")

    @staticmethod
    def _check_plane_counts(counts: torch.Tensor, bits: int,
                            op: str) -> None:
        """Bounds check on runtime (OR-tree) plane counts, reduced on
        their device: two scalars cross to the host."""
        if counts.numel() == 0:
            return
        lo, hi = int(counts.min()), int(counts.max())
        if lo < 1 or hi > bits:
            raise guards.WeightIntegrityError(
                f"{op}: runtime plane counts span [{lo}, {hi}] outside the "
                f"legal [1, {bits}] -- the OR-tree output is corrupt")

    # -- guarded op surface -------------------------------------------------

    def matmul_planes(self, xq, w_packed, *, w_bits, a_bits=8, w_counts=None,
                      w_group=16):
        k8 = self._check_packed_k(int(xq.shape[-1]), w_packed,
                                  "matmul_planes")
        guards.check_accum_bound(k8, a_bits, w_bits, "matmul_planes")
        self._check_w_counts(w_counts, w_group, int(w_packed.shape[-1]),
                             w_bits, "matmul_planes")
        return self._dispatch("matmul_planes", xq, w_packed, w_bits=w_bits,
                              w_counts=w_counts, w_group=w_group)

    def matmul_planes_dynamic(self, xq, w_packed, plane_counts, *, w_bits,
                              bn):
        # The dense operand rides int8 (<= 8 magnitude bits) on every
        # caller; the packed operand carries w_bits planes.
        k8 = self._check_packed_k(int(xq.shape[-1]), w_packed,
                                  "matmul_planes_dynamic")
        guards.check_accum_bound(k8, 8, w_bits, "matmul_planes_dynamic")
        self._check_plane_counts(plane_counts, w_bits,
                                 "matmul_planes_dynamic")
        return self._dispatch("matmul_planes_dynamic", xq, w_packed,
                              plane_counts, w_bits=w_bits, bn=bn)

    def conv_planes(self, xq, w_packed, *, kernel, stride, w_bits, a_bits=8,
                    conv_tile=None, w_counts=None, w_group=16):
        kkc = kernel * kernel * int(xq.shape[-1])
        self._check_packed_k(kkc, w_packed, "conv_planes")
        guards.check_accum_bound(kkc, a_bits, w_bits, "conv_planes")
        self._check_w_counts(w_counts, w_group, int(w_packed.shape[-1]),
                             w_bits, "conv_planes")
        return self._dispatch("conv_planes", xq, w_packed, kernel=kernel,
                              stride=stride, w_bits=w_bits,
                              conv_tile=conv_tile, w_counts=w_counts,
                              w_group=w_group)

    def conv_planes_dynamic(self, xq, w_packed, counts, *, kernel, stride,
                            w_bits, group_size, a_bits=8, conv_tile=None,
                            w_counts=None, w_group=16):
        kkc = kernel * kernel * int(xq.shape[-1])
        self._check_packed_k(kkc, w_packed, "conv_planes_dynamic")
        guards.check_accum_bound(kkc, a_bits, w_bits, "conv_planes_dynamic")
        self._check_w_counts(w_counts, w_group, int(w_packed.shape[-1]),
                             w_bits, "conv_planes_dynamic")
        self._check_plane_counts(counts, a_bits, "conv_planes_dynamic")
        return self._dispatch("conv_planes_dynamic", xq, w_packed, counts,
                              kernel=kernel, stride=stride, w_bits=w_bits,
                              group_size=group_size, conv_tile=conv_tile,
                              w_counts=w_counts, w_group=w_group)

    def dynamic_quant(self, x2, *, group_size, bits):
        # A NaN/Inf activation quantizes to garbage silently; reject it
        # here (the value path is untouched either way).
        guards.check_finite(x2, "dynamic_quant input")
        return self._dispatch("dynamic_quant", x2, group_size=group_size,
                              bits=bits)

    def attention(self, q_, k_, v_, *, causal=True, window=None):
        return self._dispatch("attention", q_, k_, v_, causal=causal,
                              window=window)


def guard_backend(backend) -> GuardedBackend:
    """Wrap ``backend`` (object or registered name) in a GuardedBackend.

    Idempotent: an already-guarded backend is returned unchanged."""
    if isinstance(backend, GuardedBackend):
        return backend
    return GuardedBackend(backend)


_REGISTRY: dict[str, Backend] = {}


def list_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def register_backend(name: str, backend: Backend) -> Backend:
    """Register (or replace) a backend under ``name``."""
    _REGISTRY[name] = backend
    return backend


def resolve_backend(backend=None) -> Backend:
    """A Backend object from a Backend, a registered name, or None (the
    ``cuda`` built-in)."""
    if isinstance(backend, Backend):
        return backend
    if backend is None:
        backend = "cuda"
    if not isinstance(backend, str):
        raise TypeError(f"backend must be a Backend or name, got {backend!r}")
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise KeyError(f"unknown backend {backend!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


register_backend("torch_ref", Backend())
register_backend("cuda", CudaBackend())
