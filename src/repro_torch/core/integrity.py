"""Content fingerprints for serving weights: detect silent in-memory corruption.

PyTorch-port counterpart of ``repro/core/integrity.py``. Every byte-identity
contract of the serving stack (guarded == unguarded, batched == solo)
assumes the packed weight planes a session was compiled with are the
planes it is still serving. This module checks that (the *storage* half
of the silent fault model; the *compute* half is
``repro_torch.runtime.audit``):

  * :func:`fingerprint_session` -- CRC32 per param-tree leaf plus the
    plan's pack-time weight-group count metadata, computed ONCE at
    ``repro_torch.compile`` / ``BatchingEngine.reload``. Each leaf is
    hashed on the host, as the reference hashes it (a leaf on the card is
    copied over first), so the port's CRCs and :meth:`WeightFingerprint.
    digest` equal the reference's for the same tree. Several leaves are
    copied and hashed at once (:data:`HASH_THREADS`).
  * :func:`verify_params` / :func:`verify_plan_counts` -- re-hash and
    compare; any mismatch raises a typed
    :class:`~repro_torch.api.guards.WeightIntegrityError` naming the leaf.
    ``verify_plan_counts`` also re-checks the pass-law metadata: every
    recorded per-filter-group plane count must sit in ``[1, w_bits]`` and
    match the fingerprint.
  * :func:`flip_one_bit` -- the ``weights.bitflip`` fault effect: a copy
    of the tree with exactly one bit flipped in the first packed plane
    (deterministic), so chaos tests can prove detection + heal.

The check never touches the value path: it reads, hashes, compares.
Detection rides the engine's step cadence (``integrity_every``); healing
rides the CRC-verified ``reload_checkpoint`` path.
"""
from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch import interop
from repro_torch.api import guards


# Leaves hashed at once: a leaf's copy from the card and zlib's CRC32
# both release the GIL, so a tree of many leaves hashes on as many host
# cores (one copy of each leaf in flight on the host).
HASH_THREADS = min(8, os.cpu_count() or 1)


def _leaf_crc(leaf) -> tuple[int, tuple, str]:
    arr = interop.host_array(interop.host_tensor(leaf))
    return (interop.crc32(arr), tuple(leaf.shape),
            interop.dtype_name(leaf.dtype))


def _leaf_crcs(leaves: dict) -> dict:
    """{path: (crc32, shape, dtype name)} of a flattened tree's leaves,
    HASH_THREADS at a time."""
    with ThreadPoolExecutor(max(1, min(HASH_THREADS, len(leaves)))) as pool:
        return dict(zip(leaves, pool.map(_leaf_crc, leaves.values())))


@dataclasses.dataclass(frozen=True)
class WeightFingerprint:
    """Immutable content identity of a compiled session's weights.

    ``leaves``: leaf path -> (crc32, shape, dtype name) over the FULL
    param tree (packed planes, scales, embeddings -- a flip anywhere
    serves wrong tokens). ``group_counts``: (layer name, kind) -> the
    plan's pack-time per-filter-group plane counts (tuples of Python
    ints). ``w_bits``: the policy weight width bounding every count.
    """

    leaves: dict
    group_counts: dict
    w_bits: int

    def digest(self) -> str:
        """Short stable hex id of the whole fingerprint (repro bundles)."""
        acc = 0
        for key in sorted(self.leaves):
            crc, _, _ = self.leaves[key]
            acc = zlib.crc32(f"{key}:{crc}".encode(), acc)
        for key in sorted(self.group_counts):
            acc = zlib.crc32(f"{key}:{self.group_counts[key]}".encode(), acc)
        return f"{acc:08x}"


def _plan_counts(plan) -> dict:
    return {(name, kind): lp.w_group_counts
            for (name, kind), lp in plan.layers.items()
            if lp.w_group_counts}


def fingerprint_session(params, plan) -> WeightFingerprint:
    """Fingerprint ``params`` + the plan's recorded weight-group counts."""
    leaves = _leaf_crcs(interop.flatten_with_paths(params))
    w_bits = max((lp.precision.w_bits for lp in plan.layers.values()),
                 default=8)
    return WeightFingerprint(leaves=leaves, group_counts=_plan_counts(plan),
                             w_bits=int(w_bits))


def verify_params(params, fp: WeightFingerprint, where: str = "") -> int:
    """Re-hash every leaf against ``fp``; raise a typed
    :class:`~repro_torch.api.guards.WeightIntegrityError` naming the first
    mismatching leaf. Returns the number of leaves verified."""
    current = interop.flatten_with_paths(params)
    if sorted(current) != sorted(fp.leaves):
        raise guards.WeightIntegrityError(
            f"{where or 'params'}: tree structure changed since "
            f"fingerprinting ({len(current)} leaves vs {len(fp.leaves)}) "
            f"-- serving weights are not the compiled weights")
    crcs = _leaf_crcs(current)
    for key in sorted(current):
        crc, shape, dtype = crcs[key]
        want_crc, want_shape, want_dtype = fp.leaves[key]
        if (shape, dtype) != (want_shape, want_dtype):
            raise guards.WeightIntegrityError(
                f"{where or 'params'}: leaf {key!r} is {dtype}{shape} but "
                f"was fingerprinted as {want_dtype}{want_shape}")
        if crc != want_crc:
            raise guards.WeightIntegrityError(
                f"{where or 'params'}: leaf {key!r} failed CRC32 "
                f"verification (crc {crc:#010x} != fingerprint "
                f"{want_crc:#010x}) -- in-memory weights are corrupt; "
                f"refusing to serve them silently")
    return len(current)


def verify_plan_counts(plan, fp: WeightFingerprint, where: str = "") -> None:
    """Pass-law metadata check: the plan's weight-group counts must match
    the fingerprint and every count must sit in ``[1, w_bits]``."""
    current = _plan_counts(plan)
    if current != fp.group_counts:
        raise guards.WeightIntegrityError(
            f"{where or 'plan'}: weight-group counts drifted from the "
            f"compile-time fingerprint ({current} != {fp.group_counts}) "
            f"-- the plan would execute wrong plane partitions")
    for (name, kind), counts in current.items():
        bad = [c for c in counts if not 1 <= int(c) <= fp.w_bits]
        if bad:
            raise guards.WeightIntegrityError(
                f"{where or 'plan'}: layer {name!r} ({kind}) has plane "
                f"counts {bad} outside [1, {fp.w_bits}] -- corrupt "
                f"pass-law metadata")


def flip_one_bit(params, leaf: str | None = None):
    """``weights.bitflip`` fault effect: XOR one bit of one leaf.

    Deterministic: flips bit 0 of byte 0 of ``leaf`` (default: the first
    packed-plane leaf by sorted path, falling back to the first leaf).
    Returns ``(corrupted_tree, leaf_key)``; the input tree is untouched:
    the flipped leaf is a copy on its device (the caller swaps the tree
    in), every other leaf is shared.
    """
    keys = sorted(interop.flatten_with_paths(params))
    if leaf is None:
        packed = [k for k in keys if "w_packed" in k]
        leaf = packed[0] if packed else keys[0]
    if leaf not in keys:
        raise KeyError(f"no leaf {leaf!r}; have {keys}")

    def flip(key, t: torch.Tensor):
        if key != leaf:
            return t
        t = t.clone().contiguous()
        t.reshape(-1).view(torch.uint8)[0] ^= 0x01
        return t

    return interop.map_with_paths(flip, params), leaf
