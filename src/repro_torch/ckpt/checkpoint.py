"""Checkpointing: atomic, durable, integrity-checked, in the reference's format.

PyTorch-port counterpart of ``repro/ckpt/checkpoint.py``, and its on-disk
format byte for byte, so each package restores the other's checkpoints.
Layout: ``<dir>/step_<n>/`` holding one ``.npy`` per tree leaf (the leaf's
path with ``/`` -> ``__``, paths as :func:`repro_torch.interop.
flatten_with_paths` gives them) + ``manifest.json`` (``step``, per-leaf
``dtype`` / ``stored`` dtype / ``shape`` / CRC32 of the stored bytes,
``compress``, ``meta``). bf16 and float8 leaves are stored as raw integers
of the same width (bf16 as uint16 with ``stored`` "bfloat16"), so no
reader needs ``ml_dtypes``. Writes go to ``step_<n>.tmp`` then
``os.rename``, with every leaf file, the manifest, the tmp directory and
the parent directory fsync'd around the rename -- a crash at ANY point
never shadows the previous good checkpoint with a torn one.

Integrity: restore verifies each leaf's CRC32 + shape + stored dtype
against the manifest and raises a typed :class:`CheckpointCorruptError` on
mismatch; :func:`restore_latest` (and the manager method) skips a corrupt
step with a one-line warning and falls back to the previous good
checkpoint -- only when EVERY checkpoint is corrupt does it fail, loudly.
The ``ckpt.leaf_corrupt`` / ``ckpt.crash_rename`` fault points
(``repro_torch.runtime.faults``) exercise both paths deterministically.

Leaves are saved from the host: a tensor on the card is copied to the
host first. Restored leaves are tensors on the ``device`` the caller
names, by default the device of ``like``'s tensors (the card where
``like`` holds none, or only meta tensors), as the reference restores
onto its default device. ``compress="bf16"`` stores float32 leaves as
bf16 (rounded to nearest even, as ``ml_dtypes`` rounds).

On a mesh (``shardings=``, a tree matching the state of
:class:`repro_torch.dist.sharding.NamedSharding`): a restore CRC-checks
each whole ``.npy`` on every rank, as unsharded, and keeps this rank's
slice; a save all-gathers the shards and rank 0 writes the whole leaves,
so the files are those of an unsharded save, byte for byte
(``CheckpointManager.save_async(..., shardings=)`` likewise, rank 0
writing in the background).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings

import numpy as np
import torch

from repro_torch import interop
from repro_torch.runtime import faults


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (CRC/shape/dtype/missing
    file). Typed so restore_latest can fall back to the previous step and
    supervisors can classify it as non-retryable."""


def _leaf_filename(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (directory entries need their own
    fsync for the rename to be durable across a crash)."""
    flags = os.O_RDONLY
    if os.path.isdir(path):
        flags |= getattr(os, "O_DIRECTORY", 0)
    fd = os.open(path, flags)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _corrupt_one_leaf(tmp: str) -> None:
    """ckpt.leaf_corrupt fault effect: flip a data byte of the first leaf
    (deterministic), AFTER its CRC was recorded -- restore must reject it."""
    leaf = sorted(f for f in os.listdir(tmp) if f.endswith(".npy"))[0]
    path = os.path.join(tmp, leaf)
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)          # last byte: array data, not header
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))


def save_checkpoint(ckpt_dir: str, step: int, state, *, compress: str = "none",
                    extra_meta: dict | None = None,
                    verify: bool = False, shardings=None) -> str | None:
    """Synchronous atomic + durable save of a tree of tensors (or numpy
    arrays). compress: "none" | "bf16".

    Every leaf file and the manifest are fsync'd, then the tmp directory,
    then (after the rename) the checkpoint directory -- a crash mid-save
    can only lose the new step, never tear it or the previous one.

    ``verify=True`` re-reads every leaf AFTER the atomic rename and
    CRC32-checks it against the manifest just written: a torn/partial
    write surfaces as a typed :class:`CheckpointCorruptError` at SAVE
    time, not at first restore.

    ``shardings``: ``state`` holds this rank's shards; every rank of the
    mesh calls, rank 0 writes the gathered leaves (and returns the path;
    the others return None once it is written).
    """
    if shardings is not None:
        return _save_sharded(ckpt_dir, step, state, shardings,
                             compress=compress, extra_meta=extra_meta,
                             verify=verify)
    if compress not in ("none", "bf16"):
        raise ValueError(f"compress must be 'none' or 'bf16', got "
                         f"{compress!r}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "compress": compress,
                "meta": extra_meta or {}}
    for key, leaf in interop.flatten_with_paths(state).items():
        t = interop.host_tensor(leaf)
        logical_dtype = interop.dtype_name(t.dtype)
        if compress == "bf16" and t.dtype == torch.float32:
            t = t.to(torch.bfloat16)
        stored_dtype = interop.dtype_name(t.dtype)
        arr = interop.host_array(t)
        with open(os.path.join(tmp, _leaf_filename(key)), "wb") as f:
            np.save(f, arr, allow_pickle=False)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"][key] = {"dtype": logical_dtype,
                                   "stored": stored_dtype,
                                   "shape": list(arr.shape),
                                   "crc32": interop.crc32(arr)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if faults.take("ckpt.leaf_corrupt"):
        _corrupt_one_leaf(tmp)
    _fsync_path(tmp)
    faults.fire("ckpt.crash_rename")     # chaos: die before the rename
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(ckpt_dir)
    if verify:
        _verify_saved(final, manifest)
    return final


def _verify_saved(path: str, manifest: dict) -> None:
    """Read-back verification: every leaf on disk must hash to the CRC32
    recorded in the manifest that was just written."""
    for key, meta in manifest["leaves"].items():
        try:
            arr = np.load(os.path.join(path, _leaf_filename(key)),
                          allow_pickle=False)
        except (OSError, ValueError) as exc:
            raise CheckpointCorruptError(
                f"save verify: leaf {key!r} unreadable after the atomic "
                f"rename ({exc})") from exc
        if interop.crc32(arr) != meta["crc32"]:
            raise CheckpointCorruptError(
                f"save verify: leaf {key!r} failed read-back CRC32 -- "
                f"torn/corrupt write caught at save time")


def _all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _gathered(state, shardings):
    """The whole leaves of a mesh's ``state`` (every rank calls)."""
    from repro_torch.dist import sharding
    shard_of = interop.flatten_with_paths(shardings)
    return interop.map_with_paths(
        lambda key, t: sharding.gather_leaf(t, shard_of[key].spec,
                                            shard_of[key].mesh), state)


def _save_sharded(ckpt_dir, step, state, shardings, **kw):
    import torch.distributed as dist
    whole = _gathered(state, shardings)
    path = save_checkpoint(ckpt_dir, step, whole, **kw) \
        if dist.get_rank() == 0 else None
    dist.barrier()
    return path


def _default_device(like):
    """The device of ``like``'s first tensor leaf that is not a meta
    tensor, else the card."""
    for leaf in interop.flatten_with_paths(like).values():
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
            return leaf.device
    return torch.device("cuda")


def latest_step(ckpt_dir: str) -> int | None:
    steps = _all_steps(ckpt_dir)
    return max(steps) if steps else None


def restore_latest(ckpt_dir: str, like, *, device=None, shardings=None):
    """Restore the newest checkpoint that passes integrity verification.

    A corrupt step (CRC/shape/dtype mismatch, torn files) is skipped with
    a one-line warning and the previous good step is restored instead.
    Returns ``(None, None)`` when the directory holds no checkpoints;
    raises :class:`CheckpointCorruptError` when every step is corrupt --
    restarting from scratch silently would be a silent wrong answer.
    """
    steps = _all_steps(ckpt_dir)
    if not steps:
        return None, None
    last_exc = None
    for step in reversed(steps):
        try:
            return restore_checkpoint(ckpt_dir, step, like, device=device,
                                      shardings=shardings)
        except CheckpointCorruptError as exc:
            warnings.warn(f"[ckpt] skipping corrupt checkpoint: {exc} -- "
                          f"falling back to the previous step",
                          RuntimeWarning, stacklevel=2)
            last_exc = exc
    raise CheckpointCorruptError(
        f"all {len(steps)} checkpoint(s) in {ckpt_dir!r} failed integrity "
        f"verification") from last_exc


def restore_checkpoint(ckpt_dir: str, step: int, like, *, device=None,
                       shardings=None):
    """Restore into the structure of ``like``: a tree whose leaves carry a
    ``shape`` and a ``dtype`` (tensors, meta tensors or numpy arrays;
    only the keys, shapes and dtypes are read). Returns ``(tree of
    tensors on device, step)``; ``device`` defaults to like's
    (:func:`_default_device`). ``shardings``: a matching tree of
    ``NamedSharding``; each leaf is then this rank's slice of it (``like``
    keeps the whole shapes).

    Integrity: each leaf's stored bytes are CRC32-verified (and its
    shape/stored-dtype cross-checked) against the manifest; any mismatch,
    unreadable manifest, or missing leaf file raises a typed
    :class:`CheckpointCorruptError` so callers can fall back to the
    previous good step instead of serving from corrupt state.
    """
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    device = _default_device(like) if device is None else device
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        raise CheckpointCorruptError(
            f"step {step}: unreadable manifest ({exc})") from exc
    shard_of = {} if shardings is None else \
        interop.flatten_with_paths(shardings)

    def restore(key, tgt):
        if key not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {key}")
        meta = manifest["leaves"][key]
        try:
            arr = np.load(os.path.join(path, _leaf_filename(key)),
                          allow_pickle=False)
        except (OSError, ValueError) as exc:
            raise CheckpointCorruptError(
                f"step {step}: leaf {key!r} unreadable ({exc})") from exc
        if "crc32" in meta and interop.crc32(arr) != meta["crc32"]:
            raise CheckpointCorruptError(
                f"step {step}: leaf {key!r} failed CRC32 verification "
                f"(bytes on disk differ from what was saved)")
        if list(arr.shape) != list(meta["shape"]):
            raise CheckpointCorruptError(
                f"step {step}: leaf {key!r} stored shape {list(arr.shape)} "
                f"!= manifest shape {meta['shape']}")
        stored = meta.get("stored", meta["dtype"])
        want = np.dtype(interop.EXT_STORAGE.get(stored, stored))
        if arr.dtype != want:
            raise CheckpointCorruptError(
                f"step {step}: leaf {key!r} stored dtype {arr.dtype} "
                f"!= manifest dtype {stored!r}")
        t = interop.from_host_array(arr, stored).to(
            interop.torch_dtype(meta["dtype"]))
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"{key}: ckpt shape {tuple(t.shape)} != "
                             f"{tuple(tgt.shape)} (restore requires the "
                             f"same logical shapes)")
        if key in shard_of:
            from repro_torch.dist import sharding
            ns = shard_of[key]
            t = sharding.shard_leaf(t, ns.spec, ns.mesh)
        return t.to(device=device, dtype=interop.torch_dtype(tgt.dtype))

    # Leaves in path order, as the reference reads them (a corrupt step
    # fails at its first bad leaf), then rebuilt in like's structure.
    restored = {key: restore(key, tgt)
                for key, tgt in interop.flatten_with_paths(like).items()}
    return (interop.map_with_paths(lambda key, _: restored[key], like),
            manifest["step"])


class CheckpointManager:
    """Periodic + async checkpointing with retention.

    save_async() snapshots to host on the caller thread, then writes on a
    background thread -- the caller is blocked only for the host copy,
    not the filesystem. keep_n retention prunes old steps.
    """

    def __init__(self, ckpt_dir: str, *, every: int = 100, keep_n: int = 3,
                 compress: str = "none", verify: bool = False):
        self.dir = ckpt_dir
        self.every = every
        self.keep_n = keep_n
        self.compress = compress
        self.verify = verify
        self._thread: threading.Thread | None = None
        self._async_exc: BaseException | None = None
        self._barrier = False
        os.makedirs(ckpt_dir, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def wait(self):
        """Join the in-flight async save; re-raise its exception if it
        failed -- a dropped save error would silently cost a checkpoint.
        After a sharded save every rank waits here until rank 0's write
        is done."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            import torch.distributed as dist
            self._barrier = False
            dist.barrier()
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise exc

    def save_async(self, step: int, state, shardings=None):
        """Snapshot ``state`` to the host and write it on a background
        thread. ``shardings`` (a mesh's train state, every rank calling):
        the shards are all-gathered here and rank 0 writes the whole
        leaves, the files of an unsharded save."""
        self.wait()
        if shardings is not None:
            import torch.distributed as dist
            state = _gathered(state, shardings)
            self._barrier = True
            if dist.get_rank() != 0:
                return
        host_state = interop.map_with_paths(
            lambda _, x: interop.host_tensor(x).clone(), state)

        def _write():
            try:
                save_checkpoint(self.dir, step, host_state,
                                compress=self.compress, verify=self.verify)
                self._prune()
            except BaseException as exc:  # surfaced on the next wait()
                self._async_exc = exc

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def _prune(self):
        for s in _all_steps(self.dir)[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like, *, device=None, shardings=None):
        """Newest VERIFIED checkpoint (corrupt steps are skipped with a
        warning; see module-level :func:`restore_latest`)."""
        self.wait()
        return restore_latest(self.dir, like, device=device,
                              shardings=shardings)
