"""Slot-paged KV cache pool for continuous batching.

PyTorch-port counterpart of ``repro/runtime/batching/kvpool.py``. One
device allocation for the whole engine lifetime:
``session.init_cache(max_batch, max_seq)`` -- every cache leaf carries the
batch axis at position 1 (leaves are stacked ``[n_groups, B, ...]`` by
``models.model.init_cache``: attention k, v and slot_pos, and k_scale and
v_scale on an int8 cache; a cross-attention layer's image k, v and
slot_pos; a mamba layer's conv history ``[G, B, d_conv - 1, d_inner]``
bf16 and state ``[G, B, H, head_dim, d_state]`` float32; the leaves are
walked in sorted key order, the same in the pool and in a row's cache).
A *slot* is one batch row of that allocation. Requests borrow a slot for
their lifetime; a retired slot goes straight back on the free list -- no
copy, no compaction -- because admission overwrites the ENTIRE row via
:meth:`scatter_prefill` (every leaf row is replaced from a fresh batch-1
prefill, ``slot_pos``, conv history and state included, so a stale
tenant never leaks into the next request: its attention slots sit masked
behind ``slot_pos`` and its recurrent state is overwritten).

Where the reference scatters with a donated jit, the port copies in
place: ``pool[:, slot].copy_(row[:, 0])`` for every leaf. A decode step
writes the pool in place too, so a fault in the middle of one leaves it
half written: the engine's restart frees every slot (:meth:`reset`) and
re-places each request, which rewrites its row whole. Only after a stall,
whose abandoned call may still write this pool, does the engine allocate
a new one.
"""
from __future__ import annotations

_BATCH_AXIS = 1  # cache leaves are [n_groups, B, ...]


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


class KVPool:
    """Slot allocator over one pre-allocated batched cache."""

    def __init__(self, session, max_batch: int, max_seq: int | None = None):
        self.max_batch = int(max_batch)
        self.max_seq = int(max_seq or session.cfg.max_seq)
        self.cache = session.init_cache(self.max_batch, self.max_seq)
        # lowest-index-first keeps slot assignment deterministic, which
        # keeps engine runs reproducible (and replayable after a restart)
        self._free = list(range(self.max_batch))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int | None:
        """Borrow the lowest free slot; None when the pool is full."""
        if not self._free:
            return None
        return self._free.pop(0)

    def free(self, slot: int) -> None:
        if not (0 <= slot < self.max_batch):
            raise ValueError(f"slot {slot} out of range 0..{self.max_batch-1}")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        # keep sorted for lowest-first determinism
        self._free.append(slot)
        self._free.sort()

    def reset(self) -> None:
        """Free every slot (the engine's restart); the rows keep their
        stale contents until :meth:`scatter_prefill` rewrites them."""
        self._free = list(range(self.max_batch))

    def scatter_prefill(self, slot: int, row_cache) -> None:
        """Write a batch-1 prefilled cache into ``slot`` (all leaves), in
        place."""
        for pool_leaf, row_leaf in zip(_leaves(self.cache),
                                       _leaves(row_cache), strict=True):
            pool_leaf.select(_BATCH_AXIS, slot).copy_(
                row_leaf.select(_BATCH_AXIS, 0))
