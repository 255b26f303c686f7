"""Deterministic, resumable, shardable synthetic data pipeline.

A copy of the reference's numpy-only ``repro/data/pipeline.py`` (the port
imports nothing of the JAX package): the same generator calls in the same
order, so both packages draw the same batches bit for bit. The batches
are numpy arrays; the train step puts them on its device.

  * **Stateless addressing**: batch(step) is a pure function of (seed,
    step, host_id, n_hosts), so a restart needs no data state beyond the
    step counter.
  * **Document packing**: documents of zipf-like token ids with EOS (0)
    boundaries packed into fixed-length rows, plus next-token labels.
  * **Host sharding**: ``host_shard_batch`` gives a host its contiguous
    block of the global batch's rows; ``rank_rows`` gives a data-parallel
    rank its rows of every accumulation microbatch (the rows a meshed
    train step takes).

A VLM's ``img_embeds`` are deterministic pseudo-embeddings keyed by the
same addressing, from the stream of row ``global_batch`` (the first row
index no token row uses), whose rows in order are the global batch's: a
draw of some rows takes those rows of it. The reference keys them by row
-1, which numpy 2's ``SeedSequence`` refuses (``ValueError``), so its
image batches cannot be drawn to compare with; the token rows are its
bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    n_img_tokens: int = 0          # VLM stub
    d_model: int = 0               # embedding dim for modality stubs


def _rng_for(cfg: DataConfig, step: int, row: int) -> np.random.Generator:
    # Stable per-(seed, step, row) stream: no sequential state anywhere.
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, row]))


def _packed_row(cfg: DataConfig, step: int, row: int) -> np.ndarray:
    """One packed row of documents: zipf-ish token ids, EOS=0 boundaries."""
    rng = _rng_for(cfg, step, row)
    out = np.empty(cfg.seq_len + 1, np.int32)
    pos = 0
    while pos < cfg.seq_len + 1:
        doc_len = int(rng.exponential(cfg.mean_doc_len)) + 1
        doc_len = min(doc_len, cfg.seq_len + 1 - pos)
        # Zipf-like marginal over the vocab (realistic token frequencies).
        toks = rng.zipf(1.3, size=doc_len) % (cfg.vocab - 1) + 1
        out[pos:pos + doc_len] = toks
        pos += doc_len
        if pos < cfg.seq_len + 1:
            out[pos] = 0           # EOS
            pos += 1
    return out


def synthetic_batch(cfg: DataConfig, step: int, rows=None) -> dict:
    """Materialize rows (default: all of the global batch) for ``step``,
    in the order given: each row is that row of the global batch."""
    rows = list(range(cfg.global_batch) if rows is None else rows)
    packed = np.stack([_packed_row(cfg, step, r) for r in rows])
    batch = {"tokens": packed[:, :-1], "labels": packed[:, 1:]}
    if cfg.n_img_tokens:
        # The stream fills its rows in order, so a draw of the first
        # max(rows) + 1 rows holds every row asked for.
        rng = _rng_for(cfg, step, cfg.global_batch)
        drawn = rng.standard_normal(
            (max(rows) + 1, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)
        batch["img_embeds"] = drawn[rows]
    return batch


def rank_rows(global_batch: int, accum: int = 1, n_ranks: int = 1,
              rank: int = 0) -> list[int]:
    """The global rows that data-parallel rank ``rank`` of ``n_ranks``
    trains on: for each of the ``accum`` microbatches (contiguous blocks
    of the global batch, in order) the rank's contiguous block of it. A
    batch that does not split into ``n_ranks`` x ``accum`` equal parts
    raises ``ValueError``."""
    if global_batch % (n_ranks * accum):
        raise ValueError(
            f"a batch of {global_batch} rows does not split into "
            f"{n_ranks} data rank(s) x {accum} equal microbatches")
    mb, per = global_batch // accum, global_batch // (accum * n_ranks)
    return [i * mb + rank * per + j for i in range(accum)
            for j in range(per)]


def host_shard_batch(cfg: DataConfig, step: int, host_id: int,
                     n_hosts: int) -> dict:
    """Only this host's rows — contiguous block layout."""
    per = cfg.global_batch // n_hosts
    rows = range(host_id * per, (host_id + 1) * per)
    return synthetic_batch(cfg, step, rows)


def make_iterator(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
                  n_hosts: int = 1):
    """Resumable iterator: yields (step, batch) from ``start_step``."""
    step = start_step
    while True:
        if n_hosts > 1:
            yield step, host_shard_batch(cfg, step, host_id, n_hosts)
        else:
            yield step, synthetic_batch(cfg, step)
        step += 1
