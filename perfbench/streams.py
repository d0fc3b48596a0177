"""The one general generator of the benchmark's traffic: seeded single-index
Criteo-layout batches, drawn as a traffic file's parameters say.

The draws are bench_torch.ZipfDataset's (bench_torch.py:182-217), copied so
that nothing here imports a root harness, with one repair: each table's ids
fall within that table's own row count (the original drew every table at the
first table's size, which holds only for its equal tables). For tables of
one size the two give the same batches from the same seed.

- ``loguniform``: ``exp(u ln n) - 1`` per table, Criteo's head concentration;
- ``uniform``: every id of the table alike, near-unique ids per window.

A stream draws a pool of ``pool_examples`` examples once, in set-up, and
serves it in order, so that no draw and no thread of the benchmark's
competes with the program's threads inside the window. Past the pool's end
it either serves the pool again from its start (``wrap``: for the
full-table trainer and for scoring, whose work does not depend on having
seen a batch before) or ends (a cached trainer's stream: repeated windows
would find their rows already in the cache, so a run that outpaces the pool
ends its window early instead). It is restartable (each ``batches()`` call serves
the same batches from the start, as the trainer's two readers of one stream
require) and ends where its :class:`Deadline` says: at the first batch index
that is a multiple of ``align`` once the deadline has passed, so that a
cached run ends on a lookahead window boundary.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

M_DEN = 13


class Batch(NamedTuple):
    """The program's batch layout: x [B, 13] float32, ls_i [T, B] int64,
    no mask (single index), y [B, 1] float32."""

    x: np.ndarray
    ls_i: np.ndarray
    ls_mask: Optional[np.ndarray]
    y: np.ndarray


class Deadline:
    """When the streams that share it stop: never, until ``start`` sets it."""

    def __init__(self):
        self.at: Optional[float] = None

    def start(self, seconds: float) -> float:
        now = time.perf_counter()
        self.at = now + seconds
        return now

    def passed(self) -> bool:
        return self.at is not None and time.perf_counter() >= self.at


def draw_ids(rng: np.random.Generator, ln_emb: np.ndarray, batch: int, ids: dict) -> np.ndarray:
    """One batch's [T, B] int64 ids, each table within its own row count."""
    kind = ids["kind"]
    num_tables = ln_emb.shape[0]
    rows = ln_emb[:, None]
    if kind == "uniform":
        return rng.integers(0, rows, size=(num_tables, batch))
    if kind == "loguniform":
        u = rng.random((num_tables, batch), dtype=np.float32)
        idx = np.exp(u * np.log(rows.astype(np.float64))).astype(np.int64) - 1
        np.minimum(idx, rows - 1, out=idx)
        return idx
    raise ValueError(f"unknown id distribution {kind!r}")


def stream_rng(seed: int, salt: int = 0) -> np.random.Generator:
    """The stream's generator: ZipfDataset's ``SFC64(seed)`` for the
    training stream (salt 0), an independent one for a held-out stream."""
    if salt == 0:
        return np.random.Generator(np.random.SFC64(seed))
    return np.random.Generator(np.random.SFC64(np.random.SeedSequence([seed, salt])))


def draw_batch(rng: np.random.Generator, ln_emb: np.ndarray, batch: int, ids: dict) -> Batch:
    """ZipfDataset's order of draws: dense features, ids, targets."""
    x = rng.random((batch, M_DEN), dtype=np.float32)
    idx = draw_ids(rng, ln_emb, batch, ids)
    y = np.round(rng.random((batch, 1), dtype=np.float32))
    return Batch(x, idx, None, y)


class Stream:
    """A dataset in the program's sense (``batches()``, ``len``, ``m_den``,
    ``ln_emb``) over one seeded stream: ``pool`` batches drawn at
    construction (``pool_examples`` examples, at least one batch), or
    ``limit`` batches where that is fewer; ``limit`` also caps the batches
    served; ``deadline``, ``align`` and ``wrap`` end the stream as the
    module says."""

    m_den = M_DEN

    def __init__(self, ln_emb: Sequence[int], batch: int, ids: dict, seed: int, *,
                 pool_examples: int, salt: int = 0, limit: Optional[int] = None,
                 deadline: Optional[Deadline] = None, align: int = 1, wrap: bool = True):
        self.ln_emb = np.asarray(ln_emb, dtype=np.int64)
        self.batch, self.ids, self.seed, self.salt = batch, ids, seed, salt
        self.limit = limit
        self.deadline = deadline if deadline is not None else Deadline()
        self.align = max(1, align)
        self.wrap = wrap
        n = max(1, int(pool_examples) // batch)
        if limit is not None:
            n = min(n, limit)
        rng = stream_rng(seed, salt)
        self.pool: List[Batch] = [draw_batch(rng, self.ln_emb, batch, ids) for _ in range(n)]

    def __len__(self) -> int:
        return self.limit if self.limit is not None else 1 << 40

    def head(self, n: int) -> List[Batch]:
        """The stream's first ``n`` batches."""
        return [self.pool[j % len(self.pool)] for j in range(n)]

    def batches(self, skip: int = 0):
        j = skip
        while self.limit is None or j < self.limit:
            if j % self.align == 0 and self.deadline.passed():
                return
            if not self.wrap and j >= len(self.pool):
                return
            yield self.pool[j % len(self.pool)]
            j += 1
