"""Cache geometry: per-table set-associative layout in one concatenated
row space.

Reference geometry (model_no_ddp.py:101-147): per table,
``sets = next_prime(cache_size)`` capped at the table's row count
(tables smaller than the cache are fully resident — every index owns its own
set), ``ways`` ways, plus an aux region of ``aux_capacity`` rows that serves
per-batch misses. Row layout within a table's cache (matching the reference's
``way * sets + set`` indexing, model_no_ddp.py:174):

    [way0: sets rows][way1: sets rows]...[way(W-1)][aux: aux_capacity rows]

All tables share the embedding dim, so the per-table caches are concatenated
into ONE device array of ``total_rows + 1`` rows (DESIGN.md D2). The final row
is a write-trash row: padded scatters target it, padded gathers read it and
are discarded. Slot ids everywhere in this codebase are int32 offsets into
this global row space.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np

from cdlrm_tpu_torch.utils.primes import next_prime


@dataclass(frozen=True)
class CacheGeometry:
    num_tables: int
    dim: int
    ways: int
    aux_capacity: int
    sets: np.ndarray  # [T] int64, per-table set count
    table_offsets: np.ndarray  # [T] int64, row offset of each table's cache
    total_rows: int  # including the trailing trash row

    @staticmethod
    def build(
        ln_emb: Sequence[int], dim: int, cache_size: int, ways: int, aux_capacity: int
    ) -> "CacheGeometry":
        prime_sets = next_prime(cache_size)
        sets = np.array([min(int(n), prime_sets) for n in ln_emb], dtype=np.int64)
        rows_per_table = ways * sets + aux_capacity
        table_offsets = np.concatenate([[0], np.cumsum(rows_per_table)[:-1]])
        total = int(rows_per_table.sum()) + 1  # + trash row
        return CacheGeometry(
            num_tables=len(sets),
            dim=int(dim),
            ways=int(ways),
            aux_capacity=int(aux_capacity),
            sets=sets,
            table_offsets=table_offsets.astype(np.int64),
            total_rows=total,
        )

    @property
    def trash_row(self) -> int:
        return self.total_rows - 1

    def aux_base(self, t: int) -> int:
        """Global row of the first aux slot of table t."""
        return int(self.table_offsets[t] + self.ways * self.sets[t])

    def hit_slot(self, t: int, way: np.ndarray, set_idx: np.ndarray) -> np.ndarray:
        """Global rows for (way, set) pairs of table t
        (reference: cache_sizes[k]*way + set, model_no_ddp.py:174)."""
        return self.table_offsets[t] + way * self.sets[t] + set_idx

    def cache_bytes(self) -> int:
        return self.total_rows * self.dim * 4
