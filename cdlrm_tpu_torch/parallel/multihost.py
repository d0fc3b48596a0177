"""Row-sharded master tables, the numpy half of the counterpart of
cdlrm_tpu/parallel/multihost.py.

Two classes so far, copied as they are: :class:`RowShard` (contiguous
row-range ownership of the master tables for one host) and
:class:`ShardedMasterTables` (masters that materialize only the owned row
range of each table, with procedurally seeded values, optionally compact
per-table widths for mixed-dimension tables). On one host the cached trainer
builds ``ShardedMasterTables(..., RowShard(0, 1), rng, dims=...)`` for
``md_flag`` with ``master_init='virtual'``, so that its values match any
multi-host topology's. Nothing distributed is here yet: the window-row
exchange and the process-group set-up come with the multi-host port.
tests/test_torch_host.py holds both classes equal to cdlrm_tpu's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cdlrm_tpu_torch.cache.master import _DirtyTracker
from cdlrm_tpu_torch.ops import native


@dataclass(frozen=True)
class RowShard:
    """Contiguous row-range ownership of the master tables for one host."""

    host_id: int
    num_hosts: int

    def owned_range(self, n_rows: int) -> Tuple[int, int]:
        per = -(-n_rows // self.num_hosts)
        lo = min(self.host_id * per, n_rows)
        hi = min(lo + per, n_rows)
        return lo, hi

    def owner_of(self, idx: np.ndarray, n_rows: int) -> np.ndarray:
        per = -(-n_rows // self.num_hosts)
        return np.minimum(idx // per, self.num_hosts - 1)

    def bounds(self, sorted_idx: np.ndarray, n_rows: int) -> np.ndarray:
        """[H+1] positions splitting a sorted id array by owner (ownership is
        range-based, so owner slices are contiguous in sorted order)."""
        per = -(-n_rows // self.num_hosts)
        edges = np.arange(self.num_hosts + 1, dtype=np.int64) * per
        return np.searchsorted(sorted_idx, edges)


_PHI = np.int64(0x9E3779B1)


class ShardedMasterTables:
    """Row-sharded master tables: this host materializes only its owned row
    range of each table; values are procedurally seeded so every host count
    yields identical rows (block hash, uniform(-bound, bound) — reference
    init distribution, model_no_ddp.py:35-38, block-tiled like
    MasterTables(init='tile')).

    ``gather(t, sorted_unique_ids)`` (the prefetcher contract,
    cache/prefetcher.py) returns rows for the OWNED slice only — the caller
    reassembles full windows with :func:`exchange_window_rows`. ``writeback``
    silently drops rows this host doesn't own (their owner performs the same
    write from the replica-0-broadcast evicted values)."""

    def __init__(
        self,
        ln_emb: Sequence[int],
        dim: int,
        shard: RowShard,
        rng: Optional[np.random.Generator] = None,
        block_rows: int = 65536,
        dims: Optional[Sequence[int]] = None,
    ):
        """``dims``: optional per-table COMPACT row widths (cached MD path,
        cache/master.py MDMasterTables): owned rows are stored [*, d_t] and
        every pipeline-facing gather zero-pads to ``dim``; writeback slices
        the tail. The procedural block init slices the first d_t block
        columns, so values stay host-count-invariant per (table, id)."""
        self.ln_emb = [int(n) for n in ln_emb]
        self.dim = int(dim)
        self.dims = [int(d) for d in (dims if dims is not None else [dim] * len(self.ln_emb))]
        if any(d > self.dim for d in self.dims):
            raise ValueError(f"md dims {self.dims} exceed base dim {self.dim}")
        self.shard = shard
        # block derivation bit-matches VirtualMasterTables (cache/master.py)
        # so a single-host master_init='virtual' run and any multi-host run
        # materialize IDENTICAL master values
        rng = rng or np.random.default_rng(0)
        fast = np.random.Generator(np.random.SFC64(int(rng.integers(2**31))))
        self._block = fast.random((block_rows, dim), dtype=np.float32) * 2.0 - 1.0
        self.tables: List[np.ndarray] = []
        self.ranges: List[Tuple[int, int]] = []
        for t, n in enumerate(self.ln_emb):
            lo, hi = shard.owned_range(n)
            self.ranges.append((lo, hi))
            bound = np.float32(np.sqrt(1.0 / n))
            ids = np.arange(lo, hi, dtype=np.int64)
            pos = (ids + t * _PHI) % block_rows
            self.tables.append(
                np.ascontiguousarray(self._block[pos, : self.dims[t]] * bound)
            )
        # GLOBAL ids of owned rows ever written back (incremental checkpoint)
        self._dirty = _DirtyTracker(len(self.ln_emb))

    def _pad(self, t: int, compact: np.ndarray) -> np.ndarray:
        if compact.shape[1] == self.dim:
            return compact
        out = np.zeros((compact.shape[0], self.dim), np.float32)
        out[:, : compact.shape[1]] = compact
        return out

    def owned_mask(self, t: int, ids: np.ndarray) -> np.ndarray:
        lo, hi = self.ranges[t]
        return (ids >= lo) & (ids < hi)

    def gather(self, t: int, sorted_ids: np.ndarray) -> np.ndarray:
        """Rows for the owned slice of a SORTED id array (prefetcher path);
        zero-padded to the base dim under MD."""
        lo, hi = self.ranges[t]
        a, b = np.searchsorted(sorted_ids, [lo, hi])
        local = np.asarray(sorted_ids[a:b], dtype=np.int64) - lo
        tab = self.tables[t]
        if native.available() and local.size:
            return self._pad(t, native.gather_f32(tab, local))
        return self._pad(t, np.asarray(tab[local], dtype=np.float32))

    def gather_owned_of(self, t: int, ids: np.ndarray) -> np.ndarray:
        """Rows for EVERY position of ``ids`` (any order); un-owned positions
        are zero-filled (summed across hosts by GlobalRowExchange)."""
        lo, hi = self.ranges[t]
        own = self.owned_mask(t, ids)
        out = np.zeros((ids.size, self.dim), np.float32)
        if own.any():
            d_t = self.dims[t]
            out[own, :d_t] = self.tables[t][np.asarray(ids[own], np.int64) - lo]
        return out

    def writeback(
        self, t: int, idxs: np.ndarray, rows: np.ndarray, average: bool = False
    ) -> int:
        """Write back the OWNED subset; un-owned rows are silently dropped
        (their owner performs the same write). Returns rows written."""
        if idxs.size == 0:
            return 0
        own = self.owned_mask(t, idxs)
        if not own.any():
            return 0
        lo, _ = self.ranges[t]
        local = np.asarray(idxs[own], dtype=np.int64) - lo
        tab = self.tables[t]
        sel = np.ascontiguousarray(rows[own][:, : tab.shape[1]])
        if native.available():
            native.writeback_f32(tab, local, sel, average)
        elif average:
            tab[local] = (tab[local] + sel) / 2.0
        else:
            tab[local] = sel
        self._dirty.add(t, np.asarray(idxs[own], dtype=np.int64))
        return int(local.size)

    # ---- checkpointing: each host saves/loads its owned shard ----
    def save(self, path: str) -> None:
        np.savez(
            path,
            host_id=self.shard.host_id,
            num_hosts=self.shard.num_hosts,
            **{f"table_{t}": arr for t, arr in enumerate(self.tables)},
        )

    def save_dirty(self, path: str, init_token: int = 0) -> None:
        """Incremental owned-shard checkpoint (cache/master.py
        MasterTables.save_dirty): each host stores only the GLOBAL ids +
        values of owned rows ever written back; the procedurally-seeded base
        is re-derived at load."""
        payload = {
            "dirty_format": np.int64(1),
            "init_token": np.int64(init_token),
            "host_id": np.int64(self.shard.host_id),
            "num_hosts": np.int64(self.shard.num_hosts),
            "ln_emb": np.asarray(self.ln_emb, np.int64),
            "dim": np.int64(self.dim),
        }
        for t in range(len(self.tables)):
            ids = self._dirty.ids(t)
            lo, _ = self.ranges[t]
            payload[f"dirty_idx_{t}"] = ids
            payload[f"dirty_rows_{t}"] = self.tables[t][ids - lo]
        np.savez(path, **payload)

    def _check_shard_identity(self, data) -> None:
        # hard errors, not asserts (python -O strips asserts; loading
        # another host's shard would silently corrupt owned rows)
        if int(data["num_hosts"]) != self.shard.num_hosts:
            raise ValueError(
                f"checkpoint saved with {int(data['num_hosts'])} hosts, "
                f"loading with {self.shard.num_hosts}; re-shard offline"
            )
        if int(data["host_id"]) != self.shard.host_id:
            raise ValueError(
                f"checkpoint shard belongs to host {int(data['host_id'])}, "
                f"this is host {self.shard.host_id}"
            )

    def load(self, path: str, init_token: int = 0) -> None:
        with np.load(path) as data:
            self._check_shard_identity(data)
            if "dirty_format" not in data.files:
                for t in range(len(self.tables)):
                    self.tables[t][...] = data[f"table_{t}"]
                return
            if int(data["init_token"]) != int(init_token):
                raise ValueError(
                    f"dirty master checkpoint was saved under init token "
                    f"{int(data['init_token'])}, loading under {init_token}: "
                    "the procedurally-derived base tables would differ"
                )
            if (
                list(data["ln_emb"]) != self.ln_emb
                or int(data["dim"]) != self.dim
            ):
                raise ValueError("dirty master checkpoint geometry mismatch")
            for t in range(len(self.tables)):
                ids = data[f"dirty_idx_{t}"]
                lo, _ = self.ranges[t]
                if ids.size:
                    self.tables[t][ids - lo] = data[f"dirty_rows_{t}"]
                self._dirty.replace(t, ids)
