"""Host master embedding tables.

This system's equivalent of the reference's shared-memory CPU table group
(``Embedding_Table_Group`` + ``.share_memory()``,
model_no_ddp.py:21-98, main_no_ddp.py:621-622): full-size
per-table float32 arrays in host RAM (optionally mmap-backed for
larger-than-RAM tables), **frozen** — never trained directly
(model_no_ddp.py:74); the only mutation is eviction writeback
(cache_manager.py:48-64). Rows that are never cached are never trained —
a semantic feature of cDLRM we preserve (SURVEY.md §7 quirk list).

Concurrency: the prefetcher gathers rows while the eviction thread writes
others back. The reference tolerates this unsynchronized (shared-memory
tensors, no locks); races only affect staleness of individual rows, which the
algorithm already tolerates. We keep the same model and document it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cdlrm_tpu_torch.ops import native


class _DirtyTracker:
    """Per-table set of row ids ever written back — the EXACT master-table
    delta since initialization (masters are frozen except for eviction
    writeback, module doc), and therefore the exact content of an
    incremental checkpoint. Appends are O(1) per writeback (the eviction
    thread must not pay a sort per call); fragments consolidate to a sorted
    unique array when they exceed ``consolidate_rows`` ids. Memory is
    O(rows ever written), the same asymptotic as the checkpoint itself."""

    def __init__(self, n_tables: int, consolidate_rows: int = 1 << 20):
        self._frags: List[List[np.ndarray]] = [[] for _ in range(n_tables)]
        self._frag_rows = [0] * n_tables
        self._limit = consolidate_rows

    def add(self, t: int, idxs: np.ndarray) -> None:
        if idxs.size == 0:
            return
        self._frags[t].append(np.asarray(idxs, np.int64).copy())
        self._frag_rows[t] += int(idxs.size)
        if self._frag_rows[t] > self._limit and len(self._frags[t]) > 1:
            self.ids(t)

    def ids(self, t: int) -> np.ndarray:
        """Sorted unique dirty ids for table ``t`` (consolidates in place)."""
        frags = self._frags[t]
        if not frags:
            return np.zeros(0, np.int64)
        u = frags[0] if len(frags) == 1 else np.unique(np.concatenate(frags))
        self._frags[t] = [u]
        self._frag_rows[t] = int(u.size)
        return u

    def replace(self, t: int, ids: np.ndarray) -> None:
        self._frags[t] = [np.asarray(ids, np.int64)]
        self._frag_rows[t] = int(ids.size)

    def total_rows(self) -> int:
        return sum(self.ids(t).size for t in range(len(self._frags)))


class MasterTables:
    def __init__(
        self,
        ln_emb: Sequence[int],
        dim: int,
        rng: Optional[np.random.Generator] = None,
        mmap_dir: Optional[str] = None,
        init: str = "uniform",
    ):
        """init: 'uniform' = exact per-row uniform(-sqrt(1/n), sqrt(1/n))
        (reference init); 'tile' = one random block tiled across each table —
        O(block) RNG instead of O(rows), for benchmarking and for hosts where
        RNG throughput is the bottleneck (values still uniform in the right
        range; rows repeat with period 65536)."""
        self.ln_emb = [int(n) for n in ln_emb]
        self.dim = int(dim)
        self.tables: List[np.ndarray] = []
        rng = rng or np.random.default_rng(0)

        block = None
        if init == "tile":
            fast = np.random.Generator(np.random.SFC64(int(rng.integers(2**31))))
            block = fast.random((65536, self.dim), dtype=np.float32) * 2.0 - 1.0

        for t, n in enumerate(self.ln_emb):
            bound = np.float32(np.sqrt(1.0 / n))

            def fill(out, rows, offset=0):
                if block is not None:
                    bs = block.shape[0]
                    for s in range(0, rows, bs):
                        e = min(rows, s + bs)
                        np.multiply(block[: e - s], bound, out=out[s:e])
                    return
                # float32-native uniform(-bound, bound): avoids a float64
                # intermediate (2x memory + time on multi-GB tables)
                r = rng.random((rows, self.dim), dtype=np.float32)
                np.multiply(r, 2 * bound, out=r)
                np.subtract(r, bound, out=r)
                out[...] = r

            if mmap_dir is not None:
                path = os.path.join(mmap_dir, f"master_table_{t}.npy")
                arr = np.lib.format.open_memmap(
                    path, mode="w+", dtype=np.float32, shape=(n, self.dim)
                )
                chunk = max(1, (1 << 24) // max(1, self.dim))
                for s in range(0, n, chunk):
                    e = min(n, s + chunk)
                    fill(arr[s:e], e - s)
            else:
                arr = np.empty((n, self.dim), dtype=np.float32)
                fill(arr, n)
            self.tables.append(arr)
        self._dirty = _DirtyTracker(len(self.ln_emb))

    def gather(self, t: int, idxs: np.ndarray) -> np.ndarray:
        """Row gather (reference fetch_unique_idx_slices,
        model_no_ddp.py:80-87). Row-parallel native path when available
        (numpy fancy indexing is single-threaded)."""
        tab = self.tables[t]
        if native.available() and tab.flags["C_CONTIGUOUS"]:
            return native.gather_f32(tab, np.asarray(idxs))
        return np.asarray(tab[idxs], dtype=np.float32)

    def gather_all(self, idxs_per_table: Sequence[np.ndarray]) -> List[np.ndarray]:
        return [self.gather(t, idxs) for t, idxs in enumerate(idxs_per_table)]

    def writeback(
        self, t: int, idxs: np.ndarray, rows: np.ndarray, average: bool = False
    ) -> int:
        """Eviction writeback: overwrite or average with the resident rows
        (reference cache_manager.py:58-62). Returns rows actually written."""
        if idxs.size == 0:
            return 0
        tab = self.tables[t]
        if native.available() and tab.flags["C_CONTIGUOUS"]:
            native.writeback_f32(tab, np.asarray(idxs), rows, average)
        elif average:
            tab[idxs] = (tab[idxs] + rows) / 2.0
        else:
            tab[idxs] = rows
        self._dirty.add(t, idxs)
        return int(idxs.size)

    # ---- checkpointing (capability upgrade; reference has none) ----
    def save(self, path: str) -> None:
        np.savez(path, **{f"table_{t}": arr for t, arr in enumerate(self.tables)})

    def save_dirty(self, path: str, init_token: int = 0) -> None:
        """Incremental checkpoint: (init spec + dirty rows). Masters only
        mutate via eviction writeback, so the dirty set is the whole delta —
        file size scales with rows ever written back, not table size
        (at Terabyte geometry a full dump is 100s of GB per checkpoint). ``init_token`` guards the procedural-init
        assumption: load re-derives the initial tables from the trainer's
        (seed, geometry) and must refuse a mismatched stream."""
        np.savez(path, **self.dirty_payload(init_token))

    def dirty_payload(self, init_token: int = 0) -> dict:
        """The :meth:`save_dirty` payload as a SNAPSHOT dict (fancy-index
        row copies — stable against concurrent eviction writeback), so an
        async checkpoint writer can serialize it off the train thread."""
        payload = {
            "dirty_format": np.int64(1),
            "init_token": np.int64(init_token),
            "ln_emb": np.asarray(self.ln_emb, np.int64),
            "dim": np.int64(self.dim),
        }
        for t in range(len(self.tables)):
            ids = self._dirty.ids(t)
            payload[f"dirty_idx_{t}"] = ids
            payload[f"dirty_rows_{t}"] = self.tables[t][ids]
        return payload

    def load(self, path: str, init_token: int = 0) -> None:
        """Restore from a full dump or a dirty-row incremental checkpoint
        (auto-detected). Dirty restore assumes ``self.tables`` currently
        hold the SAME initial values the saving run started from — i.e. a
        freshly-constructed master with identical (seed, init, geometry) —
        and re-marks the loaded rows dirty so later incremental saves stay
        cumulative."""
        with np.load(path) as data:
            if "dirty_format" not in data.files:
                for t in range(len(self.tables)):
                    self.tables[t][...] = data[f"table_{t}"]
                return
            if int(data["init_token"]) != int(init_token):
                raise ValueError(
                    f"dirty master checkpoint was saved under init token "
                    f"{int(data['init_token'])}, loading under {init_token}: "
                    "the procedurally-derived base tables would differ "
                    "(same --numpy-rand-seed and master geometry required)"
                )
            if (
                list(data["ln_emb"]) != self.ln_emb
                or int(data["dim"]) != self.dim
            ):
                raise ValueError(
                    "dirty master checkpoint geometry mismatch: saved "
                    f"{list(data['ln_emb'])}x{int(data['dim'])}, this master "
                    f"is {self.ln_emb}x{self.dim}"
                )
            for t in range(len(self.tables)):
                ids = data[f"dirty_idx_{t}"]
                if ids.size:
                    self.tables[t][ids] = data[f"dirty_rows_{t}"]
                self._dirty.replace(t, ids)


class AccumulatorStore:
    """Host-resident per-table row-wise AdaGrad accumulators
    (Config.adagrad_master_state): one f32 scalar per embedding row,
    initialized 0 (torch.optim.Adagrad initial_accumulator_value).

    The cached trainer's row-wise state is cache-resident by default and
    DROPPED at eviction / reset at insert (the documented approximation).
    With the master-state flag, evicted ids' accumulators write back here
    (with their rows, same eviction thread) and inserted ids RESUME from
    here — closing the gap that lost state opens under capacity pressure.
    No reference counterpart (the reference trains SGD only,
    main_no_ddp.py:374-376). Memory: 4 bytes/row (26 MB at 26 tables of
    250,000 rows; ~2% of the f32 masters at any geometry).

    Writeback is always OVERWRITE (state restore, not a merge) — even
    under --average-on-writeback, which averages VALUES of concurrent
    divergent replicas; accumulators are replica-identical by the psum'd
    update so there is nothing to average.

    Multi-host (``owned_ranges`` set, mirroring ShardedMasterTables): each
    host stores COMPACT per-table slices of its owned contiguous row range
    only; writebacks mask to the owned range (evicted accs are
    replica-0-broadcast so the owner performs the identical write), and
    resume values for un-owned rows travel on the window exchange
    (parallel/multihost.py exchange_window_rows accs lane) — this store is
    never read for rows the host does not own."""

    def __init__(
        self,
        ln_emb: Sequence[int],
        owned_ranges: Optional[Sequence[Tuple[int, int]]] = None,
    ):
        self.owned_ranges = (
            [(int(lo), int(hi)) for lo, hi in owned_ranges]
            if owned_ranges is not None
            else [(0, int(n)) for n in ln_emb]
        )
        self.sharded = owned_ranges is not None
        self.accs: List[np.ndarray] = [
            np.zeros(hi - lo, np.float32) for lo, hi in self.owned_ranges
        ]

    def gather(self, tables: np.ndarray, idxs: np.ndarray) -> np.ndarray:
        """Per-id accumulator values for a flattened (table, id) list.
        OWNED rows only — a sharded store raises on un-owned ids (the
        multihost resume path must join from the window exchange, never
        from here)."""
        out = np.empty(idxs.size, np.float32)
        for t in np.unique(tables):
            sel = tables == t
            lo, hi = self.owned_ranges[int(t)]
            ids = idxs[sel]
            if self.sharded and ids.size and (
                int(ids.min()) < lo or int(ids.max()) >= hi
            ):
                raise IndexError(
                    f"AccumulatorStore.gather: table {int(t)} ids outside "
                    f"owned range [{lo}, {hi}) — un-owned resume values "
                    "come from the window exchange"
                )
            out[sel] = self.accs[int(t)][ids - lo]
        return out

    def gather_owned_slice(self, t: int, sorted_ids: np.ndarray) -> np.ndarray:
        """Acc values for the owned slice of a SORTED id array — the
        window-exchange packing order (ShardedMasterTables.gather's mirror
        for the accs lane)."""
        lo, hi = self.owned_ranges[int(t)]
        a, b = np.searchsorted(sorted_ids, [lo, hi])
        return self.accs[int(t)][np.asarray(sorted_ids[a:b], np.int64) - lo]

    def writeback(self, t: int, idxs: np.ndarray, vals: np.ndarray) -> None:
        if idxs.size == 0:
            return
        lo, hi = self.owned_ranges[int(t)]
        if self.sharded:
            own = (idxs >= lo) & (idxs < hi)
            if not own.any():
                return
            idxs, vals = idxs[own], vals[own]
        self.accs[int(t)][idxs - lo] = vals

    # ---- checkpointing (rides the trainer checkpoint when the flag is on;
    # nonzero rows == ids ever evicted, so a dense save is wasteful at
    # Terabyte geometry — save the nonzero support). Ids are GLOBAL; a
    # sharded store stamps its shard identity and refuses a mismatched
    # load (same contract as ShardedMasterTables._check_shard_identity). ----
    def payload(self) -> dict:
        out = {
            "acc_owned_lo": np.asarray(
                [lo for lo, _ in self.owned_ranges], np.int64
            ),
            "acc_owned_hi": np.asarray(
                [hi for _, hi in self.owned_ranges], np.int64
            ),
        }
        for t, a in enumerate(self.accs):
            nz = np.flatnonzero(a)
            out[f"acc_ids_{t}"] = nz + self.owned_ranges[t][0]
            out[f"acc_vals_{t}"] = a[nz]
        return out

    def load_payload(self, data) -> None:
        lo_s = data.get("acc_owned_lo")
        if lo_s is not None:
            want_lo = [lo for lo, _ in self.owned_ranges]
            want_hi = [hi for _, hi in self.owned_ranges]
            if (list(np.asarray(lo_s)) != want_lo
                    or list(np.asarray(data["acc_owned_hi"])) != want_hi):
                raise ValueError(
                    "AccumulatorStore checkpoint was written by a different "
                    "shard topology; load each host's own acc_store file"
                )
        for t, a in enumerate(self.accs):
            a[:] = 0.0
            ids = data.get(f"acc_ids_{t}")
            if ids is not None and np.asarray(ids).size:
                a[np.asarray(ids) - self.owned_ranges[t][0]] = np.asarray(
                    data[f"acc_vals_{t}"]
                )


class MDMasterTables:
    """Mixed-dimension master tables for the CACHED path (beyond-parity:
    the reference's cached path crashes with MD — its prefetcher reads
    ``E.weight`` which PrEmbeddingBag doesn't have, model_no_ddp.py:80-87 —
    and MD is exactly the regime where caching matters: row counts stay
    huge at small dims).

    Table t stores COMPACT [n_t, d_t] float32 rows (the host-RAM saving is
    the point of MD at Terabyte scale), while the whole cache pipeline —
    prefetcher window gathers, aux staging, refills, eviction writeback —
    sees uniform [., base_dim] rows: ``gather`` zero-pads the tail,
    ``writeback`` slices it off. The pad columns are SELF-CONSISTENT under
    training: the per-table projection's pad rows are zero, so gradients
    w.r.t. pad columns are exactly zero and they remain 0.0 forever
    (train/step.py _apply_md_proj).

    Init parity: uniform(-sqrt(1/n), sqrt(1/n)) per table — the effective
    reference init for MD tables (models/tricks.py init_md_embedding note).
    """

    def __init__(
        self,
        ln_emb: Sequence[int],
        dims: Sequence[int],
        base_dim: int,
        rng: Optional[np.random.Generator] = None,
        mmap_dir: Optional[str] = None,
    ):
        self.ln_emb = [int(n) for n in ln_emb]
        self.dims = [int(d) for d in dims]
        self.dim = int(base_dim)  # wire/cache row width the pipeline sees
        if any(d > self.dim for d in self.dims):
            raise ValueError(f"md dims {self.dims} exceed base dim {self.dim}")
        rng = rng or np.random.default_rng(0)
        self.tables: List[np.ndarray] = []
        for t, (n, d) in enumerate(zip(self.ln_emb, self.dims)):
            bound = np.float32(np.sqrt(1.0 / n))
            if mmap_dir is not None:
                path = os.path.join(mmap_dir, f"master_md_table_{t}.npy")
                arr = np.lib.format.open_memmap(
                    path, mode="w+", dtype=np.float32, shape=(n, d)
                )
                chunk = max(1, (1 << 24) // max(1, d))
                for s in range(0, n, chunk):
                    e = min(n, s + chunk)
                    r = rng.random((e - s, d), dtype=np.float32)
                    arr[s:e] = r * (2 * bound) - bound
            else:
                r = rng.random((n, d), dtype=np.float32)
                np.multiply(r, 2 * bound, out=r)
                np.subtract(r, bound, out=r)
                arr = r
            self.tables.append(arr)
        self._dirty = _DirtyTracker(len(self.ln_emb))

    def gather(self, t: int, idxs: np.ndarray) -> np.ndarray:
        tab = self.tables[t]
        idxs = np.asarray(idxs)
        compact = (
            native.gather_f32(tab, idxs)
            if native.available() and tab.flags["C_CONTIGUOUS"]
            else np.asarray(tab[idxs], dtype=np.float32)
        )
        out = np.zeros((idxs.size, self.dim), np.float32)
        out[:, : compact.shape[1]] = compact
        return out

    def gather_all(self, idxs_per_table: Sequence[np.ndarray]) -> List[np.ndarray]:
        return [self.gather(t, idxs) for t, idxs in enumerate(idxs_per_table)]

    def writeback(
        self, t: int, idxs: np.ndarray, rows: np.ndarray, average: bool = False
    ) -> int:
        if idxs.size == 0:
            return 0
        tab = self.tables[t]
        sel = np.ascontiguousarray(rows[:, : tab.shape[1]])
        if native.available() and tab.flags["C_CONTIGUOUS"]:
            native.writeback_f32(tab, np.asarray(idxs), sel, average)
        elif average:
            tab[idxs] = (tab[idxs] + sel) / 2.0
        else:
            tab[idxs] = sel
        self._dirty.add(t, idxs)
        return int(idxs.size)

    # ---- checkpointing (same formats as MasterTables, + dims guard) ----
    def save(self, path: str) -> None:
        np.savez(path, md_dims=np.asarray(self.dims, np.int64),
                 **{f"table_{t}": arr for t, arr in enumerate(self.tables)})

    def save_dirty(self, path: str, init_token: int = 0) -> None:
        np.savez(path, **self.dirty_payload(init_token))

    def dirty_payload(self, init_token: int = 0) -> dict:
        payload = {
            "dirty_format": np.int64(1),
            "init_token": np.int64(init_token),
            "ln_emb": np.asarray(self.ln_emb, np.int64),
            "dim": np.int64(self.dim),
            "md_dims": np.asarray(self.dims, np.int64),
        }
        for t in range(len(self.tables)):
            ids = self._dirty.ids(t)
            payload[f"dirty_idx_{t}"] = ids
            payload[f"dirty_rows_{t}"] = self.tables[t][ids]
        return payload

    def load(self, path: str, init_token: int = 0) -> None:
        with np.load(path) as data:
            if "md_dims" in data.files and list(data["md_dims"]) != self.dims:
                raise ValueError(
                    f"MD checkpoint dims {list(data['md_dims'])} != this "
                    f"master's {self.dims}"
                )
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
                if ids.size:
                    self.tables[t][ids] = data[f"dirty_rows_{t}"]
                self._dirty.replace(t, ids)


class VirtualMasterTables:
    """Procedurally-generated master tables with a sparse writeback overlay.

    Same interface as MasterTables, but rows are computed on demand from a
    small random block instead of materialized: gather(t, idx) returns
    block[(idx + t*PHI) % block_rows] * bound_t, with written-back rows kept
    in a per-table sorted overlay. Exists for benchmarking on hosts where
    materializing / first-touching many GB of table memory costs minutes
    (e.g. throttled VMs); the gather/writeback cost profile matches the real
    MasterTables. Not for real training: rows repeat with period block_rows.
    """

    _PHI = 0x9E3779B1

    def __init__(self, ln_emb, dim, rng=None, block_rows: int = 65536):
        self.ln_emb = [int(n) for n in ln_emb]
        self.dim = int(dim)
        rng = rng or np.random.default_rng(0)
        fast = np.random.Generator(np.random.SFC64(int(rng.integers(2**31))))
        self._block = fast.random((block_rows, self.dim), dtype=np.float32) * 2.0 - 1.0
        self._bounds = [np.float32(np.sqrt(1.0 / n)) for n in self.ln_emb]
        # (idx, rows) pairs swapped ATOMICALLY (one reference assignment):
        # the eviction thread rebuilds the overlay while the prefetcher
        # gathers — two separate attributes raced (mismatched sizes crash)
        self._overlay = [
            (np.zeros(0, np.int64), np.zeros((0, self.dim), np.float32))
            for _ in self.ln_emb
        ]

    def gather(self, t: int, idxs: np.ndarray) -> np.ndarray:
        idxs = np.asarray(idxs, dtype=np.int64)
        pos = (idxs + t * self._PHI) % self._block.shape[0]
        rows = self._block[pos] * self._bounds[t]
        o_idx, o_rows = self._overlay[t]  # consistent snapshot
        if o_idx.size:
            loc = np.searchsorted(o_idx, idxs)
            loc_c = np.minimum(loc, o_idx.size - 1)
            hit = o_idx[loc_c] == idxs
            if hit.any():
                rows[hit] = o_rows[loc_c[hit]]
        return rows

    def gather_all(self, idxs_per_table):
        return [self.gather(t, i) for t, i in enumerate(idxs_per_table)]

    def writeback(self, t: int, idxs: np.ndarray, rows: np.ndarray, average: bool = False) -> int:
        if idxs.size == 0:
            return 0
        idxs = np.asarray(idxs, dtype=np.int64)
        rows = np.asarray(rows, dtype=np.float32)
        if average:
            rows = (self.gather(t, idxs) + rows) / 2.0
        o_idx, o_rows = self._overlay[t]
        merged_idx = np.concatenate([o_idx, idxs])
        merged_rows = np.concatenate([o_rows, rows])
        # keep the LAST write per index
        uniq, last_rev = np.unique(merged_idx[::-1], return_index=True)
        keep = merged_idx.size - 1 - last_rev
        self._overlay[t] = (uniq, merged_rows[keep])  # atomic swap
        return int(idxs.size)

    def save(self, path: str) -> None:
        np.savez(
            path,
            block=self._block,
            **{f"oidx_{t}": self._overlay[t][0] for t in range(len(self.ln_emb))},
            **{f"orows_{t}": self._overlay[t][1] for t in range(len(self.ln_emb))},
        )

    def load(self, path: str) -> None:
        with np.load(path) as data:
            self._block = data["block"]
            for t in range(len(self.ln_emb)):
                self._overlay[t] = (data[f"oidx_{t}"], data[f"orows_{t}"])
