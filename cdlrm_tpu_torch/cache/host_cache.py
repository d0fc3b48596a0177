"""Host-authoritative cache controller: occupancy, probe, insert/evict policy.

The reference keeps occupancy tables in host shared memory and probes them on
the GPU inside forward (model_no_ddp.py:149-212), while all
mutations happen on rank 0 during refill (``CacheEmbeddings``,
main_no_ddp.py:148-209). Since the host performs every
mutation, it always knows the exact cache contents — so here the probe ALSO
runs on the host, in the input pipeline, producing static-shape step inputs
(DESIGN.md D1). The device never sees occupancy.

All numpy, vectorized; every routine is a pure function of (occupancy, input)
except for the documented in-place occupancy updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cdlrm_tpu_torch.cache.geometry import CacheGeometry
from cdlrm_tpu_torch.ops import native
from cdlrm_tpu_torch.train.step import pack_slots, wire_bytes, wire_width


@dataclass
class ProbeResult:
    """Per-shard, static-shape lookup resolution for one batch.

    slots: [T, B] int32 global cache rows (hits -> way*sets+set within the
        table block; misses -> packed aux slots, reference
        model_no_ddp.py:176-185).
    aux_slots: [K] int32 aux-region rows receiving miss data this step;
    aux_rows: [K, D] float32 the master rows to scatter there. K is the
        TOTAL miss count across tables — only actual misses travel
        host->device (the reference ships exactly the miss rows too,
        model_no_ddp.py:179; a fixed [T, aux_cap, D] buffer would waste
        ~hit_rate of the transfer).
    hit_counts: [T] int64 hits per table (first-class hit-rate metric; the
        reference computes this but comments it out, model_no_ddp.py:206-207).
    num_lookups: total lookups probed (for hit-rate denominators).
    """

    slots: np.ndarray
    aux_slots: np.ndarray
    aux_rows: np.ndarray
    hit_counts: np.ndarray
    num_lookups: int


@dataclass
class DedupProbeResult:
    """Duplicate-coalesced probe output (the dedup wire format,
    train/step.py make_cached_train_step with cfg.dedup).

    inv_wire: [T, inv_bytes] uint8 — bitstream of inv_bits-wide table-LOCAL
        first-seen ranks per lookup (masked positions -> all-ones sentinel).
    uniq: [U] int32 global cache rows, per-table first-seen lists
        concatenated in table order (U = uniq_counts.sum()).
    uniq_counts: [T] int64 per-table unique counts.
    aux_slots / aux_rows / hit_counts / num_lookups: as ProbeResult.
    """

    inv_wire: np.ndarray
    uniq: np.ndarray
    uniq_counts: np.ndarray
    aux_slots: np.ndarray
    aux_rows: np.ndarray
    hit_counts: np.ndarray
    num_lookups: int


@dataclass
class InsertPlan:
    """Flattened refill plan produced by the insert/evict policy.

    insert_slots: [K] int32 global rows to overwrite with insert_rows [K, D].
    insert_tables / insert_ids: [K] owning table + original embedding id of
        each insert (consumers: the master-resident AdaGrad state gather,
        Config.adagrad_master_state).
    evict_slots: [E] int32 global rows whose CURRENT device values must be
        gathered (before the insert scatter!) and written back to the master.
    evict_tables: [E] int32 owning table of each eviction.
    evict_idxs: [E] int64 original embedding ids being evicted.
    """

    insert_slots: np.ndarray
    insert_rows: np.ndarray
    evict_slots: np.ndarray
    evict_tables: np.ndarray
    evict_idxs: np.ndarray
    insert_tables: np.ndarray = None
    insert_ids: np.ndarray = None


@dataclass
class InsertPlanSpec:
    """Row-free refill plan: everything :class:`InsertPlan` carries except the
    master-row VALUES, which are joined in later (``build_insert_plan``).

    Produced by the prefetcher's SHADOW controller (cache/prefetcher.py),
    which simulates the deterministic occupancy trajectory ahead of the
    trainer — the insert/evict policy is a pure function of (occupancy, RNG,
    window uniques), so the shadow's plan is bit-identical to what the
    trainer would have computed at refill time. The trainer replays the
    occupancy mutations with :meth:`HostCacheController.apply_plan_spec`
    (no RNG draws; ``rng_state`` re-syncs its generator so checkpoints stay
    resume-exact). Reference policy: CacheEmbeddings,
    main_no_ddp.py:148-209.

    insert_slots/tables/ids: [K] target rows, owning tables, inserted ids
        (last-write-wins deduped like InsertPlan).
    insert_pos: [K] int64 positions into the window's uniques[table] arrays
        (row values join as rows[table][pos]).
    evict_*: as InsertPlan.
    rng_state: the planning generator's state AFTER this plan.
    """

    insert_slots: np.ndarray
    insert_tables: np.ndarray
    insert_ids: np.ndarray
    insert_pos: np.ndarray
    evict_slots: np.ndarray
    evict_tables: np.ndarray
    evict_idxs: np.ndarray
    rng_state: Optional[dict] = None


@dataclass
class WindowStats:
    """Per-window probe statistics against the POST-refill occupancy,
    computed by the shadow controller while the window streams (replaces the
    trainer-side retained-batch / dataset-replay stats pass). All counts are per (replica, batch) worst cases over the window;
    totals feed the auto-dedup duplication decision (config.dedup_lookups
    'auto'). Deterministic functions of host-identical state, so every
    multi-host peer derives identical values with zero communication.
    """

    worst_miss: int = 1
    worst_uniq: int = 0  # 0 = uniq stats not collected
    worst_cold: int = 0  # 0 = no hot set (hot tier off)
    total_lookups: int = 0
    total_uniq: int = 0


def _cat(parts: List[np.ndarray], dtype, width: Optional[int] = None):
    if not parts:
        shape = (0,) if width is None else (0, width)
        return np.zeros(shape, dtype=dtype)
    # single fused copy; no extra astype pass
    return np.concatenate(parts, dtype=dtype, casting="unsafe")


def build_insert_plan(
    spec: InsertPlanSpec, rows: Sequence[np.ndarray], dim: int
) -> InsertPlan:
    """Join a row-free plan spec with the window's master rows:
    insert_rows[k] = rows[insert_tables[k]][insert_pos[k]]."""
    if spec.insert_slots.size:
        parts = []
        for t in np.unique(spec.insert_tables):
            sel = spec.insert_tables == t
            r = np.asarray(rows[t], dtype=np.float32)[spec.insert_pos[sel]]
            parts.append((np.flatnonzero(sel), r))
        insert_rows = np.empty((spec.insert_slots.size, dim), np.float32)
        for pos, r in parts:
            insert_rows[pos] = r
    else:
        insert_rows = np.zeros((0, dim), np.float32)
    return InsertPlan(
        insert_slots=spec.insert_slots,
        insert_rows=insert_rows,
        evict_slots=spec.evict_slots,
        evict_tables=spec.evict_tables,
        evict_idxs=spec.evict_idxs,
        insert_tables=spec.insert_tables,
        insert_ids=spec.insert_ids,
    )


class HostCacheController:
    def __init__(
        self, geometry: CacheGeometry, seed: int = 0,
        ln_emb: Optional[np.ndarray] = None, slot_map: bool = False,
    ):
        """``slot_map`` (requires ``ln_emb``): maintain a flat id->cache-row
        direct map alongside the set-associative occupancy. The occupancy
        stays the POLICY structure (insert/evict, way protection); the map is
        a redundant O(1) index that turns the per-lookup probe from a
        random-DRAM occupancy walk into one vectorized numpy gather.
        Memory: 4 bytes per embedding id (26 MB at 26 tables of 250,000 ids,
        ~4 GB at full 40M-id Terabyte — small next to the master tables the
        host already holds). Outputs are bit-identical to the occupancy
        probe (invariant maintained by plan_insert; pinned in
        tests/test_cache.py)."""
        self.geo = geometry
        # [-1]-initialized occupancy, reference model_no_ddp.py:144-147.
        # int32: embedding ids are < 2^31 for every supported dataset and the
        # probe is host-memory-bandwidth-bound — half the bytes, half the time
        self.occupancy: List[np.ndarray] = [
            np.full((int(s), geometry.ways), -1, dtype=np.int32) for s in geometry.sets
        ]
        # SFC64: the fastest numpy bit generator; way assignment only needs
        # statistical uniformity, not PCG64's guarantees
        self.rng = np.random.Generator(np.random.SFC64(seed))
        self._aux_bases = np.array(
            [geometry.aux_base(t) for t in range(geometry.num_tables)], np.int64
        )
        self._rank_scratch: Optional[List[np.ndarray]] = None  # dedup probe
        self._slot_map: Optional[np.ndarray] = None
        self._id_bases: Optional[np.ndarray] = None
        if slot_map:
            if ln_emb is None:
                raise ValueError("slot_map=True requires ln_emb")
            ln = np.asarray(ln_emb, dtype=np.int64)
            self._id_bases = np.concatenate([[0], np.cumsum(ln)[:-1]])
            self._slot_map = np.full(int(ln.sum()), -1, dtype=np.int32)

    def _map_ids(
        self, ls_i: np.ndarray, valid: Optional[np.ndarray]
    ) -> np.ndarray:
        """Per-table range guard for the direct-map paths: the flat map is
        segmented by table, so an id >= ln_emb[t] would silently index the
        NEXT table's segment and could return a phantom hit into the wrong
        table's cache rows (the set-associative probe is intrinsically safe
        via mod-sets). Masked padding lanes are exempt (replaced by 0, same
        contract as the native kernel which skips them). Returns the array
        to index the map with (ls_i, or a masked copy)."""
        sizes = np.append(self._id_bases[1:], self._slot_map.shape[0]) - self._id_bases
        ids = ls_i if valid is None else np.where(valid, ls_i, 0)
        mx = ids.max(axis=1, initial=0)
        mn = ids.min(axis=1, initial=0)
        if (mx >= sizes).any() or (mn < 0).any():
            bad = np.flatnonzero((mx >= sizes) | (mn < 0))[0]
            raise ValueError(
                f"table {bad}: lookup id out of range [0, {int(sizes[bad])}) "
                f"(got min={int(mn[bad])}, max={int(mx[bad])})"
            )
        return ids

    def rebuild_slot_map(self) -> None:
        """Re-derive the direct map from the occupancy (checkpoint load)."""
        if self._slot_map is None:
            return
        geo = self.geo
        self._slot_map[...] = -1
        for t, occ in enumerate(self.occupancy):
            sets_t = occ.shape[0]
            set_idx, way = np.nonzero(occ >= 0)
            ids = occ[set_idx, way].astype(np.int64)
            self._slot_map[self._id_bases[t] + ids] = (
                geo.table_offsets[t] + way * sets_t + set_idx
            ).astype(np.int32)

    def _dedup_scratch(self) -> List[np.ndarray]:
        if self._rank_scratch is None:
            rows = self.geo.ways * self.geo.sets + self.geo.aux_capacity
            self._rank_scratch = [
                np.full(int(r), -1, dtype=np.int32) for r in rows
            ]
        return self._rank_scratch

    # ------------------------------------------------------------------ probe
    def probe(
        self, ls_i: np.ndarray, master, count_hits: bool = True,
        valid: Optional[np.ndarray] = None,
    ) -> ProbeResult:
        """Resolve one local batch [T, N] of lookups (N = B for single-index,
        B*P for flattened padded multi-hot with ``valid`` marking real
        positions; invalid positions resolve to the trash row).

        Reference semantics (model_no_ddp.py:163-187): set = idx % sets;
        hit if idx is in the set's occupancy; misses get consecutive aux slots
        in batch order and their master rows are staged for the aux region.

        Fast path: the fused native probe (csrc/host_ops.cpp) — one pass per
        lookup instead of numpy's several; bit-identical outputs
        (tests/test_torch_host.py).
        """
        geo = self.geo
        t_count, b = ls_i.shape
        if self._slot_map is not None:
            return self._probe_map(ls_i, master, valid)
        if native.available():
            return self._probe_native(ls_i, master, valid)
        slots = np.empty((t_count, b), dtype=np.int32)
        aux_slot_parts, aux_row_parts = [], []
        hit_counts = np.zeros(t_count, dtype=np.int64)
        for t in range(t_count):
            idx = ls_i[t].astype(np.int32, copy=False)
            sets_t = np.int32(geo.sets[t])
            set_idx = idx % sets_t
            occ = self.occupancy[t][set_idx]  # [B, ways]
            eq = occ == idx[:, None]
            hit = eq.any(axis=1)
            way = eq.argmax(axis=1)
            slot = geo.table_offsets[t] + way * sets_t + set_idx
            if valid is not None:
                miss_pos = np.nonzero(~hit & valid[t])[0]
            else:
                miss_pos = np.nonzero(~hit)[0]
            n_miss = miss_pos.size
            if n_miss > geo.aux_capacity:
                raise ValueError(
                    f"table {t}: {n_miss} misses exceed aux capacity "
                    f"{geo.aux_capacity}; raise --aux-capacity"
                )
            aux_base = geo.aux_base(t)
            slot[miss_pos] = aux_base + np.arange(n_miss)
            if valid is not None:
                slot[~valid[t]] = geo.trash_row  # masked padding positions
            slots[t] = slot.astype(np.int32)
            if n_miss:
                aux_slot_parts.append(
                    (aux_base + np.arange(n_miss)).astype(np.int32)
                )
                aux_row_parts.append(master.gather(t, idx[miss_pos]))
            if count_hits:
                n_valid = b if valid is None else int(valid[t].sum())
                hit_counts[t] = n_valid - n_miss
        if aux_slot_parts:
            aux_slots = np.concatenate(aux_slot_parts)
            aux_rows = np.concatenate(aux_row_parts)
        else:
            aux_slots = np.zeros(0, dtype=np.int32)
            aux_rows = np.zeros((0, geo.dim), dtype=np.float32)
        num_lookups = int(valid.sum()) if valid is not None else t_count * b
        return ProbeResult(slots, aux_slots, aux_rows, hit_counts, num_lookups)

    def _probe_map(
        self, ls_i: np.ndarray, master, valid: Optional[np.ndarray] = None,
    ) -> ProbeResult:
        """Direct-map probe: one vectorized gather into the flat id->row map
        replaces the per-lookup occupancy walk; identical outputs (class
        docstring). Misses and aux assignment follow the same batch-order
        rule as :meth:`probe`."""
        geo = self.geo
        t_count, b = ls_i.shape
        gidx = self._map_ids(ls_i, valid) + self._id_bases[:, None]
        slots = self._slot_map[gidx]  # [T, b] int32, -1 = not resident
        miss_all = slots < 0
        if valid is not None:
            miss_all &= valid
        aux_slot_parts, aux_row_parts = [], []
        hit_counts = np.zeros(t_count, dtype=np.int64)
        for t in range(t_count):
            miss_pos = np.flatnonzero(miss_all[t])
            n_miss = miss_pos.size
            if n_miss > geo.aux_capacity:
                raise ValueError(
                    f"table {t}: {n_miss} misses exceed aux capacity "
                    f"{geo.aux_capacity}; raise --aux-capacity"
                )
            if n_miss:
                aux = self._aux_bases[t] + np.arange(n_miss)
                slots[t, miss_pos] = aux
                aux_slot_parts.append(aux.astype(np.int32))
                aux_row_parts.append(master.gather(t, ls_i[t][miss_pos]))
            n_valid = b if valid is None else int(valid[t].sum())
            hit_counts[t] = n_valid - n_miss
        if valid is not None:
            slots[~valid] = geo.trash_row
        if aux_slot_parts:
            aux_slots = np.concatenate(aux_slot_parts)
            aux_rows = np.concatenate(aux_row_parts)
        else:
            aux_slots = np.zeros(0, dtype=np.int32)
            aux_rows = np.zeros((0, geo.dim), dtype=np.float32)
        num_lookups = int(valid.sum()) if valid is not None else t_count * b
        return ProbeResult(slots, aux_slots, aux_rows, hit_counts, num_lookups)

    def probe_wire(
        self, ls_i: np.ndarray, master, bits: int,
        valid: Optional[np.ndarray] = None,
    ) -> ProbeResult:
        """Probe emitting slots as the ``bits``-wide table-local bitstream
        ([T, wire_bytes(N, bits)] uint8; train/step.py pack_slots layout) —
        fused probe+pack in the native layer, falling back to probe + pack.
        With the direct map enabled, the map probe + native per-table bit
        pack is the fastest path."""
        geo = self.geo
        max_local = int((geo.ways * geo.sets + geo.aux_capacity).max()) - 1
        if bits < wire_width(max_local):
            raise ValueError(
                f"wire bits={bits} cannot address local slots up to "
                f"{max_local} (need >= {wire_width(max_local)})"
            )
        if self._slot_map is not None:
            if native.available():
                # fully fused: one C pass does map gather + miss detection +
                # bit pack (cdlrm_map_probe_batch_wire)
                ls64 = np.ascontiguousarray(ls_i, dtype=np.int64)
                wire, miss_pos, miss_counts = native.map_probe_batch_wire(
                    self._slot_map, self._id_bases, ls64,
                    geo.table_offsets, (geo.ways * geo.sets).astype(np.int64),
                    bits, wire_bytes(ls_i.shape[1], bits), valid=valid,
                )
                return self._finish_native_probe(
                    wire, miss_pos, miss_counts, ls64, master, valid
                )
            pr = self._probe_map(ls_i, master, valid=valid)
            wire = pack_slots(pr.slots, geo.table_offsets, geo.trash_row, bits)
            return ProbeResult(
                wire, pr.aux_slots, pr.aux_rows, pr.hit_counts, pr.num_lookups
            )
        if not native.available():
            pr = self.probe(ls_i, master, valid=valid)
            return ProbeResult(
                pack_slots(pr.slots, geo.table_offsets, geo.trash_row, bits),
                pr.aux_slots, pr.aux_rows, pr.hit_counts, pr.num_lookups,
            )
        ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
        aux_local = (geo.ways * geo.sets).astype(np.int64)
        wire, miss_pos, miss_counts = native.probe_batch_wire(
            self.occupancy, ls_i, aux_local, geo.ways,
            bits, wire_bytes(ls_i.shape[1], bits), valid=valid,
        )
        return self._finish_native_probe(
            wire, miss_pos, miss_counts, ls_i, master, valid
        )

    def probe_dedup(
        self, ls_i: np.ndarray, master, inv_bits: int,
        valid: Optional[np.ndarray] = None,
    ) -> DedupProbeResult:
        """Probe with duplicate-slot coalescing: each lookup resolves to a
        table-local first-seen RANK (bit-packed at ``inv_bits``) into a
        per-table unique-slot list. The device then segment-sums duplicate
        gradients into a small [U, D] operand and scatters only U rows —
        attacking the per-update scatter cost. Misses
        keep their distinct aux slots (reference model_no_ddp.py:176-185),
        so dedup never merges miss rows.

        Native fast path fuses probe+dedup+pack in one pass; the numpy
        fallback derives identical (first-seen) ranks from ``probe``."""
        geo = self.geo
        t_count, n = ls_i.shape
        if (1 << inv_bits) - 1 < n:
            raise ValueError(
                f"inv_bits={inv_bits} cannot rank {n} lookups per table "
                f"(need >= {wire_width(n - 1)})"
            )
        inv_bytes = wire_bytes(n, inv_bits)
        if native.available():
            ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
            aux_local = (geo.ways * geo.sets).astype(np.int64)
            if self._slot_map is not None:
                # O(1)-map dedup probe: one 4-byte gather per lookup instead
                # of the random-DRAM occupancy-line walk (DESIGN.md D10);
                # bit-identical
                inv_wire, uniq_tn, uniq_counts, miss_pos, miss_counts = (
                    native.map_probe_batch_dedup(
                        self._slot_map, self._id_bases, ls_i,
                        geo.table_offsets, aux_local, geo.aux_capacity,
                        inv_bits, inv_bytes, self._dedup_scratch(),
                        valid=valid,
                    )
                )
            else:
                inv_wire, uniq_tn, uniq_counts, miss_pos, miss_counts = (
                    native.probe_batch_dedup(
                        self.occupancy, ls_i, aux_local, geo.aux_capacity,
                        geo.table_offsets, geo.ways, inv_bits, inv_bytes,
                        self._dedup_scratch(), valid=valid,
                    )
                )
            base = self._finish_native_probe(
                None, miss_pos, miss_counts, ls_i, master, valid
            )
            uniq = np.concatenate(
                [uniq_tn[t, : uniq_counts[t]] for t in range(t_count)]
            ) if t_count else np.zeros(0, np.int32)
            return DedupProbeResult(
                inv_wire, uniq, uniq_counts, base.aux_slots, base.aux_rows,
                base.hit_counts, base.num_lookups,
            )

        # numpy fallback: derive first-seen ranks from the plain probe
        # (bit-identical to the native kernel; tests/test_native.py)
        pr = self.probe(ls_i, master, valid=valid)
        sent_mark = np.int32(-1)
        ranks = np.full((t_count, n), sent_mark, dtype=np.int32)
        uniq_parts: List[np.ndarray] = []
        uniq_counts = np.zeros(t_count, dtype=np.int64)
        for t in range(t_count):
            s = pr.slots[t]
            pos_valid = (
                np.arange(n) if valid is None else np.flatnonzero(valid[t])
            )
            sv = s[pos_valid]
            u_sorted, first_pos, inv_sorted = np.unique(
                sv, return_index=True, return_inverse=True
            )
            order = np.argsort(first_pos, kind="stable")
            rank_of_sorted = np.empty(u_sorted.size, np.int32)
            rank_of_sorted[order] = np.arange(u_sorted.size, dtype=np.int32)
            ranks[t, pos_valid] = rank_of_sorted[inv_sorted]
            uniq_parts.append(u_sorted[order].astype(np.int32))
            uniq_counts[t] = u_sorted.size
        inv_wire = pack_slots(
            ranks, np.zeros(t_count, np.int64), int(sent_mark), inv_bits
        )
        uniq = (
            np.concatenate(uniq_parts) if uniq_parts else np.zeros(0, np.int32)
        )
        return DedupProbeResult(
            inv_wire, uniq, uniq_counts, pr.aux_slots, pr.aux_rows,
            pr.hit_counts, pr.num_lookups,
        )

    def probe_dedup_raw(
        self, ls_i: np.ndarray, master,
        valid: Optional[np.ndarray] = None, sort: bool = False,
    ) -> DedupProbeResult:
        """:meth:`probe_dedup` in the UNPACKED wire format: ``inv_wire`` is
        a raw int32 [T, N] array of table-local first-seen ranks (-1 =
        masked), not a bitstream. For fast host links (PCIe) the device then
        skips the wire decode entirely. The native
        kernel emits this directly — an LSB-first bitstream at 32 bits IS a
        little-endian int32 array.

        ``sort=True`` (Config.sorted_dedup_wire): unique slots are emitted
        in ASCENDING slot order instead of first-seen order, with ranks
        remapped accordingly. Because each table's slots (resident + aux)
        live in its own ascending block and the trash row is the global
        maximum, the concatenated list is then globally sorted — the device
        scatter/gather then read ascending rows.
        Numerically exact: segments keep their contents, only their bucket
        positions permute."""
        n = ls_i.shape[1]
        dr = self.probe_dedup(ls_i, master, inv_bits=32, valid=valid)
        ranks = np.ascontiguousarray(
            dr.inv_wire[:, : 4 * n]
        ).view(np.int32).reshape(ls_i.shape[0], n)
        uniq = dr.uniq
        if sort and uniq.size:
            if native.available():
                # one linear rank-remap pass + tiny per-table sorts in place
                # of the numpy argsort + fancy-index path below;
                # bit-identical (tests/test_torch_host.py)
                uniq = np.ascontiguousarray(uniq, dtype=np.int32)
                native.sort_dedup_wire(ranks, uniq, dr.uniq_counts)
            else:
                # table blocks are disjoint ascending, so ONE stable global
                # argsort is a per-table sort; ranks are table-local,
                # remapped through the within-table permutation
                order = np.argsort(uniq, kind="stable")
                uniq = uniq[order]
                perm_inv = np.empty(order.size, np.int32)
                perm_inv[order] = np.arange(order.size, dtype=np.int32)
                base = np.zeros(dr.uniq_counts.size, np.int64)
                np.cumsum(dr.uniq_counts[:-1], out=base[1:])
                g = ranks + base[:, None]
                masked = ranks < 0
                ranks = np.where(
                    masked, np.int32(-1),
                    perm_inv[np.where(masked, 0, g)]
                    - base[:, None].astype(np.int32),
                ).astype(np.int32)
        return DedupProbeResult(
            ranks, uniq, dr.uniq_counts, dr.aux_slots, dr.aux_rows,
            dr.hit_counts, dr.num_lookups,
        )

    def _finish_native_probe(
        self, slots_like, miss_pos, miss_counts, ls_i, master, valid
    ) -> ProbeResult:
        """Shared tail of the native probe paths: aux-capacity guard, packed
        aux slot/row assembly (misses in batch order, reference
        model_no_ddp.py:176-185), hit-count / lookup accounting."""
        geo = self.geo
        t_count, b = ls_i.shape
        if miss_counts.max(initial=0) > geo.aux_capacity:
            t = int(np.argmax(miss_counts))
            raise ValueError(
                f"table {t}: {int(miss_counts[t])} misses exceed aux capacity "
                f"{geo.aux_capacity}; raise --aux-capacity"
            )
        aux_slot_parts, aux_row_parts = [], []
        for t in range(t_count):
            n_miss = int(miss_counts[t])
            if n_miss:
                aux_slot_parts.append(
                    (self._aux_bases[t] + np.arange(n_miss)).astype(np.int32)
                )
                aux_row_parts.append(master.gather(t, ls_i[t][miss_pos[t, :n_miss]]))
        if aux_slot_parts:
            aux_slots = np.concatenate(aux_slot_parts)
            aux_rows = np.concatenate(aux_row_parts)
        else:
            aux_slots = np.zeros(0, dtype=np.int32)
            aux_rows = np.zeros((0, geo.dim), dtype=np.float32)
        if valid is not None:
            n_valid = valid.sum(axis=1)
            num_lookups = int(n_valid.sum())
            hit_counts = (n_valid - miss_counts).astype(np.int64)
        else:
            num_lookups = t_count * b
            hit_counts = (b - miss_counts).astype(np.int64)
        return ProbeResult(slots_like, aux_slots, aux_rows, hit_counts, num_lookups)

    def _probe_native(
        self, ls_i: np.ndarray, master, valid: Optional[np.ndarray]
    ) -> ProbeResult:
        geo = self.geo
        ls_i = np.ascontiguousarray(ls_i, dtype=np.int64)
        slots, miss_pos, miss_counts = native.probe_batch(
            self.occupancy, ls_i, geo.table_offsets, self._aux_bases,
            geo.ways, geo.trash_row, valid=valid,
        )
        return self._finish_native_probe(
            slots, miss_pos, miss_counts, ls_i, master, valid
        )

    # ----------------------------------------------------------------- insert
    def count_misses(
        self, ls_i: np.ndarray, valid: Optional[np.ndarray] = None
    ) -> int:
        """Total miss count of one probe batch [T, N] against the CURRENT
        occupancy — the residency half of :meth:`probe` without slot/aux/row
        work. Read-only and deterministic, so every multi-host peer computes
        identical values from the shared index stream + identical occupancy
        metadata: the basis of the per-window negotiated aux bucket
        (trainer._window_buckets) that replaces the worst-case
        T * aux_capacity staging shape."""
        if self._slot_map is not None:
            ids = self._map_ids(ls_i, valid)
            miss = self._slot_map[ids + self._id_bases[:, None]] < 0
            if valid is not None:
                miss &= valid
            return int(miss.sum())
        geo = self.geo
        total = 0
        for t in range(ls_i.shape[0]):
            idx = ls_i[t].astype(np.int32, copy=False)
            occ = self.occupancy[t][idx % np.int32(geo.sets[t])]  # [N, ways]
            miss = ~(occ == idx[:, None]).any(axis=1)
            if valid is not None:
                miss &= valid[t]
            total += int(miss.sum())
        return total

    def count_dedup_uniques(
        self, ls_i: np.ndarray, valid: Optional[np.ndarray] = None
    ) -> int:
        """Exact per-batch unique-slot count of the dedup wire
        (probe_dedup's sum(uniq_counts)); see count_probe_stats."""
        return self.count_probe_stats(ls_i, valid=valid)[1]

    def resident_slots(self, t: int, ids: np.ndarray) -> np.ndarray:
        """Global cache rows currently holding ``ids`` of table ``t``
        (-1 = not resident). Read-only; used by the shadow hot-set selection
        (cache/prefetcher.py) and the cold-count stats below."""
        geo = self.geo
        ids = np.asarray(ids)
        if self._slot_map is not None:
            end = (
                self._id_bases[t + 1]
                if t + 1 < self._id_bases.size
                else self._slot_map.shape[0]
            )
            if ids.size and (
                int(ids.max()) >= end - self._id_bases[t] or int(ids.min()) < 0
            ):
                raise ValueError(
                    f"table {t}: lookup id out of range "
                    f"[0, {int(end - self._id_bases[t])})"
                )
            return self._slot_map[self._id_bases[t] + ids].astype(np.int64)
        idx = ids.astype(np.int32, copy=False)
        sets_t = np.int32(geo.sets[t])
        set_idx = idx % sets_t
        eq = self.occupancy[t][set_idx] == idx[:, None]
        hit = eq.any(axis=1)
        way = eq.argmax(axis=1)
        slot = geo.table_offsets[t] + way.astype(np.int64) * sets_t + set_idx
        return np.where(hit, slot, -1)

    def count_probe_stats(
        self,
        ls_i: np.ndarray,
        valid: Optional[np.ndarray] = None,
        want_uniq: bool = True,
        hot_slots: Optional[np.ndarray] = None,
    ) -> Tuple[int, int, int]:
        """One residency pass returning (misses, dedup uniques, cold
        lookups) of a probe batch [T, N] against CURRENT occupancy.

        Uniques (``want_uniq``) = per table, distinct RESIDENT ids (each
        maps to one distinct slot) + every MISSING occurrence (distinct aux
        slots — reference model_no_ddp.py:176-185: dedup never merges miss
        rows); 0 when not requested. Cold (``hot_slots`` given, SORTED
        global rows) = valid lookups whose resolved slot is NOT in the hot
        set — misses always count (aux slots are never hot); 0 when no hot
        set. Pure function of host-identical state, so every multi-host
        peer derives the same per-window buckets with zero communication
        (trainer._apply_window_stats)."""
        miss_total = 0
        uniq_total = 0
        cold_total = 0
        for t in range(ls_i.shape[0]):
            ids = ls_i[t] if valid is None else ls_i[t][valid[t]]
            if ids.size == 0:
                continue
            slots = self.resident_slots(t, ids)
            resident = slots >= 0
            n_miss = int((~resident).sum())
            miss_total += n_miss
            if want_uniq:
                uniq_total += int(np.unique(ids[resident]).size) + n_miss
            if hot_slots is not None:
                if hot_slots.size:
                    rs = slots[resident]
                    pos = np.searchsorted(hot_slots, rs)
                    pos = np.minimum(pos, hot_slots.size - 1)
                    n_hot = int((hot_slots[pos] == rs).sum())
                else:
                    n_hot = 0
                cold_total += ids.size - n_hot
        return miss_total, uniq_total, cold_total

    def clone(self) -> "HostCacheController":
        """Deep copy for the prefetcher's shadow planner: occupancy, RNG
        state, and slot map all duplicated so the shadow can advance the
        deterministic occupancy trajectory ahead of the trainer without
        touching the live probe state."""
        other = HostCacheController.__new__(HostCacheController)
        other.geo = self.geo
        other.occupancy = [o.copy() for o in self.occupancy]
        other.rng = np.random.Generator(np.random.SFC64())
        other.rng.bit_generator.state = self.rng.bit_generator.state
        other._aux_bases = self._aux_bases
        other._rank_scratch = None
        other._id_bases = self._id_bases
        other._slot_map = (
            None if self._slot_map is None else self._slot_map.copy()
        )
        return other

    def plan_insert(
        self,
        uniques: Sequence[np.ndarray],
        rows: Sequence[np.ndarray],
    ) -> InsertPlan:
        """Insert a lookahead window's unique indices; mutate occupancy.
        Convenience wrapper: :meth:`plan_insert_spec` + row join."""
        spec = self.plan_insert_spec(uniques)
        return build_insert_plan(spec, rows, self.geo.dim)

    def plan_insert_spec(
        self, uniques: Sequence[np.ndarray]
    ) -> InsertPlanSpec:
        """Insert a lookahead window's unique indices; mutate occupancy.

        Reference policy (CacheEmbeddings, main_no_ddp.py:148-209):
        1. drop uniques already resident (hits);
        2. ways holding CURRENT-WINDOW hits are protected; all other ways —
           free or occupied by older entries — are fair game;
        3. drop miss uniques whose set has no unprotected way;
        4. assign each remaining candidate a uniformly-random DISTINCT
           unprotected way of its set (seeded, reproducible; see the inline
           note — a deliberate upgrade over the reference's collision-prone
           independent Categorical samples, main_no_ddp.py:183-185);
        5. entries already resident in a sampled way are evicted: their
           original id + live device row go back to the master
           (writeback happens off this thread, cache/prefetcher.py).
        Vectorized last-write-wins on duplicate (set, way) targets, matching
        the reference's vectorized scatter.

        Row values are NOT consumed: the returned spec joins them later
        (``build_insert_plan``), so the shadow planner can run where only the
        index stream is available (multi-host sharded masters).
        """
        geo = self.geo
        ins_slots, ins_tables, ins_ids, ins_pos = [], [], [], []
        ev_slots, ev_tables, ev_idxs = [], [], []
        for t in range(geo.num_tables):
            u = np.asarray(uniques[t], dtype=np.int32)
            if u.size == 0:
                continue
            occ = self.occupancy[t]
            sets_t = np.int32(geo.sets[t])
            set_idx = u % sets_t
            eq = occ[set_idx] == u[:, None]  # [U, ways]
            hit = eq.any(axis=1)
            hit_sets = set_idx[hit]
            hit_ways = eq[hit].argmax(axis=1)

            # protection mask: True = way may be (re)assigned
            avail = np.ones(occ.shape, dtype=bool)
            avail[hit_sets, hit_ways] = False

            miss = ~hit
            cand_u = u[miss]
            cand_set = set_idx[miss]
            cand_rowpos = np.nonzero(miss)[0]  # position in the uniques array
            if cand_u.size == 0:
                continue

            # Conflict-free uniform way assignment (intentional upgrade over
            # the reference: its independent Categorical samples,
            # main_no_ddp.py:183-185, let two same-set candidates collide on
            # one way, silently dropping an insert; we assign DISTINCT
            # available ways — identical distribution when a set has a single
            # candidate, strictly higher insert yield otherwise):
            # candidates get a random rank within their set; each set's
            # available ways are randomly permuted; rank r takes the r-th
            # permuted way; ranks beyond the available count are dropped.
            order = np.lexsort((self.rng.random(cand_set.size), cand_set))
            cand_u = cand_u[order]
            cand_set = cand_set[order]
            cand_rowpos = cand_rowpos[order]
            is_first = np.ones(cand_set.size, dtype=bool)
            is_first[1:] = cand_set[1:] != cand_set[:-1]
            group_start = np.flatnonzero(is_first)
            group_len = np.diff(np.append(group_start, cand_set.size))
            ranks = np.arange(cand_set.size) - np.repeat(group_start, group_len)

            # random way permutations ONLY for sets that have candidates
            # (generating keys for all sets is O(sets*ways) RNG per refill)
            need_sets = cand_set[is_first]  # unique candidate sets, sorted
            need_avail = avail[need_sets]  # [S, ways]
            keys = self.rng.random(need_avail.shape)
            keys[~need_avail] = np.inf
            perm = np.argsort(keys, axis=1)  # available ways first, random order
            n_avail = need_avail.sum(axis=1)
            # position of each candidate's set within need_sets
            set_pos = np.cumsum(is_first) - 1
            keep = ranks < n_avail[set_pos]
            if not keep.any():
                continue
            ways_assign = perm[set_pos[keep], ranks[keep]]
            cand_u = cand_u[keep]
            cand_set = cand_set[keep]
            cand_rowpos = cand_rowpos[keep]

            # evictions: assigned ways currently holding an older entry
            old = occ[cand_set, ways_assign]
            evicting = old != -1
            if evicting.any():
                e_set = cand_set[evicting]
                e_way = ways_assign[evicting]
                ev_slots.append(
                    (geo.table_offsets[t] + e_way * sets_t + e_set).astype(np.int32)
                )
                ev_tables.append(np.full(e_set.size, t, dtype=np.int32))
                ev_idxs.append(old[evicting])

            # commit: occupancy + insert bookkeeping
            occ[cand_set, ways_assign] = cand_u
            new_slots = (
                geo.table_offsets[t] + ways_assign * sets_t + cand_set
            ).astype(np.int32)
            ins_slots.append(new_slots)
            ins_tables.append(np.full(cand_u.size, t, dtype=np.int32))
            ins_ids.append(cand_u.astype(np.int64))
            ins_pos.append(cand_rowpos.astype(np.int64))
            if self._slot_map is not None:
                # evicted ids leave; inserted ids take their (set, way) rows.
                # Evicted and inserted id sets are disjoint (candidates are
                # misses, old occupants are resident), so order is free.
                base = self._id_bases[t]
                if evicting.any():
                    self._slot_map[base + old[evicting].astype(np.int64)] = -1
                self._slot_map[base + cand_u.astype(np.int64)] = new_slots

        insert_slots = _cat(ins_slots, np.int32)
        insert_tables = _cat(ins_tables, np.int32)
        insert_ids = _cat(ins_ids, np.int64)
        insert_pos = _cat(ins_pos, np.int64)
        evict_slots = _cat(ev_slots, np.int32)
        evict_tables = _cat(ev_tables, np.int32)
        evict_idxs = _cat(ev_idxs, np.int64)

        # Duplicate (set, way) assignments within a window resolve
        # last-write-wins in the occupancy (numpy fancy assignment above);
        # the device scatter must agree, and jnp's .at[].set leaves duplicate
        # order undefined — so dedupe here, keeping the LAST write per slot.
        if insert_slots.size:
            _, last = np.unique(insert_slots[::-1], return_index=True)
            keep = insert_slots.size - 1 - last
            insert_slots = insert_slots[keep]
            insert_tables = insert_tables[keep]
            insert_ids = insert_ids[keep]
            insert_pos = insert_pos[keep]
        if evict_slots.size:
            _, first = np.unique(evict_slots, return_index=True)
            evict_slots = evict_slots[first]
            evict_tables = evict_tables[first]
            evict_idxs = evict_idxs[first]

        return InsertPlanSpec(
            insert_slots=insert_slots,
            insert_tables=insert_tables,
            insert_ids=insert_ids,
            insert_pos=insert_pos,
            evict_slots=evict_slots,
            evict_tables=evict_tables,
            evict_idxs=evict_idxs,
            rng_state=self.rng.bit_generator.state,
        )

    def apply_plan_spec(self, spec: InsertPlanSpec) -> None:
        """Replay a shadow-planned spec's occupancy/slot-map mutations onto
        THIS controller (no RNG draws — the spec's ``rng_state`` re-syncs the
        generator so a later checkpoint resumes the same plan trajectory).
        Equivalent postcondition to having called :meth:`plan_insert_spec`
        with the same pre-state (pinned in tests/test_cache.py)."""
        geo = self.geo
        for t in range(geo.num_tables):
            sel = spec.insert_tables == t
            if not sel.any():
                continue
            sets_t = np.int64(geo.sets[t])
            local = spec.insert_slots[sel].astype(np.int64) - geo.table_offsets[t]
            way, set_idx = np.divmod(local, sets_t)
            self.occupancy[t][set_idx, way] = spec.insert_ids[sel].astype(
                np.int32
            )
        if self._slot_map is not None:
            ev = spec.evict_idxs
            if ev.size:
                self._slot_map[
                    self._id_bases[spec.evict_tables.astype(np.int64)] + ev
                ] = -1
            if spec.insert_slots.size:
                self._slot_map[
                    self._id_bases[spec.insert_tables.astype(np.int64)]
                    + spec.insert_ids
                ] = spec.insert_slots
        if spec.rng_state is not None:
            self.rng.bit_generator.state = spec.rng_state

    # ---- checkpointing ----
    def state_dict(self) -> dict:
        return {f"occ_{t}": o for t, o in enumerate(self.occupancy)}

    def load_state_dict(self, state: dict) -> None:
        for t in range(len(self.occupancy)):
            self.occupancy[t][...] = state[f"occ_{t}"]
        self.rebuild_slot_map()
