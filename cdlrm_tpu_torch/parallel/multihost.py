"""Multi-host execution, the counterpart of cdlrm_tpu/parallel/multihost.py:
row-sharded master tables and the row exchanges between their owners.

cdlrm_tpu runs one process per host over ``n_local`` devices; the port runs
one process per device (parallel/mesh.py), so here a host is a rank: rank
``r`` of ``world`` owns :class:`RowShard` ``(r, world)``, the contiguous row
range ``[r*n/world, (r+1)*n/world)`` of every table, and a machine with k
cards runs k ranks. Every rank streams the same index stream, so window
uniques, occupancy and insert plans are the same everywhere with no
coordination; only row values move between ranks:

- :class:`ShardedMasterTables` materializes only the owned rows, with
  procedurally seeded values (a block hash), so every rank count gives the
  same value for a (table, id): an N-rank run computes what cdlrm_tpu
  computes on any N devices, and what one process with
  ``master_init='virtual'`` computes. The prefetcher gathers owned rows
  only. Evicted rows reach every rank through the refill's broadcast from
  rank 0, and each writes back the rows it owns.
- :func:`exchange_window_rows`: one :meth:`DpGroup.all_gather_host` per
  lookahead window reassembles the window's full rows on every rank (the
  train misses of that window are served from them, :class:`WindowRowStore`),
  with the AdaGrad master state's accumulators as one more column.
- :class:`GlobalRowExchange`: eval misses can fall outside any window; two
  all-gathers per eval batch route each request to the rank that owns it.
- :func:`initialize_distributed` joins the group through the coordinator's
  ``host:port``.

Every exchange is a collective whose operands must have one shape on every
rank, so the train thread calls them, at points that are the same on every
rank. The pure parts (packing, owner maps, assembly) are functions of data
every rank holds and are tested at any simulated rank count without a group.
tests/test_torch_host.py and tests/test_torch_multihost.py hold this module
equal to cdlrm_tpu's.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cdlrm_tpu_torch.cache.master import _DirtyTracker
from cdlrm_tpu_torch.ops import native
from cdlrm_tpu_torch.parallel.mesh import BACKENDS, DpGroup


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 1800.0,
) -> Tuple[int, int]:
    """Join the process group through ``tcp://coordinator_address`` (rank 0's
    ``host:port``) as rank ``process_id`` of ``num_processes``; either left
    None is read from ``RANK`` / ``WORLD_SIZE``. Returns (rank, world size).
    A group already joined is kept; one process, or no address, joins none.
    ``backend`` defaults by ``device`` as parallel/mesh.py's does: ``nccl``
    for a CUDA device, ``gloo`` for the CPU (and by name for ranks that
    share a card)."""
    if not dist.is_initialized() and coordinator_address:
        world = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", 1))
        if world > 1:
            if process_id is None:
                if "RANK" not in os.environ:
                    raise ValueError(
                        f"{world} processes: give this one its rank (--host-id, or RANK "
                        "in the environment)"
                    )
                process_id = int(os.environ["RANK"])
            if backend is None:
                backend = "nccl" if torch.device(device or "cpu").type == "cuda" else "gloo"
            if backend not in BACKENDS:
                raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator_address}", world_size=world,
                rank=process_id, timeout=datetime.timedelta(seconds=timeout_s),
            )
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def check_hosts(num_hosts: int, host_id: int, world: int, rank: Optional[int] = None) -> None:
    """Refuse host fields that disagree with the group: the port runs one
    process per card, so cdlrm_tpu's hosts are the ranks. ``num_hosts`` and
    ``host_id`` at -1 mean "from the environment" and pass."""
    if num_hosts > 0 and num_hosts != world:
        raise ValueError(
            f"num_hosts={num_hosts} with world_size={world}: cdlrm_tpu_torch runs one "
            "process per card, so its hosts are the ranks and --num-hosts must equal "
            "--world-size"
        )
    if rank is not None and host_id >= 0 and host_id != rank:
        raise ValueError(
            f"host_id={host_id} in a process of rank {rank}: cdlrm_tpu_torch runs one "
            "process per card, so the host id is the rank"
        )


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
        np.savez(path, **self.dirty_payload(init_token))

    def dirty_payload(self, init_token: int = 0) -> dict:
        """The :meth:`save_dirty` payload as a snapshot (row copies), which a
        checkpoint writer thread may serialize while writebacks go on."""
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
        return payload

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


class WindowRowStore:
    """Full (exchanged) rows of the current lookahead window, servable by id.

    Serves train-step misses in multi-host mode: every train index of window
    k is in window k's uniques by construction, so ``gather`` is a
    searchsorted into the sorted unique array. Matches the master-direct miss
    fetch of the single-host path up to the already-documented staleness
    window (DESIGN.md D1: miss rows are as fresh as window-gather time)."""

    def __init__(self, uniques: Sequence[np.ndarray], rows: Sequence[np.ndarray]):
        self.uniques = uniques
        self.rows = rows

    def gather(self, t: int, ids: np.ndarray) -> np.ndarray:
        u = self.uniques[t]
        if u.size == 0:
            # keep the alignment diagnostic (an empty-array fancy index would
            # raise a bare IndexError instead)
            if ids.size:
                raise KeyError(
                    f"table {t}: ids {ids[:5]} not in current lookahead window "
                    "(empty window — train batches must align with prefetch "
                    "windows)"
                )
            return self.rows[t][:0]
        pos = np.searchsorted(u, ids)
        bad = (pos >= u.size) | (u[np.minimum(pos, u.size - 1)] != ids)
        if bad.any():
            raise KeyError(
                f"table {t}: ids {ids[bad][:5]} not in current lookahead window "
                "(train batches must align with prefetch windows)"
            )
        return self.rows[t][pos]


def pack_window_rows(
    master: ShardedMasterTables,
    uniques: Sequence[np.ndarray],
    owned_rows: Sequence[np.ndarray],
    owned_accs: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """This rank's operand of the window exchange (cdlrm_tpu
    parallel/multihost.py:310-361): its owned rows of every table's sorted
    uniques, concatenated table after table into ``[pad_to, dim (+1)]``,
    zero-padded to the largest rank's count, and the per-table owner bounds
    of the uniques. Every rank computes the same bounds and ``pad_to`` from
    the uniques alone, so the all-gather needs no metadata. ``owned_accs``
    (the AdaGrad master state): the owned accumulators as one more column."""
    H = master.shard.num_hosts
    nt = len(uniques)
    dim = master.dim
    width = dim + (1 if owned_accs is not None else 0)
    # per-host per-table slice boundaries (identical on every host)
    bounds = [master.shard.bounds(uniques[t], master.ln_emb[t]) for t in range(nt)]
    per_host_total = np.array(
        [sum(int(bounds[t][h + 1] - bounds[t][h]) for t in range(nt)) for h in range(H)],
        dtype=np.int64,
    )
    pad_to = int(per_host_total.max())
    me = master.shard.host_id
    packed = np.zeros((pad_to, width), np.float32)
    mine = [owned_rows[t] for t in range(nt) if owned_rows[t].shape[0]]
    if mine:
        cat = np.concatenate(mine)
        if cat.shape[0] != per_host_total[me]:
            raise ValueError(
                f"{cat.shape[0]} owned window rows, the uniques' owner bounds give "
                f"{per_host_total[me]}"
            )
        packed[: cat.shape[0], :dim] = cat
        if owned_accs is not None:
            packed[: cat.shape[0], dim] = np.concatenate(
                [owned_accs[t] for t in range(nt) if owned_rows[t].shape[0]]
            )
    return packed, bounds


def unpack_window_rows(
    master: ShardedMasterTables,
    bounds: Sequence[np.ndarray],
    gathered: np.ndarray,
    with_accs: bool = False,
):
    """Every table's full window rows from the gathered ``[H, pad_to, width]``
    operands (cdlrm_tpu parallel/multihost.py:362-389): table t's rows are
    rank 0's slice, then rank 1's, ... in sorted-unique order. Returns the
    rows, or (rows, accs) ``with_accs``."""
    H = master.shard.num_hosts
    dim = master.dim
    full: List[np.ndarray] = []
    full_accs: List[np.ndarray] = []
    cursors = np.zeros(H, dtype=np.int64)
    for t in range(len(bounds)):
        parts = []
        for h in range(H):
            n = int(bounds[t][h + 1] - bounds[t][h])
            parts.append(gathered[h, cursors[h]: cursors[h] + n])
            cursors[h] += n
        if with_accs:
            # slice the column split BEFORE concatenating: one contiguous
            # copy per output instead of concat + a second full-row copy
            full.append(np.concatenate([p[:, :dim] for p in parts]))
            full_accs.append(np.concatenate([p[:, dim] for p in parts]))
        else:
            full.append(np.concatenate(parts))
    if with_accs:
        return full, full_accs
    return full


def exchange_window_rows(
    master: ShardedMasterTables,
    uniques: Sequence[np.ndarray],
    owned_rows: Sequence[np.ndarray],
    owned_accs: Optional[Sequence[np.ndarray]] = None,
    *,
    group: DpGroup,
):
    """Reassemble full window rows from per-rank owned slices with one
    all-gather of the packed owned rows (:func:`pack_window_rows`,
    :func:`unpack_window_rows`). Transfer per rank: (H-1)/H of the window's
    rows, the replication cost of cDLRM's replicated cache. ``owned_accs``
    rides the same all-gather (one f32 column, no second collective) and
    ``(rows, accs)`` is returned. With one rank it is the identity."""
    if master.shard.num_hosts == 1:
        if owned_accs is not None:
            return list(owned_rows), list(owned_accs)
        return list(owned_rows)
    packed, bounds = pack_window_rows(master, uniques, owned_rows, owned_accs)
    gathered = group.all_gather_host(packed)  # [H, pad_to, width]
    return unpack_window_rows(master, bounds, gathered, with_accs=owned_accs is not None)


class GlobalRowExchange:
    """Cross-host row fetch for ids outside the current window (eval misses).

    Request-routed, two collectives per call, every host's sequence aligned:

    1. allgather everyone's request (table, id) lists — O(H * cap) int64s.
    2. each host packs ONLY the rows it OWNS across all requests (ownership
       is a pure function of the id, so after step 1 every host knows the
       exact packing layout of every other host with zero metadata
       exchange); one allgather of those packed rows — O(H * cap * dim)
       received bytes per host, vs the O(H^2 * cap * dim) of a
       contribution-matrix exchange (each uniformly-sharded host owns ~1/H
       of each requester's cap, so its payload is ~cap rows TOTAL across
       all H requesters).

    The per-call payload shape (max owned count over hosts) is data-dependent
    but identical on every host — the same symmetric-varying-shape pattern as
    exchange_window_rows. Here a host is a rank of ``group``."""

    def __init__(self, master: ShardedMasterTables, capacity: int,
                 group: Optional[DpGroup] = None):
        self.master = master
        self.capacity = int(capacity)
        self.group = group

    # -- pure parts (unit-testable at any simulated H without a cluster) ----
    def _pack_requests(self, requests: List[Tuple[int, np.ndarray]]) -> np.ndarray:
        """[(table, ids)] -> the fixed-shape [3, cap] allgather payload."""
        counts = [ids.size for _, ids in requests]
        total = int(np.sum(counts)) if counts else 0
        if total > self.capacity:
            raise ValueError(f"{total} eval miss rows exceed exchange capacity "
                             f"{self.capacity}")
        tbl = np.zeros(self.capacity, np.int64)
        ids = np.zeros(self.capacity, np.int64)
        n = 0
        for t, i in requests:
            tbl[n: n + i.size] = t
            ids[n: n + i.size] = i
            n += i.size
        return np.stack([tbl, ids, np.full_like(tbl, n)])  # [3, cap]

    def _owner_map(self, all_req: np.ndarray) -> np.ndarray:
        """[H, cap] owner of every requester slot (-1 = unused padding).
        Identical on every host — pure function of the gathered requests.
        Fully vectorized: no per-requester Python loops."""
        num_hosts = self.master.shard.num_hosts
        tbl = all_req[:, 0, :]  # [H, cap] int64
        ids = all_req[:, 1, :]
        live = np.arange(self.capacity)[None, :] < all_req[:, 2, :1]
        # per-slot table size -> per-slot shard stride (owner_of, vectorized;
        # padding slots carry table 0 and are masked out below)
        n_rows = np.asarray(self.master.ln_emb, dtype=np.int64)[tbl]
        per = -(-n_rows // num_hosts)
        owner = np.minimum(ids // per, num_hosts - 1)
        return np.where(live, owner, np.int64(-1))

    def _contribution(
        self, all_req: np.ndarray, owners: np.ndarray, pad_to: int
    ) -> np.ndarray:
        """[pad_to, dim] rows this host owns, packed in (requester, slot)
        order — the layout every peer reconstructs from `owners` alone."""
        me = self.master.shard.host_id
        # np.nonzero row-major order IS (requester, slot) order
        g_idx, s_idx = np.nonzero(owners == me)
        buf = np.zeros((pad_to, self.master.dim), np.float32)
        if g_idx.size == 0:
            return buf
        tbls = all_req[g_idx, 0, s_idx]
        ids = all_req[g_idx, 1, s_idx]
        rows = np.empty((g_idx.size, self.master.dim), np.float32)
        for t in np.unique(tbls):  # O(tables), not O(hosts * tables)
            sel = tbls == t
            rows[sel] = self.master.gather_owned_of(int(t), ids[sel])
        buf[: rows.shape[0]] = rows
        return buf

    def _assemble(self, owners: np.ndarray, gathered: np.ndarray) -> np.ndarray:
        """[cap, dim] rows answering THIS host's request, scattered back from
        each owner's packed contribution.

        My slots owned by h sit after every earlier requester's h-owned slots
        in h's buffer (the (requester, slot) packing order above); one
        grouped-rank computation + one fancy gather replaces the per-owner
        Python loop."""
        me = self.master.shard.host_id
        H = owners.shape[0]
        mine = np.zeros((self.capacity, self.master.dim), np.float32)
        my_own = owners[me]
        slots = np.flatnonzero(my_own >= 0)
        if slots.size == 0:
            return mine
        earlier = owners[:me][owners[:me] >= 0]
        base = np.bincount(earlier, minlength=H)  # earlier requesters' counts
        h_of = my_own[slots]
        order = np.argsort(h_of, kind="stable")  # group by owner, slot order
        sorted_h = h_of[order]
        group_start = np.searchsorted(sorted_h, np.arange(H))
        rank = np.arange(order.size) - group_start[sorted_h]
        mine[slots[order]] = gathered[sorted_h, base[sorted_h] + rank]
        return mine

    def fetch(self, requests: List[Tuple[int, np.ndarray]]) -> List[np.ndarray]:
        """requests: [(table, ids)] with sum(len(ids)) <= capacity. Returns
        rows aligned with each request. Every rank calls it, with or without
        requests of its own."""
        H = self.master.shard.num_hosts
        payload = self._pack_requests(requests)
        all_req = self.group.all_gather_host(payload)  # [H, 3, cap]
        owners = self._owner_map(all_req)
        # per-owner packed sizes — identical on every host, so the varying
        # payload shape stays collective-aligned
        pad_to = max(1, int(np.bincount(owners[owners >= 0], minlength=H).max(initial=0)))
        contrib = self._contribution(all_req, owners, pad_to)
        gathered = self.group.all_gather_host(contrib)  # [H, pad_to, dim]
        mine = self._assemble(owners, gathered)
        out, n = [], 0
        for t, i in requests:
            out.append(mine[n: n + i.size])
            n += i.size
        return out


class CollectingMaster:
    """Probe-time master stand-in that records miss requests instead of
    gathering (multi-host eval path): the trainer later resolves all
    recorded requests with one GlobalRowExchange.fetch and patches the
    aux_rows buffer positionally."""

    def __init__(self, dim: int):
        self.dim = dim
        self.requests: List[Tuple[int, np.ndarray]] = []

    def gather(self, t: int, ids: np.ndarray) -> np.ndarray:
        self.requests.append((t, np.asarray(ids, np.int64).copy()))
        return np.zeros((ids.size, self.dim), np.float32)
