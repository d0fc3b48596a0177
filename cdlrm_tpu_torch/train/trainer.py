"""Cached DLRM training and serving, the counterpart of
cdlrm_tpu/train/trainer.py::CachedDlrmTrainer: one device, or
``world_size`` processes that each own one device and one cache replica
(parallel/mesh.py).

The host side is this package's copy of cdlrm_tpu's (cache/, data/,
ops/native.py, train/pipeline.py, utils/): masters, the cache controller
(occupancy, probe, insert plan), the lookahead prefetcher and its shadow
planner, the eviction writeback thread, the assembly pipeline, the synthetic
and Criteo streams, metrics; tests/test_torch_host.py holds it equal to
cdlrm_tpu's. The device side: the cache
``[R, D]`` as one float32 tensor on ``device``, dense parameters as tensors,
and the train, eval and refill steps of train/step.py. The same config and
seed give the same masters, weights, probes, wire bytes and window plans as
cdlrm_tpu, so the two train the same trajectory, and a cdlrm_tpu checkpoint
serves here unchanged.

Ported: construction, ``train`` (SGD, with or without the hot tier, and
AdaGrad with its row-wise state beside the cache, optionally round-tripped
through the host ``AccumulatorStore``; the plain wire and the packed,
unpacked and sorted unpacked dedup wires, chosen per window; scan blocks of
``scan_steps`` steps, capped at window and cadence boundaries, with the
block-coalesced update on the unpacked dedup wire; the refill prestager; the
checkpoint cadence), ``evaluate`` (the pipelined ``--inference-only`` path),
``refill`` of one insert plan, ``save_checkpoint`` (cdlrm_tpu's single-host
format v3, optionally written on a background thread), ``load_checkpoint``
and ``close``: every field that cdlrm_tpu's trainer implements.

Data parallelism (``world_size`` > 1) takes the shape of cdlrm_tpu's
multi-host design: every rank streams the same batches, runs its own
prefetcher and keeps bit-identical cache metadata, probes and stages only
its slice ``[r*b_loc, (r+1)*b_loc)`` of each batch, and holds its own
masters, which stay equal because evicted rows are broadcast from rank 0
before the writeback. The train step averages the dense gradients, the
aggregate step combines the touched rows every ``table_agg_freq`` steps,
the refill broadcasts from rank 0, eval scores each rank's slice and brings
the scores together, and rank 0 alone prints, logs and writes the
checkpoint. Every collective is called by the train thread, in the same
order on every rank.

Multi-host (``coordinator_address`` set and more than one rank; cdlrm_tpu's
``jax.process_count() > 1``): a rank is cdlrm_tpu's host. Its masters are
its row shard (parallel/multihost.py), so N ranks hold one copy of the
masters between them instead of N. The prefetcher gathers owned rows, one
all-gather per window gives every rank the window's full rows, which serve
the window's train misses; the next window's exchange, plan join and copies
run after the first block of each window (the refill prestage), eval misses
are fetched from their owners by a routed exchange on the train thread, and
every rank writes its own checkpoint files beside rank 0's shared ones.
Evicted rows still reach every rank through the refill's broadcast, and each
writes back the rows it owns.

Ordering on the card: every step, refill and staging copy runs on the
device's default stream, and the host-to-device copies of the pipeline and
stager threads are synchronous (pageable memory), so each batch's and each
window's inputs are on the device before the step that reads them is even
enqueued. Evicted rows leave through a non-blocking copy into pinned memory
and an event that the eviction thread waits on.
"""

from __future__ import annotations

import functools
import json
import os
import pickle
import queue
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from cdlrm_tpu_torch.cache.geometry import CacheGeometry
from cdlrm_tpu_torch.cache.host_cache import HostCacheController, InsertPlan, build_insert_plan
from cdlrm_tpu_torch.cache.master import (
    AccumulatorStore, MasterTables, MDMasterTables, VirtualMasterTables,
)
from cdlrm_tpu_torch.cache.prefetcher import EvictionManager, LookaheadPrefetcher, WindowData
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.data.synthetic import Batch
from cdlrm_tpu_torch.ops import native
from cdlrm_tpu_torch.utils.metrics import StreamingAUC, accuracy_count
from cdlrm_tpu_torch.utils.padding import pad_to_bucket, pow2_bucket
from cdlrm_tpu_torch.models.dlrm import (
    param_leaves, init_dlrm, map_params, params_from_jax, params_to_jax,
)
from cdlrm_tpu_torch.models.tricks import xavier_uniform
from cdlrm_tpu_torch.parallel.mesh import DpGroup, local_batch_rows, make_dp_mesh
from cdlrm_tpu_torch.parallel.multihost import (
    CollectingMaster, GlobalRowExchange, RowShard, ShardedMasterTables, WindowRowStore,
    check_hosts, exchange_window_rows,
)
from cdlrm_tpu_torch.train import step as step_lib

# checkpoint layout versions this loader reads (cdlrm_tpu save_checkpoint)
CHECKPOINT_FORMAT_VERSION = 3


def use_device(device: torch.device) -> None:
    """Make ``device`` the calling thread's current CUDA device (nothing to
    do for the CPU). The kernel wrappers launch on the operands' device's
    current stream and size their grids from the current device, so every
    thread that launches CUDA work for a trainer calls this first: the current
    device is a per-thread setting. A device given without an index
    (``torch.device("cuda")``) means the current one already."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)


@dataclass
class TrainMetrics:
    """cdlrm_tpu's TrainMetrics (trainer.py:67-99)."""

    steps: int = 0
    examples: int = 0
    loss_sum: float = 0.0
    correct: float = 0.0
    train_time_s: float = 0.0
    caching_overhead_s: float = 0.0
    refills: int = 0
    hits: int = 0
    lookups: int = 0
    # eval probes are counted apart from training's
    eval_hits: int = 0
    eval_lookups: int = 0
    table_hits: Optional[np.ndarray] = None
    table_lookups: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.lookups)

    @property
    def eval_hit_rate(self) -> float:
        return self.eval_hits / max(1, self.eval_lookups)

    @property
    def per_table_hit_rates(self) -> Optional[np.ndarray]:
        if self.table_hits is None or self.table_lookups == 0:
            return None
        return self.table_hits / self.table_lookups


class _ProbeStats:
    """Per-batch train probe counters, added to TrainMetrics when the train
    loop consumes the batch, not when the pipeline probes it ahead
    (cdlrm_tpu trainer.py:102-127)."""

    __slots__ = ("hits", "lookups", "table_hits")

    def __init__(self, t_count: int):
        self.hits = 0
        self.lookups = 0
        self.table_hits = np.zeros(t_count, dtype=np.int64)

    def add(self, hit_counts: np.ndarray, num_lookups: int) -> None:
        self.hits += int(hit_counts.sum())
        self.lookups += num_lookups
        self.table_hits += hit_counts

    def commit(self, m: TrainMetrics, waiting: Optional[np.ndarray] = None) -> None:
        """Add the counts to ``m``. ``waiting`` (more than one rank: the
        lookups are the whole batch's, the hits this rank's) takes the hits
        and per-table hits instead, until the ranks add theirs up
        (``CachedDlrmTrainer._sync_hits``)."""
        m.lookups += self.lookups
        m.table_lookups += self.lookups // self.table_hits.shape[0]
        if waiting is not None:
            waiting[0] += self.hits
            waiting[1:] += self.table_hits
            return
        m.hits += self.hits
        if m.table_hits is None:
            m.table_hits = np.zeros(self.table_hits.shape[0], dtype=np.int64)
        m.table_hits += self.table_hits


class _RankHits:
    """One rank's hit counts that the other ranks have not seen yet. With
    more than one rank each probes only its batch slice: the lookups are
    known everywhere (every rank sees the whole batch), the hits are added
    up over the ranks at the print cadence, at an eval pass and at the end
    of ``train``, not at every step (cdlrm_tpu adds every replica's probe
    counts in its one process, trainer.py:1318)."""

    def __init__(self, t_count: int):
        self.train = np.zeros(1 + t_count, dtype=np.int64)  # hits, per-table hits
        self.eval_hits = 0


class _WindowStager(threading.Thread):
    """Depth-1 refill prestager (config.refill_prestage; cdlrm_tpu
    trainer.py:130-225): pops ready windows from the prefetcher and, for
    shadow-planned windows, joins the insert plan and copies its padded
    operands to the device while the previous window still trains. The
    occupancy replay (``apply_plan_spec``) stays on the train thread at the
    boundary, so plan metadata is the same with or without staging; with no
    eviction writeback in flight the trajectory is bit-identical."""

    def __init__(self, trainer):
        super().__init__(daemon=True, name="window-stager")
        self.trainer = trainer
        self.out: "queue.Queue" = queue.Queue(maxsize=1)
        # the one staged window's slot, freed when the train thread pops it
        self._slot = threading.Semaphore(1)
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()

    def _put(self, item) -> bool:
        while not self._stop_event.is_set():
            try:
                self.out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run(self) -> None:
        try:
            use_device(self.trainer.device)
            while not self._stop_event.is_set():
                try:
                    window = self.trainer.prefetcher.get_window(timeout=0.1)
                except queue.Empty:
                    continue
                if window is None:
                    break
                # wait for the depth-1 slot before staging: at most one extra
                # window's insert rows are held on the device. A semaphore
                # wakes the moment the train thread pops the staged window,
                # where cdlrm_tpu polls every 50 ms
                while not self._slot.acquire(timeout=0.1):
                    if self._stop_event.is_set():
                        return
                tr = self.trainer
                staged = None
                if window.plan_spec is not None:
                    plan = build_insert_plan(window.plan_spec, window.rows, tr.geo.dim)
                    # stage_acc=False: the resume accumulators are gathered
                    # at the boundary, behind the eviction fence
                    # (_complete_staged_acc)
                    staged = (plan, tr._refill_device_inputs(plan, stage_acc=False))
                if not self._put((window, staged)):
                    return
        except BaseException as e:
            self.error = e
        finally:
            self._put(None)

    def get(self) -> Optional[Tuple[WindowData, Optional[tuple]]]:
        """Pop (window, staged); None = stream exhausted (errors re-raised)."""
        item = self.out.get()
        self._slot.release()
        if item is None and self.error is not None:
            raise self.error
        return item

    def stop(self) -> None:
        self._stop_event.set()
        try:
            while True:
                self.out.get_nowait()
        except queue.Empty:
            pass


def _write_npz(path: str, payload: dict) -> None:
    np.savez(path, **payload)


def _write_pickle(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


class CheckpointWriter:
    """The write phase of a checkpoint save (cdlrm_tpu trainer.py:2352-2374):
    ``(fn, path, data)`` writes over a snapshot that the train thread took,
    run in place or, with ``checkpoint_async``, on a thread of its own. The
    thread is not a daemon, so a process exit that bypasses ``close()``
    waits for the files instead of cutting one short. :meth:`join` waits
    for an outstanding writer and re-raises its error; save, load and close
    call it. ``write_s`` is the last write phase's wall time."""

    def __init__(self, device: torch.device):
        self.device = device  # made current on the writer thread
        self.thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.write_s = 0.0

    def run(self, writes: list, background: bool) -> None:
        def run_writes():
            t0 = time.perf_counter()
            try:
                use_device(self.device)
                for fn, path, data in writes:
                    fn(path, data)
            except BaseException as e:  # raised at the next join
                self._error = e
            finally:
                self.write_s = time.perf_counter() - t0

        self._error = None
        if background:
            self.thread = threading.Thread(target=run_writes, name="ckpt-writer", daemon=False)
            self.thread.start()
            return
        run_writes()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def join(self) -> None:
        if self.thread is None:
            return
        self.thread.join()
        self.thread = None
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"async checkpoint write failed: {err!r}") from err


class CachedDlrmTrainer:
    """Cached DLRM on one device, or one rank of a data-parallel run:
    training and serving."""

    def __init__(self, cfg: Config, dataset, test_dataset=None, *,
                 device, pooled_width: Optional[int] = None,
                 group: Optional[DpGroup] = None):
        """``dataset`` / ``test_dataset`` expose batches() (restartable),
        __len__, m_den and ln_emb, as for cdlrm_tpu. ``device`` is where the
        cache and the dense parameters live. ``pooled_width``: P for padded
        multi-hot bags; by default read from the first training batch.
        ``group``: this rank's :class:`DpGroup` when ``cfg.world_size`` > 1;
        by default the process group the caller has already joined is
        wrapped (parallel/mesh.py::make_dp_mesh), and one replica needs
        none."""
        if cfg.ln_emb is None:
            raise ValueError(
                "call cdlrm_tpu_torch.config.finalize(cfg) (or build_dataset) first"
            )
        self.cfg = cfg
        self.dataset = dataset
        self.test_dataset = test_dataset
        self.device = torch.device(device)
        use_device(self.device)
        self.group = group if group is not None else make_dp_mesh(cfg.world_size)
        self.ndev = self.group.world_size
        if self.ndev != cfg.world_size:
            raise ValueError(
                f"the group has {self.ndev} ranks, config world_size={cfg.world_size}"
            )
        # multi-host (parallel/multihost.py): a coordinator and more than one
        # rank, where cdlrm_tpu has more than one process (trainer.py:250).
        # A rank is cdlrm_tpu's host: it owns RowShard(rank, world) of the
        # masters. One rank with a coordinator trains on one device
        self.multihost = bool(cfg.coordinator_address) and self.ndev > 1
        if self.multihost:
            check_hosts(cfg.num_hosts, cfg.host_id, self.ndev, self.group.rank)
        if self.ndev > 1 and cfg.refill_broadcast in (False, "off"):
            # every rank writes evicted rows back to masters of its own: only
            # rank 0's values, broadcast at the refill, keep them equal
            # (cdlrm_tpu's rule for multi-host runs, trainer.py:261-265)
            raise ValueError(
                "world_size > 1 (one process per device, each with its own "
                "masters) requires refill_broadcast='strict' or 'delta' "
                "(evicted-row broadcast)"
            )
        if pooled_width is None:
            first = next(iter(dataset.batches()))
            pooled_width = 0 if first.ls_mask is None else first.ls_i.shape[2]
        self.pooled_width = pooled_width

        b_loc = cfg.local_batch_size
        test_b_loc = -(-cfg.test_mini_batch_size // self.ndev)
        self._test_b_loc = test_b_loc
        aux_cap = cfg.aux_capacity if cfg.aux_capacity > 0 else (
            max(b_loc, test_b_loc) * max(1, pooled_width)
        )
        self.geo = CacheGeometry.build(
            cfg.ln_emb, cfg.m_spa, cfg.cache_size, cfg.num_ways, aux_cap
        )
        # slot wire: bit-packed table-local ids at the smallest width that
        # addresses every table's cache block (train/step.py pack_slots)
        rows_per_table = self.geo.ways * self.geo.sets + self.geo.aux_capacity
        self._wire_bits = step_lib.wire_width(int(rows_per_table.max()) - 1)
        self._wire_pack = bool(cfg.pack_wire and self._wire_bits <= step_lib.WIRE_MAX_BITS)
        # the sorted unique list rides the unpacked dedup wire only (cdlrm_tpu
        # trainer.py:527-530): the dedup steps take it, the plain ones never
        self._sorted_wire = bool(cfg.sorted_dedup_wire and not self._wire_pack)
        if cfg.qr_flag:
            # cdlrm_tpu's error (trainer.py:285-294)
            raise ValueError(
                "qr_flag with the cached path: QR-compressed tables are "
                "small by construction — train them full-resident with "
                "--no-use-cache (FullTableDlrmTrainer)"
            )

        # one generator, drawn in cdlrm_tpu's order: masters, then the dense
        # weights, then the mixed-dimension projections: the same seed gives
        # both packages the same values
        rng = np.random.default_rng(cfg.numpy_rand_seed)
        shard = RowShard(self.group.rank, self.ndev) if self.multihost else RowShard(0, 1)
        if cfg.md_flag:
            # cached mixed-dimension tables (cdlrm_tpu trainer.py:295-315):
            # compact [n_t, d_t] masters that put zero-padded [., m_spa] rows
            # on the wire; the cache stays [R, m_spa]
            if self.multihost or cfg.master_init == "virtual":
                # procedural compact masters, this rank's shard of them (one
                # whole shard on one host), so that the values match any
                # multi-host topology's
                self.master = ShardedMasterTables(
                    cfg.ln_emb, cfg.m_spa, shard, rng, dims=cfg.m_spa_per_table,
                )
            else:
                self.master = MDMasterTables(
                    cfg.ln_emb, cfg.m_spa_per_table, cfg.m_spa, rng,
                    mmap_dir=cfg.master_mmap_dir or None,
                )
        elif self.multihost:
            # row-sharded masters with procedural values, the same for any
            # rank count; master_init is ignored, as in cdlrm_tpu
            self.master = ShardedMasterTables(cfg.ln_emb, cfg.m_spa, shard, rng)
        elif cfg.master_init == "virtual":
            self.master = VirtualMasterTables(cfg.ln_emb, cfg.m_spa, rng)
        else:
            self.master = MasterTables(
                cfg.ln_emb, cfg.m_spa, rng, init=cfg.master_init,
                mmap_dir=cfg.master_mmap_dir or None,
            )
        use_map = cfg.probe_impl == "map" or (
            cfg.probe_impl == "auto"
            and int(np.sum(cfg.ln_emb)) * 4 <= cfg.slot_map_max_bytes
        )
        self.controller = HostCacheController(
            self.geo, seed=cfg.numpy_rand_seed, ln_emb=cfg.ln_emb, slot_map=use_map,
        )
        self.params = init_dlrm(rng, cfg.ln_bot, cfg.ln_top, device=self.device)
        md_mask: Tuple[float, ...] = ()
        if cfg.md_flag:
            # per-table projections [T, D, D] (cdlrm_tpu trainer.py:343-363):
            # a xavier [d_t, D] block, zero rows below it; a table of full
            # width gets a frozen identity (mask 0.0)
            dim = cfg.m_spa
            proj = np.zeros((len(cfg.ln_emb), dim, dim), np.float32)
            mask = []
            for t, d_t in enumerate(cfg.m_spa_per_table):
                if d_t == dim:
                    proj[t] = np.eye(dim, dtype=np.float32)
                    mask.append(0.0)
                else:
                    proj[t, :d_t] = xavier_uniform(rng, (int(d_t), dim))
                    mask.append(1.0)
            self.params["md_proj"] = torch.from_numpy(proj).to(self.device)
            md_mask = tuple(mask)
        self.cache = torch.zeros(
            (self.geo.total_rows, self.geo.dim), dtype=torch.float32, device=self.device
        )
        # one replica: aggregation is the identity, so the aggregate step and
        # the per-step touched marks are skipped (cdlrm_tpu trainer.py:479-481)
        self._needs_agg = self.ndev > 1
        # the rows this rank touched since the last aggregate step; uint8,
        # the type its max-reduce travels in
        self.touched = (
            torch.zeros(self.geo.total_rows, dtype=torch.uint8, device=self.device)
            if self._needs_agg else None
        )
        self._rank_hits = _RankHits(len(cfg.ln_emb)) if self.ndev > 1 else None
        # AdaGrad state (cdlrm_tpu trainer.py:381-419): one row-wise
        # accumulator per cache row, on the device beside the cache, and one
        # dense accumulator per parameter; SGD carries none
        self._adagrad = cfg.optimizer == "adagrad"
        self.embed_acc = self.dense_acc = None
        if self._adagrad:
            self.embed_acc = torch.zeros(self.geo.total_rows, dtype=torch.float32,
                                         device=self.device)
            self.dense_acc = map_params(torch.zeros_like, self.params)
        # adagrad_master_state: evicted ids' row-wise state writes back to
        # this host store with their rows, and inserted ids resume it.
        # Multi-host: sharded as the masters are; the resume values of rows
        # this rank does not own come with the window exchange, joined from
        # _mh_window_accs
        self._acc_master = (
            AccumulatorStore(cfg.ln_emb,
                             owned_ranges=self.master.ranges if self.multihost else None)
            if self._adagrad and cfg.adagrad_master_state else None
        )
        self._mh_window_accs: Optional[WindowRowStore] = None
        self._ckpt_writer = CheckpointWriter(self.device)

        # wire choice per window (cdlrm_tpu trainer.py:446-460): 'on' always
        # takes the dedup wire (packed or unpacked as the slot wire is),
        # 'auto' decides per window from the shadow stats
        # (_apply_window_stats)
        self._dedup_auto = cfg.dedup_lookups == "auto"
        self._dedup = cfg.dedup_lookups == "on"
        self._inv_bits = step_lib.wire_width(b_loc * max(1, pooled_width) - 1)
        # scan blocks of scan_steps steps (cdlrm_tpu trainer.py:531-539);
        # block_coalesced_update is resolved to a bool by Config.finalize
        self._scan_block = max(1, cfg.scan_steps)
        self._block_coalesce = bool(cfg.block_coalesced_update)
        # staging buckets: the worst cases, replaced per window by the
        # negotiated ones whenever scan blocks run (_apply_window_stats):
        # a block's batches must share the unique bucket, against which
        # _build_block_union aligns each step's rank row
        self._aux_bucket = (
            cfg.aux_bucket if cfg.aux_bucket > 0
            else len(cfg.ln_emb) * self.geo.aux_capacity
        )
        self._aux_bucket_window: Optional[int] = None
        self._dedup_bucket = pow2_bucket(
            1 + len(cfg.ln_emb) * b_loc * max(1, pooled_width), min_size=1024
        )
        self._dedup_bucket_window: Optional[int] = None
        # hot tier (cdlrm_tpu trainer.py:665-670): the window's hot list on
        # the device and its cold bucket, both from the shadow stats; H is at
        # least 8, its last position reserved for the trash row
        self._hot = max(8, cfg.hot_tier_rows) if cfg.hot_tier_rows > 0 else 0
        self._hot_slots_dev: Optional[torch.Tensor] = None
        self._cold_bucket_window: Optional[int] = None
        # shadow window stats: the negotiated buckets of scan blocks, the
        # auto-dedup decision and the hot tier read them (cdlrm_tpu
        # trainer.py:675-678)
        self._need_stats = self._scan_block > 1 or self._dedup_auto or self._hot > 0
        scfg = step_lib.StepConfig(
            interaction_op=cfg.arch_interaction_op,
            interaction_itself=cfg.arch_interaction_itself,
            loss_function=cfg.loss_function,
            loss_weights=tuple(cfg.loss_weights_list),
            loss_threshold=cfg.loss_threshold,
            table_agg_op=cfg.table_agg_op,
            strict_bias_divergence=cfg.strict_bias_divergence,
            # one replica: every refill collective is the identity
            refill_broadcast="off" if self.ndev == 1 else cfg.refill_broadcast,
            compute_dtype=cfg.compute_dtype,
            wire_pack=self._wire_pack,
            wire_bits=self._wire_bits,
            inv_bits=self._inv_bits,
            uniq_bits=self._wire_bits,
            optimizer=cfg.optimizer,
            adagrad_eps=cfg.adagrad_eps,
            adagrad_master_state=cfg.adagrad_master_state,
            wire_rows_bf16=cfg.wire_rows_bf16,
            md_proj=bool(cfg.md_flag),
            md_train_mask=md_mask,
        )
        self.step_cfg = scfg
        self._step_cache: dict = {}  # (size, dedup, coalesce[, cold]) -> step (_get_step)
        # the eval wire is always the plain slot wire (cdlrm_tpu
        # trainer.py:475-478): no dedup variant is needed to serve
        self.eval_step = step_lib.make_cached_eval_step(self.geo, scfg, self.pooled_width)
        self.refill_step = step_lib.make_refill_step(
            scfg, trash_row=self.geo.trash_row, group=self.group)
        self.agg_step = self._make_agg_step(scfg) if self._needs_agg else None
        self._probe_fn = (
            functools.partial(self.controller.probe_wire, bits=self._wire_bits)
            if self._wire_pack else self.controller.probe
        )
        # single-host staging buckets, each a running maximum (_pack_aux)
        self._bucket_run_max = {"train": 0, "eval": 0, "dedup": 0, "blk": 0}
        # block-union scratch, built on the first coalesced block
        # (_build_block_union): the static real-row mask, its word bitmap
        # for the native union, and the slot -> block rank map
        self._blk_real_mask = None
        self._blk_real_bits = None
        self._blk_rank_map = None
        self._dummy_masks: dict = {}

        # host pipeline (cdlrm_tpu trainer.py:585-606): the eviction thread
        # writes evicted rows back to the masters; the prefetcher and the
        # assembly pipeline start with the first train() call
        self.eviction_fifo: "queue.Queue" = queue.Queue(maxsize=cfg.eviction_fifo_size)
        if cfg.pin_cores:
            from cdlrm_tpu_torch.utils.affinity import pin_current_thread

            pin_current_thread(cfg.main_start_core)
        self.eviction_manager = EvictionManager(
            self.master, self.eviction_fifo,
            average_on_writeback=cfg.average_on_writeback,
            timeout=cfg.eviction_fifo_timeout,
            pin_core=cfg.main_start_core + 2 if cfg.pin_cores else None,
            acc_store=self._acc_master,
        )
        self.prefetcher: Optional[LookaheadPrefetcher] = None
        # multi-host: the current window's exchanged rows, which serve its
        # train misses, and the routed exchange of eval misses. Its capacity
        # is the operand shape of an all-gather, so the same on every rank
        # (cdlrm_tpu trainer.py:636-649)
        self._window_store: Optional[WindowRowStore] = None
        self._row_exchange = (
            GlobalRowExchange(
                self.master,
                capacity=len(cfg.ln_emb) * test_b_loc * max(1, pooled_width) * self.ndev,
                group=self.group,
            )
            if self.multihost else None
        )
        # multi-host refill prestages so far (_prefetch_next_window)
        self.mh_prefetches = 0
        self._mh_prestage = False
        self._mh_pending: Optional[tuple] = None
        self._mh_want_prefetch = False
        self._pipeline_started = False
        self._pipe = None
        self._stager = None
        self._stream_done = False
        self.global_step = 0
        # data cursor (epoch, next batch index in it): where the stream
        # resumes after load_checkpoint
        self._cursor: Tuple[int, int] = (0, 0)
        self.metrics = TrainMetrics()
        # float32 learning rates, as cdlrm_tpu holds them (jnp.float32)
        self._lr = float(np.float32(cfg.learning_rate))
        self._lr_emb = float(np.float32(cfg.lr_embeds))
        self._stop_requested = False
        self.last_window: Optional[dict] = None  # most recent print-window stats
        self._metrics_fp = None
        # rank 0 alone writes the log: the window metrics are the same on
        # every rank
        if cfg.metrics_log and self.group.rank == 0:
            log_dir = os.path.dirname(cfg.metrics_log)
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
            self._metrics_fp = open(cfg.metrics_log, "a")

    def _make_agg_step(self, scfg):
        """The aggregate step in its sparse or dense form (cdlrm_tpu
        trainer.py:548-576). Each step touches at most (global lookups per
        step) distinct slots, so ``table_agg_freq * B_glob * T * max(1, P)``
        bounds the union since the last aggregation exactly; the sparse
        exchange takes that bound (capped at the cache's rows) as a
        power-of-two bucket, or ``table_agg_bucket`` when it is given and
        large enough, and above half the cache the dense form moves fewer
        bytes."""
        cfg, rows = self.cfg, self.geo.total_rows
        union_bound = (cfg.table_agg_freq * cfg.mini_batch_size * len(cfg.ln_emb)
                       * max(1, self.pooled_width))
        if cfg.table_agg_bucket > 0:
            if cfg.table_agg_bucket < min(union_bound, rows):
                # past its bucket the sparse exchange would drop touched rows
                raise ValueError(
                    f"--table-agg-bucket {cfg.table_agg_bucket} is below the "
                    f"exact touched-union bound {min(union_bound, rows)} "
                    f"(table_agg_freq * batch * tables * pooled width, capped "
                    "at cache rows); aggregation would silently drop rows"
                )
            bucket = cfg.table_agg_bucket
        else:
            bucket = pow2_bucket(min(union_bound, rows))
        self._agg_bucket = bucket if bucket <= rows // 2 else None
        return step_lib.make_aggregate_step(
            scfg, self.group, union_bucket=self._agg_bucket, trash_row=self.geo.trash_row,
        )

    def _log_metrics(self, kind: str, payload: dict) -> None:
        if self._metrics_fp is None:
            return
        self._metrics_fp.write(json.dumps({"kind": kind, "step": self.global_step, **payload}) + "\n")
        self._metrics_fp.flush()

    def use_device(self) -> None:
        """Make this trainer's device the calling thread's current one (the
        AssemblyPipeline thread calls it before it stages its first batch)."""
        use_device(self.device)

    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        return t.to(self.device)

    def _row_wire(self, rows: np.ndarray):
        """Embedding rows on the host wire: bfloat16 with ``wire_rows_bf16``
        (rounded to nearest even by torch, numpy has no bfloat16), else the
        float32 array as it is."""
        if not self.cfg.wire_rows_bf16:
            return rows
        return torch.from_numpy(np.ascontiguousarray(rows)).to(torch.bfloat16)

    @staticmethod
    def _host_rows(rows: torch.Tensor) -> np.ndarray:
        """Rows that came off the device as a float32 numpy array: bfloat16
        rows (``wire_rows_bf16``) are widened on the host, exactly, so that
        only the transfer is halved (the masters hold float32)."""
        return rows.float().numpy()

    # -------------------------------------------------------------------- data
    def _cache_stream(self, skip: int = 0, epoch: int = 0) -> Iterator[np.ndarray]:
        """The prefetcher's view of the index stream (cdlrm_tpu
        trainer.py:711): a second pass over the same batches, dropping the
        final partial batch as the trainer does; index-only where the
        dataset offers ``index_batches``."""
        b = self.cfg.mini_batch_size
        idx_fn = getattr(self.dataset, "index_batches", None)
        if idx_fn is not None:
            kw = (
                {"epoch": epoch}
                if getattr(self.dataset, "epoch_seeded_shuffle", False)
                else {}
            )
            for ls_i in idx_fn(skip=skip, **kw):
                if ls_i.shape[1] == b:
                    yield ls_i
            return
        from cdlrm_tpu_torch.train.pipeline import _batches_from

        for batch in _batches_from(self.dataset, skip, full_size=b, epoch=epoch):
            if batch.x.shape[0] != b:
                continue
            yield batch.ls_i if batch.ls_mask is None else (batch.ls_i, batch.ls_mask)

    # ------------------------------------------------------------------ refill
    def _refill_device_inputs(self, plan: InsertPlan, stage_acc: bool = True):
        """The refill step's operands for an insert plan, padded to
        power-of-two buckets on the host (insert padding -> the trash row,
        evict padding -> row 0) and copied to the device. The one place the
        padding lives: the boundary and the _WindowStager both stage here.

        With ``adagrad_master_state`` the inserted ids' accumulators ride as
        a fourth operand, gathered from the store behind the eviction
        fence (cdlrm_tpu trainer.py:748-798): an id evicted at one boundary
        can come back at the next, and its state must include every
        writeback queued before. ``stage_acc=False`` (the _WindowStager,
        which runs beside the previous boundary and could fence before that
        boundary's evictions are even queued) leaves the fourth operand to
        :meth:`_complete_staged_acc` at the boundary."""
        ops = (
            self._to_device(pad_to_bucket(plan.insert_slots, self.geo.trash_row)),
            self._to_device(self._row_wire(pad_to_bucket(plan.insert_rows, 0.0))),
            self._to_device(pad_to_bucket(plan.evict_slots, 0)),
        )
        if self._acc_master is not None and stage_acc:
            ops = self._complete_staged_acc(plan, ops)
        return ops

    def _complete_staged_acc(self, plan: InsertPlan, d_inputs):
        """Add the resume accumulators to a staged operand tuple, on the
        train thread: the eviction fence, then the store gather (cdlrm_tpu
        trainer.py:837-851). The fence also quiesces the writer, so the
        unlocked gather reads stable arrays. Multi-host: joined from the
        window's exchanged accumulators, whose fence ran before this rank
        gave its owned slice (:meth:`_exchange_window`). No-op without
        ``adagrad_master_state`` or when the operand already rides."""
        if self._acc_master is None or len(d_inputs) == 4:
            return d_inputs
        if self.multihost:
            acc = self._join_window_accs(plan.insert_tables, plan.insert_ids)
        else:
            self.eviction_manager.flush()
            acc = self._acc_master.gather(plan.insert_tables, plan.insert_ids)
        return tuple(d_inputs) + (self._to_device(pad_to_bucket(acc, 0.0)),)

    def _exchange_window(self, window_uniques, owned_rows):
        """The multi-host window-row exchange (cdlrm_tpu trainer.py:800-825):
        one all-gather of every rank's owned rows of the window. With
        ``adagrad_master_state`` each rank's owned accumulators ride the same
        all-gather as one more column, after the eviction fence (an id
        evicted at one boundary can come back at the next, and its state must
        include every writeback queued before); the full window's
        accumulators are kept for :meth:`_join_window_accs`. Called by the
        train thread only, at points that are the same on every rank."""
        if self._acc_master is None:
            return exchange_window_rows(self.master, window_uniques, owned_rows,
                                        group=self.group)
        self.eviction_manager.flush()
        owned_accs = [self._acc_master.gather_owned_slice(t, window_uniques[t])
                      for t in range(len(window_uniques))]
        rows, accs = exchange_window_rows(self.master, window_uniques, owned_rows, owned_accs,
                                          group=self.group)
        # the store's searchsorted join and membership check serve the 1-D
        # accumulators as they serve the rows
        self._mh_window_accs = WindowRowStore(window_uniques, accs)
        return rows

    def _join_window_accs(self, tables: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Resume accumulators for an insert list, from the current window's
        exchanged ones (inserted ids are window uniques by construction)."""
        out = np.empty(ids.size, np.float32)
        for t in np.unique(tables):
            sel = tables == t
            out[sel] = self._mh_window_accs.gather(int(t), ids[sel])
        return out

    def _prefetch_next_window(self) -> None:
        """Multi-host refill prestage (cdlrm_tpu trainer.py:853-882): the next
        boundary's host half, one window early. Pops the next window while
        this one trains, exchanges its rows, joins its insert plan and copies
        the padded operands to the device. Called by the train loop after the
        first block of each window: a point that is the same on every rank,
        so the all-gather keeps the ranks' collective order, which the
        threaded _WindowStager could not. The occupancy replay stays at the
        boundary."""
        window = self.prefetcher.get_window()
        if window is None:
            self._mh_pending = (None, None, None)
            return
        rows = self._exchange_window(window.uniques, window.rows)
        staged = None
        if window.plan_spec is not None:
            plan = build_insert_plan(window.plan_spec, rows, self.geo.dim)
            staged = (plan, self._refill_device_inputs(plan))
        self._mh_pending = (window, rows, staged)
        self.mh_prefetches += 1

    def _run_refill(self, d_inputs):
        """The refill step in this trainer's form (SGD, AdaGrad, master
        state); returns (evicted rows, evicted accumulators or None)."""
        if self._acc_master is not None:
            self.cache, self.embed_acc, evicted, ev_acc = self.refill_step(
                self.cache, *d_inputs[:3], self.embed_acc, d_inputs[3]
            )
            return evicted, ev_acc
        if self._adagrad:
            self.cache, self.embed_acc, evicted = self.refill_step(
                self.cache, *d_inputs, self.embed_acc
            )
            return evicted, None
        self.cache, evicted = self.refill_step(self.cache, *d_inputs)
        return evicted, None

    def refill(self, plan: InsertPlan) -> np.ndarray:
        """Apply one insert plan (``self.controller.plan_insert``, which has
        already updated the occupancy) to the device cache through the refill
        step. Returns the evicted rows [E, D], their values before the
        insert, for the caller to write back to the masters (the evicted
        accumulators of ``adagrad_master_state`` are dropped here)."""
        use_device(self.device)
        t0 = time.perf_counter()
        evicted, _ = self._run_refill(self._refill_device_inputs(plan))
        out = self._host_rows(evicted[: plan.evict_slots.shape[0]].cpu())
        self.metrics.caching_overhead_s += time.perf_counter() - t0
        self.metrics.refills += 1
        return out

    def _deferred_host(self, rows: torch.Tensor):
        """A thunk that returns ``rows`` as a numpy array. On the card the
        copy into pinned memory starts now, behind the refill on the stream,
        and the thunk waits on an event recorded after it, so the eviction
        thread, not the train loop, pays for the transfer; the thunk holds
        ``rows`` until then. Rows of the bfloat16 row wire cross as bfloat16
        and are widened to float32 on the host."""
        if self.device.type != "cuda":
            host = self._host_rows(rows)
            return lambda: host
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def fetch(host=host, done=done, rows=rows):
            done.synchronize()
            return self._host_rows(host)

        return fetch

    def _apply_refill(self, window: WindowData, staged=None, rows_exchanged=None) -> None:
        """Refill at a window boundary (cdlrm_tpu trainer.py:884-969): replay
        the shadow-planned occupancy change, run the refill step (evicted
        rows, and with ``adagrad_master_state`` their state, are gathered
        before the insert), and queue them for writeback. Multi-host: the
        window's owned rows are exchanged first (or were, by the prestage:
        ``rows_exchanged``), and the full rows serve the window's train
        misses."""
        t0 = time.perf_counter()
        rows = window.rows
        if self.multihost:
            rows = (rows_exchanged if rows_exchanged is not None
                    else self._exchange_window(window.uniques, rows))
            self._window_store = WindowRowStore(window.uniques, rows)
        if staged is not None:
            # prestaged by the _WindowStager: plan joined, operands on the
            # device; the occupancy replay and, with adagrad_master_state,
            # the fenced resume-accumulator gather are left
            plan, d_inputs = staged
            d_inputs = self._complete_staged_acc(plan, d_inputs)
            self.controller.apply_plan_spec(window.plan_spec)
        else:
            if window.plan_spec is not None:
                plan = build_insert_plan(window.plan_spec, rows, self.geo.dim)
                self.controller.apply_plan_spec(window.plan_spec)
            else:
                plan = self.controller.plan_insert(window.uniques, rows)
            d_inputs = self._refill_device_inputs(plan)
        self._apply_window_stats(window)
        evicted, ev_acc = self._run_refill(d_inputs)
        n_evict = plan.evict_slots.shape[0]
        if n_evict:
            item = (plan.evict_tables, plan.evict_idxs, self._deferred_host(evicted[:n_evict]))
            if ev_acc is not None:
                # the evicted state leaves by the same deferred copy; the
                # EvictionManager writes a fourth element to the store
                item += (self._deferred_host(ev_acc[:n_evict]),)
            self.eviction_fifo.put(item)
        self.metrics.caching_overhead_s += time.perf_counter() - t0
        self.metrics.refills += 1

    def _apply_window_stats(self, window: WindowData) -> None:
        """Adopt the window's shadow-computed statistics (cdlrm_tpu
        trainer.py:971-1008): the negotiated staging buckets that scan blocks
        read (the window's worst per-batch miss and unique counts, as powers
        of two, capped at the worst cases), and with
        ``dedup_lookups='auto'`` the wire: the dedup wire when the window's
        unique lookups are at most 0.5 of all lookups on the packed wire, or
        0.75 on the unpacked one, whose device step skips the wire decode
        (cdlrm_tpu's thresholds). The wire changes only here, before the
        pipeline probes the window's first batch."""
        stats = window.stats
        if stats is None:
            return
        self._aux_bucket_window = min(pow2_bucket(stats.worst_miss), self._aux_bucket)
        if stats.worst_uniq > 0:
            self._dedup_bucket_window = min(
                pow2_bucket(1 + stats.worst_uniq, min_size=1024), self._dedup_bucket
            )
        if self._dedup_auto and stats.total_lookups > 0:
            thresh = 0.5 if self._wire_pack else 0.75
            self._dedup = stats.total_uniq <= thresh * stats.total_lookups
        if self._hot:
            # the window's hot list (cdlrm_tpu trainer.py:1009-1042), padded
            # with the trash row, which stays at the last position (masked
            # lookups resolve there and take no cold lane), and below it with
            # distinct rows descending from the trash row, so that a short
            # list does not repeat one row; the exactly negotiated cold bucket
            hs = window.hot_slots if window.hot_slots is not None else np.zeros(0, np.int64)
            arr = np.full(self._hot, self.geo.trash_row, np.int64)
            n = min(hs.size, self._hot - 1)
            arr[:n] = hs[:n]
            npad = self._hot - 1 - n
            if npad > 0:
                arr[n:-1] = (self.geo.trash_row - 1 - np.arange(npad)) % max(1, self.geo.trash_row)
            self._hot_slots_dev = self._to_device(np.sort(arr).astype(np.int32))
            self._cold_bucket_window = pow2_bucket(max(stats.worst_cold, 1), min_size=64)

    # ------------------------------------------------------------------- batch
    def _pack_aux(self, aux_slots_in: np.ndarray, aux_rows_in: np.ndarray, key: str):
        """Pad one batch's miss rows to a power-of-two bucket; padding targets
        the trash row. Training batches of scan blocks take the window's
        negotiated bucket, so a block's batches share it; otherwise the
        bucket is monotone (a running maximum per ``key``, 'train' or
        'eval'), like cdlrm_tpu's single-host staging (trainer.py:1045)."""
        n = aux_slots_in.shape[0]
        if self._scan_block > 1 and key == "train":
            k = (self._aux_bucket_window if self._aux_bucket_window is not None
                 else self._aux_bucket)
            if n > k:
                raise ValueError(f"{n} packed miss rows exceed aux bucket {k}; raise --aux-bucket")
        else:
            k = self._bucket_run_max[key] = max(self._bucket_run_max[key], pow2_bucket(n))
        aux_slots = np.full(k, self.geo.trash_row, dtype=np.int32)
        aux_rows = np.zeros((k, self.geo.dim), dtype=np.float32)
        aux_slots[:n] = aux_slots_in
        aux_rows[:n] = aux_rows_in
        return aux_slots, self._row_wire(aux_rows)

    def _dummy_mask(self, t_count: int, b: int) -> torch.Tensor:
        """The all-False mask of single-index batches: one device constant."""
        key = (t_count, b)
        mask = self._dummy_masks.get(key)
        if mask is None:
            mask = self._dummy_masks[key] = torch.zeros(key, dtype=torch.bool, device=self.device)
        return mask

    def _wire_x(self, x: np.ndarray) -> torch.Tensor:
        """Dense features on the host wire: float8_e4m3fn, one byte each,
        with ``wire_x_fp8`` (the step widens them at entry); else bf16 when
        computing in bf16 (the forward rounds them to bf16 first anyway),
        else float32."""
        xt = torch.from_numpy(np.ascontiguousarray(x))
        if self.cfg.wire_x_fp8:
            xt = xt.to(torch.float8_e4m3fn)
        elif self.cfg.compute_dtype == "bfloat16":
            xt = xt.to(torch.bfloat16)
        return xt

    def _local(self, batch: Batch) -> Batch:
        """This rank's slice ``[r*b_loc, (r+1)*b_loc)`` of a batch that every
        rank streams whole (cdlrm_tpu trainer.py:1305-1318); the batch itself
        on one replica."""
        if self.ndev == 1:
            return batch
        g = self.group
        return Batch(
            local_batch_rows(batch.x, g), local_batch_rows(batch.ls_i, g, axis=1),
            None if batch.ls_mask is None else local_batch_rows(batch.ls_mask, g, axis=1),
            local_batch_rows(batch.y, g),
        )

    @staticmethod
    def _num_lookups(batch: Batch) -> int:
        """The valid lookups of a whole batch, as the ranks' probes of its
        slices count them together (``ProbeResult.num_lookups``)."""
        return batch.ls_i.size if batch.ls_mask is None else int(batch.ls_mask.sum())

    def _sync_hits(self) -> None:
        """Add the ranks' waiting hit counts (train, per table, eval) into
        every rank's metrics: one small collective, on the train thread."""
        rh = self._rank_hits
        if rh is None:
            return
        local = np.concatenate([rh.train, np.array([rh.eval_hits], dtype=np.int64)])
        total = self.group.all_reduce_sum(self._to_device(local)).cpu().numpy()
        m = self.metrics
        m.hits += int(total[0])
        if m.table_hits is None:
            m.table_hits = np.zeros(total.shape[0] - 2, dtype=np.int64)
        m.table_hits += total[1:-1]
        m.eval_hits += int(total[-1])
        rh.train[:] = 0
        rh.eval_hits = 0

    def _train_master(self):
        """Where a training batch's misses come from: the masters, or in
        multi-host mode the current window's exchanged rows, which hold every
        id of the window's batches (cdlrm_tpu trainer.py:1117-1121)."""
        if not self.multihost:
            return self.master
        if self._window_store is None:
            raise RuntimeError("multi-host probe before the first refill")
        return self._window_store

    def _probe(self, batch: Batch, probe, master=None):
        """Run a host probe over one batch (pooled bags flattened, masked
        positions invalid), its misses gathered from ``master``, by default
        the masters."""
        master = self.master if master is None else master
        ls_i, mask = batch.ls_i, batch.ls_mask
        t_count = ls_i.shape[0]
        if mask is not None:
            if ls_i.shape[2] != self.pooled_width:
                raise ValueError(
                    f"batch pooled width {ls_i.shape[2]} != trainer pooled_width {self.pooled_width}"
                )
        elif self.pooled_width:
            raise ValueError("trainer built for pooled batches, got single-index")
        if mask is None:
            return probe(ls_i, master)
        return probe(ls_i.reshape(t_count, -1), master, valid=mask.reshape(t_count, -1))

    def _stage_batch(self, batch: Batch, wire: tuple, aux: tuple, train: bool) -> tuple:
        """Copy one batch's step inputs to the device, in the step's argument
        order: x, the wire's first array, the mask, the rest of the wire, the
        padded aux slots and rows, and for training the targets (uint8 0/1
        with round_targets, as on cdlrm_tpu's wire)."""
        t_count, b = batch.ls_i.shape[:2]
        mask = (
            self._dummy_mask(t_count, b) if batch.ls_mask is None
            else self._to_device(batch.ls_mask)
        )
        out = (self._to_device(self._wire_x(batch.x)), self._to_device(wire[0]), mask)
        out += tuple(self._to_device(a) for a in wire[1:] + aux)
        if train:
            y = batch.y.astype(np.uint8) if self.cfg.round_targets else batch.y
            out += (self._to_device(y),)
        return out

    def _assemble(self, batch: Batch, b_loc: int):
        """Probe and stage one training batch (cdlrm_tpu trainer.py:1272) in
        the wire the current window uses: this rank's slice of it, with the
        whole batch's lookup count. Called by the AssemblyPipeline thread;
        returns (device inputs, probe stats, dedup flag, None)."""
        if self._dedup:
            return self._assemble_dedup(batch)
        lookups = self._num_lookups(batch)
        batch = self._local(batch)
        pr = self._probe(batch, self._probe_fn, self._train_master())
        stats = _ProbeStats(batch.ls_i.shape[0])
        stats.add(pr.hit_counts, lookups)
        aux = self._pack_aux(pr.aux_slots, pr.aux_rows, "train")
        return self._stage_batch(batch, (pr.slots,), aux, train=True), stats, False, None

    def _assemble_dedup(self, batch: Batch):
        """Training batch in the dedup wire (cdlrm_tpu trainer.py:1101).
        Packed (``pack_wire``): bit-packed first-seen ranks per lookup, and
        the unique-slot list as table-local ids packed after a reserved
        trash rank at position 0, padded with the sentinel. Unpacked: int32
        ranks (-1 masked) and int32 global rows ``[trash, uniq..., trash-pad]``
        (``probe_dedup_raw``). The unique bucket is a power of two: the
        window's negotiated one under scan blocks, else a running maximum.
        The sorted wire (``sorted_dedup_wire``, unpacked only) lays the
        ascending unique rows out from position 0 instead,
        ``[uniq..., trash-pad]``, the ranks remapped by the probe (cdlrm_tpu
        trainer.py:1186-1197). With the block-coalesced update the host
        unique list rides along for _build_block_union."""
        if self._wire_pack:
            probe = functools.partial(self.controller.probe_dedup, inv_bits=self._inv_bits)
        else:
            probe = functools.partial(self.controller.probe_dedup_raw, sort=self._sorted_wire)
        lookups = self._num_lookups(batch)
        batch = self._local(batch)
        dr = self._probe(batch, probe, self._train_master())
        stats = _ProbeStats(batch.ls_i.shape[0])
        stats.add(dr.hit_counts, lookups)
        u, cnt = dr.uniq, dr.uniq_counts
        # +1 for the reserved trash rank, or on the sorted wire the trailing
        # trash slot that masked ranks point at
        if self._scan_block > 1:
            ub = (self._dedup_bucket_window if self._dedup_bucket_window is not None
                  else self._dedup_bucket)
        else:
            ub = pow2_bucket(1 + u.size, min_size=1024)
            ub = self._bucket_run_max["dedup"] = max(self._bucket_run_max["dedup"], ub)
        if u.size + 1 > ub:
            raise ValueError(f"{u.size + 1} unique slots exceed dedup bucket {ub}")
        if self._wire_pack:
            bits = self._wire_bits
            ubytes = step_lib.wire_bytes(ub, bits)
            vals = np.full(ub, -1, np.int64)  # -1 -> sentinel (trash/pad)
            vals[1: 1 + u.size] = u.astype(np.int64) - np.repeat(self.geo.table_offsets, cnt)
            if native.available():
                uniq_wire = native.pack_bits(vals, bits, ubytes)
            else:
                uniq_wire = step_lib.pack_slots(vals[None, :], np.zeros(1, np.int64), -1, bits)[0]
        else:
            uniq_wire = np.full(ub, self.geo.trash_row, np.int32)
            if self._sorted_wire:
                uniq_wire[: u.size] = u
            else:
                uniq_wire[1: 1 + u.size] = u
        aux = self._pack_aux(dr.aux_slots, dr.aux_rows, "train")
        wire = (dr.inv_wire, uniq_wire, cnt.astype(np.int32))
        blockinfo = (u, cnt, ub) if self._block_coalesce and not self._wire_pack else None
        return self._stage_batch(batch, wire, aux, train=True), stats, True, blockinfo

    # ------------------------------------------------------------------- train
    def _start_pipeline(self) -> None:
        """Start the host pipeline once (cdlrm_tpu trainer.py:1505): the
        eviction thread, the prefetcher with its shadow planner, the refill
        prestager, and the assembly pipeline all stream continuously, so
        repeated train() calls resume mid-stream with windows aligned."""
        if self._pipeline_started:
            return
        from cdlrm_tpu_torch.train.pipeline import AssemblyPipeline

        cfg = self.cfg
        epoch0, j0 = self._cursor
        self.eviction_manager.start()
        self.prefetcher = LookaheadPrefetcher(
            cache_stream_fn=self._cache_stream,
            master=self.master,
            lookahead=cfg.lookahead,
            batch_fifo_size=cfg.batch_fifo_size,
            cache_workers=cfg.cache_workers,
            nepochs=cfg.nepochs,
            pin_core=cfg.main_start_core + 1 if cfg.pin_cores else None,
            worker_pin_base=cfg.main_start_core + 3 if cfg.pin_cores else None,
            backend=cfg.prefetch_backend,
            start_epoch=epoch0,
            skip_batches=(j0 // cfg.lookahead) * cfg.lookahead,
            shadow=self.controller.clone(),
            # the window's miss, unique and cold counts and its hot list
            # (_apply_window_stats), the worst over every replica's slice:
            # the same on every rank
            stats_spec=(
                (self.ndev, cfg.local_batch_size, self._dedup or self._dedup_auto, self._hot)
                if self._need_stats else None
            ),
            skip_first_plan=(j0 % cfg.lookahead != 0),
        )
        self.prefetcher.start()
        # refill prestage: a thread on one host; multi-host, the train loop
        # itself, since the window's rows need an all-gather in the ranks'
        # common collective order (_prefetch_next_window)
        self._stager = None
        if cfg.refill_prestage and not self.multihost:
            self._stager = _WindowStager(self)
            self._stager.start()
        self._mh_prestage = cfg.refill_prestage and self.multihost
        self._pipe = AssemblyPipeline(
            self, cfg.nepochs, cfg.lookahead, max(1, cfg.pipeline_depth),
            start_epoch=epoch0, start_j=j0,
        )
        self._pipe.start()
        self._stream_done = False
        self._pipeline_started = True

    def _get_step(self, size: int, dedup: bool, coalesce: bool = False):
        """The train step for ``size`` consecutive batches (1: a single
        step; more: a scan block) in the given wire, with or without the
        block-coalesced update; built once per (size, dedup, coalesce), and
        with the hot tier per window cold bucket too, as cdlrm_tpu's compiled
        steps are (trainer.py:1575-1595). Only the dedup steps take the
        sorted wire."""
        cold = self._cold_bucket_window if self._hot else 0
        key = (size, dedup, coalesce) + ((cold,) if self._hot else ())
        fn = self._step_cache.get(key)
        if fn is None:
            scfg = self.step_cfg._replace(dedup=dedup, block_coalesce=coalesce,
                                          sorted_wire=dedup and self._sorted_wire)
            if self._hot:
                scfg = scfg._replace(hot_rows=self._hot, cold_bucket=cold)
            fn = self._step_cache[key] = step_lib.make_cached_train_step(
                self.geo, scfg, self.pooled_width, block=size, group=self.group,
            )
        return fn

    @staticmethod
    def interleave_block_inputs(inputs_list, ranks) -> list:
        """Coalesced block input order (cdlrm_tpu trainer.py:1597): each
        step's dedup inputs with its block-rank row spliced in after
        ``uniq_counts``, the order the coalesced step reads."""
        flat = []
        for i, inputs in enumerate(inputs_list):
            flat.extend(inputs[:5])
            flat.append(ranks[i])
            flat.extend(inputs[5:])
        return flat

    def _build_block_union(self, infos):
        """Host pass of the block-coalesced update (cdlrm_tpu
        trainer.py:1612, one replica), run at dispatch. ``infos``: each
        step's (unique slots, per-table counts, unique bucket). Unions the
        block's unique cache rows, aux-region and trash rows excluded, and
        emits each step's block-rank row aligned with its staged unique list
        (position 0 of the default layout, the padding, and every aux or
        trash slot rank to the pending trash row, the last). Returns the
        device tensors (rank rows [ub] int32 per step, the sorted union
        trash-padded to a power-of-two bucket [Pb] int32, its length [1]
        int32).

        The union is a bitmap over the cache's rows: the native
        kernels (``mask_bits``, ``block_union``, ``block_ranks``,
        ``block_union_reset``, cdlrm_tpu/ops/native.py:544-640) where the
        host library is available, else the numpy form, which gives the same
        output (np.flatnonzero is ascending, as the native scan is)."""
        ub = infos[0][2]
        if any(info[2] != ub for info in infos):
            # blocks never cross windows and the bucket is negotiated per
            # window, so a mismatch means that invariant broke
            raise RuntimeError(
                "dedup bucket changed within a scan block "
                f"({[info[2] for info in infos]})"
            )
        geo = self.geo
        use_native = native.available()
        if self._blk_real_mask is None:
            real = np.zeros(geo.total_rows, bool)
            for t in range(len(geo.table_offsets)):
                real[int(geo.table_offsets[t]): int(geo.aux_base(t))] = True
            self._blk_real_mask = real
            if use_native:
                self._blk_real_bits = native.mask_bits(real.astype(np.uint8))
            # slot -> block rank; -1 = not in this block's union. Reset after
            # each block (union entries only)
            self._blk_rank_map = np.full(geo.total_rows, -1, np.int32)
        rmap = self._blk_rank_map
        cat = np.concatenate([info[0] for info in infos])
        off = np.zeros(len(infos) + 1, np.int64)
        np.cumsum([info[0].size for info in infos], out=off[1:])
        union = None
        try:
            if use_native:
                try:
                    union = native.block_union(cat, self._blk_real_bits, geo.total_rows, rmap)
                except MemoryError:
                    union = None  # the bitmap allocation failed: numpy form
            if union is None:
                present = np.zeros(geo.total_rows, bool)
                present[cat] = True
                present &= self._blk_real_mask
                union = np.flatnonzero(present)
                rmap[union] = np.arange(union.size, dtype=np.int32)
            # +1: the last pending row is the trash rank
            p_bucket = pow2_bucket(union.size + 1, min_size=1024)
            p_bucket = self._bucket_run_max["blk"] = max(self._bucket_run_max["blk"], p_bucket)
            p_trash = p_bucket - 1
            blk_slots = np.full(p_bucket, geo.trash_row, np.int32)
            blk_slots[: union.size] = union
            blk_counts = np.array([union.size], np.int32)
            # the step's unique rows start at position 1, or 0 on the sorted
            # wire (cdlrm_tpu trainer.py:1729)
            base = 0 if self._sorted_wire else 1
            if use_native:
                rows = native.block_ranks(cat, off, rmap, p_trash, ub, base)
            else:
                rows = np.full((len(infos), ub), p_trash, np.int32)
                for i, info in enumerate(infos):
                    r = rmap[info[0]]
                    # aux and trash slots are never in the union: -1 -> trash
                    rows[i, base: base + r.size] = np.where(r < 0, p_trash, r)
        finally:
            # restore the map's all -1 precondition whatever raised above
            if union is not None and use_native:
                native.block_union_reset(union, rmap)
            elif union is not None:
                rmap[union] = -1
        ranks = [self._to_device(r) for r in rows]
        return ranks, self._to_device(blk_slots), self._to_device(blk_counts)

    def train(self, max_steps: Optional[int] = None, log_fn=print) -> TrainMetrics:
        """Main loop (cdlrm_tpu trainer.py:1774): consume batches the
        AssemblyPipeline thread probed and staged ahead, in blocks of up to
        ``scan_steps`` batches that never cross a window boundary or a
        cadence (print, test), apply the refill at each window boundary it
        signals, and run the cadences on global_step. Each step's loss and
        accuracy stay on the device until the next print, then come back in
        one copy."""
        from cdlrm_tpu_torch.train.pipeline import WINDOW_BOUNDARY, WINDOW_REPLAY

        cfg = self.cfg
        use_device(self.device)
        if self.group.rank != 0:
            log_fn = _no_log  # rank 0 alone prints
        self._start_pipeline()
        pipe = self._pipe
        if self._stream_done:
            return self.metrics
        b = cfg.mini_batch_size
        pending: List[Tuple[torch.Tensor, torch.Tensor]] = []  # (loss_sum, correct)
        window_t0 = time.perf_counter()

        def flush_pending():
            if not pending:
                return
            vals = torch.stack([v for pair in pending for v in pair]).cpu().tolist()
            m = self.metrics
            for ls_v, c_v in zip(vals[0::2], vals[1::2]):
                m.loss_sum += ls_v
                m.correct += c_v
                m.examples += b
                m.steps += 1
            pending.clear()

        def print_window(j):
            nonlocal window_t0
            flush_pending()
            self._sync_hits()
            dt = time.perf_counter() - window_t0
            m = self.metrics
            # ms/it excludes the refill time, reported on its own
            # (reference semantics, main_no_ddp.py:458-473)
            ms_it = 1000.0 * max(0.0, dt - m.caching_overhead_s) / max(1, m.steps)
            overhead_ms = 1000.0 * m.caching_overhead_s / max(1, m.steps)
            ptr = m.per_table_hit_rates
            self.last_window = {
                "ms_per_iter": ms_it,
                "caching_overhead_ms": overhead_ms,
                "loss": m.loss_sum / max(1, m.examples),
                "accuracy": m.correct / max(1, m.examples),
                "hit_rate": m.hit_rate,  # train probes only
                "eval_hit_rate": m.eval_hit_rate,
                "per_table_hit_rates": (
                    None if ptr is None else [round(float(v), 4) for v in ptr]
                ),
                "steps": m.steps,
                "dedup": self._dedup,  # wire of the current window
                # multi-host refill prestage hoists so far (one host: none)
                "mh_prefetches": self.mh_prefetches,
            }
            log_fn(
                f"Step {j}: {ms_it:.2f} ms/it, caching overhead "
                f"{overhead_ms:.3f} ms/it, loss "
                f"{m.loss_sum / max(1, m.examples):.5f}, "
                f"acc {m.correct / max(1, m.examples):.5f}, "
                f"hit-rate {m.hit_rate:.4f}"
            )
            self._log_metrics("train_window", self.last_window)
            m.train_time_s += dt
            m.steps = m.examples = 0
            m.loss_sum = m.correct = 0.0
            m.caching_overhead_s = 0.0
            window_t0 = time.perf_counter()

        def after_step(cursor):
            self.global_step += 1
            self._cursor = (cursor[0], cursor[1] + 1)
            j = self.global_step
            if self._needs_agg and j % cfg.table_agg_freq == 0:
                self._aggregate()
            if j % cfg.print_freq == 0:
                print_window(j)
            if self.test_dataset is not None and cfg.test_freq > 0 and j % cfg.test_freq == 0:
                acc, auc = self.evaluate(log_fn=log_fn)
                if (cfg.mlperf_acc_threshold > 0 and acc >= cfg.mlperf_acc_threshold) or (
                    cfg.mlperf_auc_threshold > 0 and not np.isnan(auc)
                    and auc >= cfg.mlperf_auc_threshold
                ):
                    log_fn(f"MLPerf threshold reached (acc={acc:.5f}, auc={auc:.5f}); stopping")
                    self._stop_requested = True
            if cfg.checkpoint_freq > 0 and cfg.save_model and j % cfg.checkpoint_freq == 0:
                self.save_checkpoint(cfg.save_model)

        def cadence_dist(j, f):
            return f - (j % f) if f and f > 0 else 1 << 30

        def block_cap():
            """The largest block from the current step that crosses no
            cadence boundary, so every cadence fires at its global step."""
            j = self.global_step
            cap = self._scan_block
            if max_steps is not None:
                cap = min(cap, max_steps - j)
            if self._needs_agg:
                cap = min(cap, cadence_dist(j, cfg.table_agg_freq))
            cap = min(cap, cadence_dist(j, cfg.print_freq))
            if self.test_dataset is not None and cfg.test_freq > 0:
                cap = min(cap, cadence_dist(j, cfg.test_freq))
            if cfg.checkpoint_freq > 0 and cfg.save_model:
                cap = min(cap, cadence_dist(j, cfg.checkpoint_freq))
            return max(1, cap)

        wire_dedup = None  # wire of the batches since the last boundary

        def run_step(step, args):
            """Call a train step with the window's hot list or the optimizer
            state after the batch inputs, and keep what it returns (cdlrm_tpu
            trainer.py:1948-1999); returns (loss_sum, correct)."""
            if not self._adagrad:
                hot_extra = (self._hot_slots_dev,) if self._hot else ()
                self.params, self.cache, loss, corr = step(
                    self.params, self.cache, *args, *hot_extra, self._lr, self._lr_emb,
                    touched=self.touched,
                )
                return loss, corr
            (self.params, self.cache, self.dense_acc, self.embed_acc, loss, corr) = step(
                self.params, self.cache, *args, self.dense_acc, self.embed_acc,
                self._lr, self._lr_emb, touched=self.touched,
            )
            return loss, corr

        def run_block(items):
            """Run len(items) consecutive steps: one step, or a scan block,
            coalesced when every item carries its block info (cdlrm_tpu
            trainer.py:1933-2001)."""
            nonlocal wire_dedup
            dedup = items[0][4]
            if wire_dedup is None:
                wire_dedup = dedup
            if any(it[4] != wire_dedup for it in items):
                # the wire may change only at a window boundary; a batch in
                # the other format would be misread by this step
                raise RuntimeError("mixed wire formats within a window")
            rh = self._rank_hits
            for it in items:
                it[3].commit(self.metrics, None if rh is None else rh.train)
            if len(items) == 1:
                cursor, _, inputs, _, _, _ = items[0]
                pending.append(run_step(self._get_step(1, dedup), inputs))
                after_step(cursor)
                return
            coalesce = dedup and self._block_coalesce and all(it[5] is not None for it in items)
            step = self._get_step(len(items), dedup, coalesce)
            if coalesce:
                ranks, blk_slots, blk_counts = self._build_block_union([it[5] for it in items])
                args = self.interleave_block_inputs([it[2] for it in items], ranks)
                args += [blk_slots, blk_counts]
            else:
                args = [a for it in items for a in it[2]]
            loss_v, corr_v = run_step(step, args)
            for i, it in enumerate(items):
                pending.append((loss_v[i], corr_v[i]))
                after_step(it[0])

        while True:
            if max_steps is not None and self.global_step >= max_steps:
                break
            if self._stop_requested:
                break
            items, stream_end, boundary = [], False, None
            cap = block_cap()
            while len(items) < cap:
                item = pipe.get()
                if item is None:
                    stream_end = True
                    break
                if item is WINDOW_BOUNDARY or item is WINDOW_REPLAY:
                    boundary = item
                    break
                items.append(item)
            if items:
                run_block(items)
                if self._mh_want_prefetch:
                    # the first block of this window is dispatched: the
                    # point, the same on every rank, where the next window's
                    # exchange, plan join and copies run
                    self._mh_want_prefetch = False
                    self._prefetch_next_window()
            if stream_end:
                self._stream_done = True
                break
            if boundary is not None:
                rows_ex = None
                if self._stager is not None:
                    popped = self._stager.get()
                    window, staged = popped if popped else (None, None)
                elif self._mh_pending is not None:
                    window, rows_ex, staged = self._mh_pending
                    self._mh_pending = None
                else:
                    window, staged = self.prefetcher.get_window(), None
                if window is None:
                    break
                self._mh_want_prefetch = self._mh_prestage
                if boundary is WINDOW_REPLAY:
                    # mid-window resume: the checkpointed occupancy and RNG
                    # already hold this window's insert plan; multi-host, the
                    # window's rows are exchanged again to serve its misses
                    if self.multihost:
                        rows = self._exchange_window(window.uniques, window.rows)
                        self._window_store = WindowRowStore(window.uniques, rows)
                    self._apply_window_stats(window)
                else:
                    self._apply_refill(window, staged, rows_exchanged=rows_ex)
                wire_dedup = None
                pipe.notify_refill_applied()
        flush_pending()
        self._sync_hits()
        return self.metrics

    def _aggregate(self) -> None:
        """One touched-row aggregate step over the ranks (cdlrm_tpu
        trainer.py:1850-1858); under AdaGrad the row-wise state rides with
        the same op."""
        if self._adagrad:
            self.cache, self.touched, self.embed_acc = self.agg_step(
                self.cache, self.touched, self.embed_acc)
        else:
            self.cache, self.touched = self.agg_step(self.cache, self.touched)

    # -------------------------------------------------------------- eval path
    def _probe_eval(self, batch: Batch):
        """Host half of eval assembly: probe this rank's slice of the
        (padded) batch against the occupancy and gather its miss rows from
        the masters. Multi-host, the misses may lie outside any window: a
        :class:`CollectingMaster` records them for :meth:`_stage_eval`'s
        exchange and the rows stay zero until then (cdlrm_tpu
        trainer.py:1398-1421)."""
        self.metrics.eval_lookups += self._num_lookups(batch)
        batch = self._local(batch)
        collector = CollectingMaster(self.geo.dim) if self.multihost else None
        pr = self._probe(batch, self._probe_fn, collector)
        if self._rank_hits is not None:
            self._rank_hits.eval_hits += int(pr.hit_counts.sum())
        else:
            self.metrics.eval_hits += int(pr.hit_counts.sum())
        return batch, pr.slots, pr.aux_slots, pr.aux_rows, collector

    def _stage_eval(self, probed):
        """Device half of eval assembly: pad the miss rows and copy the eval
        step's inputs to the device (x, slots, mask, aux_slots, aux_rows).
        Multi-host, the recorded misses are fetched from their owners first:
        one routed exchange a batch on every rank, even with no misses of its
        own, so it runs on the train thread in batch order (cdlrm_tpu
        trainer.py:1444-1466)."""
        batch, slots, aux_slots, aux_rows, collector = probed
        if collector is not None:
            fetched = self._row_exchange.fetch(collector.requests)
            if fetched:
                aux_rows = np.concatenate(fetched)
        aux = self._pack_aux(aux_slots, aux_rows, "eval")
        return self._stage_batch(batch, (slots,), aux, train=False)

    def evaluate(self, max_batches: Optional[int] = None, log_fn=print):
        """Eval over the test stream; returns (accuracy, auc).

        Pipelined as in cdlrm_tpu: a producer thread probes and stages up to
        ``pipeline_depth`` batches ahead of the forward, and each batch's
        scores come back to the host one batch late, so batch i-1's metrics
        are computed while batch i runs. The producer's copies and the
        forward share the device's default stream, so stream order puts each
        batch's inputs before its forward. Each batch's scores are copied
        into pinned host memory right after its forward, and an event marks
        the copy; the host waits on that event one batch later.

        With more than one rank (cdlrm_tpu trainer.py:2098-2147) the batch is
        padded to ``world_size * tb_loc`` rows, each rank scores its slice
        with its own cache replica, and the scores come together in rank
        order on every rank (one collective a batch, on this thread), so
        every rank computes the same accuracy and AUC. Multi-host, the
        producer only probes, and the train thread stages each batch, whose
        miss exchange is a collective (:meth:`_stage_eval`)."""
        cfg = self.cfg
        use_device(self.device)
        if self.group.rank != 0:
            log_fn = _no_log
        tb = self._test_b_loc * self.ndev
        total, correct = 0, 0
        auc = StreamingAUC()
        on_cuda = self.device.type == "cuda"

        depth = max(1, cfg.pipeline_depth)
        out: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def produce():
            try:
                use_device(self.device)
                for i, batch in enumerate(self.test_dataset.batches()):
                    if max_batches is not None and i >= max_batches:
                        break
                    if stop.is_set():
                        return
                    n = batch.x.shape[0]
                    probed = self._probe_eval(_pad_batch(batch, tb))
                    if self.multihost:
                        item = (n, batch.y, None, probed)
                    else:
                        item = (n, batch.y, self._stage_eval(probed), None)
                    while not stop.is_set():
                        try:
                            out.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:  # re-raised on the consuming thread
                out.put(e)
                return
            out.put(None)

        producer = threading.Thread(target=produce, daemon=True, name="eval-pipeline")
        producer.start()
        pending: deque = deque()  # (host scores, event, n, y), one batch of lag

        def materialize(entry):
            nonlocal total, correct
            scores_host, done, n, y = entry
            if done is not None:
                done.synchronize()
            scores = scores_host.numpy()[:n]
            y = y[:n]
            correct += accuracy_count(scores, y)
            total += n
            auc.update(scores, y)

        try:
            while True:
                item = out.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                n, y, inputs, probed = item
                if inputs is None:
                    inputs = self._stage_eval(probed)
                self.cache, scores = self.eval_step(self.params, self.cache, *inputs)
                scores = self.group.gather_batch_rows(scores)
                scores_host = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=on_cuda)
                scores_host.copy_(scores, non_blocking=on_cuda)
                done = None
                if on_cuda:
                    done = torch.cuda.Event()
                    done.record()
                pending.append((scores_host, done, n, y))
                if len(pending) > 1:
                    materialize(pending.popleft())
            while pending:
                materialize(pending.popleft())
        finally:
            stop.set()
            producer.join(timeout=30)
        self._sync_hits()
        acc = correct / max(1, total)
        auc_v = auc.result()
        log_fn(f"Test accuracy = {100.0 * acc:.4f}%  AUC = {auc_v:.5f}")
        ptr = self.metrics.per_table_hit_rates
        if ptr is not None:
            # a summary on the console; the full [T] vector goes to the
            # structured log below
            log_fn(
                f"Per-table train hit rates: min {float(ptr.min()):.4f} "
                f"mean {float(ptr.mean()):.4f} max {float(ptr.max()):.4f}"
            )
        self._log_metrics(
            "eval",
            {
                "accuracy": acc,
                "auc": None if np.isnan(auc_v) else float(auc_v),
                "eval_hit_rate": self.metrics.eval_hit_rate,
                "per_table_hit_rates": (
                    None if ptr is None else [round(float(v), 4) for v in ptr]
                ),
                "examples": total,
            },
        )
        return acc, auc_v

    # -------------------------------------------------------------- checkpoint
    def _init_token(self) -> int:
        """Digest of what the procedural master init depends on (seed + init
        mode), as cdlrm_tpu computes it: a dirty-master checkpoint loads only
        into masters built from the same."""
        return zlib.crc32(f"{self.cfg.numpy_rand_seed}:{self.cfg.master_init}".encode())

    def _load_master(self, file_path: str) -> None:
        try:
            self.master.load(file_path, init_token=self._init_token())
        except TypeError:
            self.master.load(file_path)  # loaders without dirty support

    def save_checkpoint(self, path: str) -> None:
        """Save the training state in cdlrm_tpu's single-host format v3
        (cdlrm_tpu trainer.py:2250-2386), which either package loads.

        A snapshot phase on the train thread flushes the eviction fifo (the
        masters must hold every evicted row), copies the device state to the
        host and copies the dirty master rows and the occupancy; then the
        write phase serializes the snapshot, on a background thread with
        ``checkpoint_async`` (:class:`CheckpointWriter`), so training may go
        on meanwhile. Files: ``meta.pkl`` (format_version, global_step,
        rng_state, cursor), ``dense_params.npz`` and, under AdaGrad,
        ``dense_acc.npz`` (``leaf_i`` in tree_flatten order: the bottom MLP,
        the ``md_proj`` projections of cached mixed-dimension tables, the top
        MLP), ``cache.npy``,
        ``embed_acc.npy``, ``touched.npy`` (the rows waiting for the next
        aggregate step; all False on one device),
        ``acc_store.npz`` with ``adagrad_master_state``, ``occupancy.npz``
        and ``master.npz``: the dirty rows, or the full save for
        ``checkpoint_masters='full'`` and for masters without dirty tracking
        (virtual masters), written on the train thread.

        With more than one rank it is still one file set, cdlrm_tpu's at the
        same ``world_size`` (trainer.py:2289-2300), written by rank 0:
        ``cache.npy`` ``[N*R, D]``, ``touched.npy`` ``[N*R]`` and
        ``embed_acc.npy`` ``[N*R]`` hold the ranks' blocks in rank order
        (replicas differ between aggregations, and the mask is the pending
        aggregation), gathered to rank 0 over the host as part of the
        snapshot; the parameters, occupancy and masters are rank 0's, equal
        on every rank. Every rank flushes its own eviction queue first. A
        barrier after a synchronous write keeps a rank from loading files
        that are not there yet; under ``checkpoint_async`` the gather alone
        keeps the ranks in step and rank 0's next save, load or close joins
        the writer.

        Multi-host (cdlrm_tpu trainer.py:2275-2385), into one shared
        directory: every rank writes its own files, tagged ``.h{rank}``:
        ``cache``, ``touched`` and ``embed_acc`` (``[R, ...]``, its own
        replica), ``acc_store`` and ``master`` (its owned shard); rank 0
        alone writes the dense parameters and accumulators, the occupancy and
        the meta. A synchronous save ends with a barrier, so no rank returns
        before every rank's files exist; an asynchronous one has no
        collective at all (its writer finishes off the train thread), and a
        rank that loads the directory must learn of the writes another way."""
        self._ckpt_writer.join()
        use_device(self.device)
        rank0 = self.group.rank == 0
        tag = f".h{self.group.rank}" if self.multihost else ""
        if rank0 or self.multihost:
            os.makedirs(path, exist_ok=True)
        if not self.eviction_manager.flush(timeout=self.cfg.eviction_fifo_timeout):
            raise RuntimeError(
                "eviction writeback flush timed out; checkpoint would miss "
                "in-flight evicted rows (raise --eviction-fifo-timeout)"
            )
        writes: list = []

        def host(t: torch.Tensor) -> np.ndarray:
            # a copy even on the CPU, where .cpu() would alias the live state
            return t.to("cpu", copy=True).numpy()

        def leaves(params) -> dict:
            return {f"leaf_{i}": a for i, a in enumerate(params_to_jax(params))}

        def npy(name, arr):
            writes.append((np.save, os.path.join(path, name), arr))

        def npz(name, payload):
            writes.append((_write_npz, os.path.join(path, name), payload))

        def blocks(arr: np.ndarray):
            """Every rank's block in rank order, on rank 0; None elsewhere."""
            if self.ndev == 1:
                return arr
            got = self.group.gather_host_to0(arr)
            return None if got is None else np.concatenate(got)

        touched = (np.zeros(self.geo.total_rows, dtype=bool) if self.touched is None
                   else host(self.touched).astype(bool))
        if self.multihost:
            # this rank's own replica, in files of its own
            state = [(f"cache{tag}.npy", host(self.cache)), (f"touched{tag}.npy", touched)]
            if self._adagrad:
                state.append((f"embed_acc{tag}.npy", host(self.embed_acc)))
        else:
            state = [("cache.npy", blocks(host(self.cache))), ("touched.npy", blocks(touched))]
            if self._adagrad:
                state.append(("embed_acc.npy", blocks(host(self.embed_acc))))
            if not rank0:
                # the files are rank 0's; this rank leaves when they are written
                if not self.cfg.checkpoint_async:
                    self.group.barrier()
                return
        for name, arr in state:
            npy(name, arr)
        if self._acc_master is not None:
            # the store's nonzero support (multi-host: of the owned rows);
            # payload() copies
            npz(f"acc_store{tag}.npz", self._acc_master.payload())
        if self.cfg.checkpoint_masters == "dirty" and hasattr(self.master, "dirty_payload"):
            # the dirty rows copied now: writebacks may resume meanwhile
            npz(f"master{tag}.npz", self.master.dirty_payload(self._init_token()))
        else:
            # the full dump has no snapshot form: written here
            self.master.save(os.path.join(path, f"master{tag}.npz"))
        if rank0:
            npz("dense_params.npz", leaves(self.params))
            if self._adagrad:
                npz("dense_acc.npz", leaves(self.dense_acc))
            # state_dict returns the live occupancy arrays
            npz("occupancy.npz", {k: np.copy(v) for k, v in self.controller.state_dict().items()})
            meta = {
                "format_version": CHECKPOINT_FORMAT_VERSION,
                "global_step": self.global_step,
                "rng_state": self.controller.rng.bit_generator.state,
                "cursor": self._cursor,
            }
            writes.append((_write_pickle, os.path.join(path, "meta.pkl"), meta))
        self._ckpt_writer.run(writes, background=self.cfg.checkpoint_async)
        if not self.cfg.checkpoint_async:
            self.group.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Load a single-host checkpoint of either package (meta.pkl,
        dense_params.npz, cache.npy, occupancy.npz, master.npz, and the
        AdaGrad state) and its data cursor, so that training resumes where
        it stopped. Every rank reads the one file set and takes block
        ``rank`` of ``cache.npy``, ``touched.npy`` and ``embed_acc.npy``; the
        saved ``world_size`` must be this run's. Multi-host, every rank reads
        its own ``.h{rank}`` files, and the master shard's identity is
        checked (``ShardedMasterTables._check_shard_identity``). It raises cdlrm_tpu's errors (trainer.py:2425-2469) when
        the checkpoint's optimizer state does not fit this run: AdaGrad state
        under an SGD training run (``--inference-only`` loads it: serving
        never reads it), no AdaGrad state under AdaGrad, no accumulator
        store under ``adagrad_master_state``."""
        self._ckpt_writer.join()
        if self._pipeline_started:
            raise RuntimeError(
                "load_checkpoint after training started: the stream cursor "
                "cannot be rewound on a running pipeline; load into a fresh trainer"
            )
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            meta = pickle.load(f)
        fmt = meta.get("format_version", 2 if "cursor" in meta else 1)
        if fmt not in (2, CHECKPOINT_FORMAT_VERSION):
            raise ValueError(
                f"incompatible checkpoint format v{fmt} at {path!r} (this build "
                f"reads v2-v{CHECKPOINT_FORMAT_VERSION})"
            )
        use_device(self.device)
        n_bot = len(self.params["bot"])
        md = "md_proj" in self.params
        n_leaves = len(param_leaves(self.params))
        with np.load(os.path.join(path, "dense_params.npz")) as data:
            if len(data.files) != n_leaves:
                raise ValueError(
                    f"{path!r} holds {len(data.files)} dense leaves, this "
                    f"config's model {n_leaves} (md_flag or MLP depth differs)"
                )
            leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
        self.params = params_from_jax(leaves, n_bot=n_bot, device=self.device, md_proj=md)
        rows, dim = self.cache.shape
        # multi-host: this rank's own files, one replica each
        tag = f".h{self.group.rank}" if self.multihost else ""
        blocks = 1 if self.multihost else self.ndev
        cache0 = np.load(os.path.join(path, f"cache{tag}.npy"), mmap_mode="r")
        if cache0.shape != (blocks * rows, dim):
            same_geometry = cache0.shape[0] % rows == 0 and cache0.shape[1] == dim
            raise ValueError(
                f"checkpoint cache {cache0.shape} != {blocks} replicas of this "
                f"geometry's {(rows, dim)}: saved with world_size="
                f"{cache0.shape[0] // rows if same_geometry else '?'}, "
                f"this run has world_size={self.ndev}"
            )
        mine = slice(0, rows) if self.multihost else slice(
            self.group.rank * rows, (self.group.rank + 1) * rows)
        acc_path = os.path.join(path, f"embed_acc{tag}.npy")
        if not self._adagrad and os.path.exists(acc_path) and not self.cfg.inference_only:
            raise ValueError(
                f"{path!r} carries AdaGrad optimizer state but this run is "
                "optimizer='sgd'; resuming would silently drop the "
                "accumulators: pass --optimizer adagrad (or "
                "--inference-only for serving)"
            )
        if self._adagrad:
            if not os.path.exists(acc_path):
                raise ValueError(
                    f"optimizer='adagrad' but {path!r} carries no optimizer "
                    "state (saved by an SGD run?); resume with the matching "
                    "optimizer"
                )
            store_path = os.path.join(path, f"acc_store{tag}.npz")
            if self._acc_master is not None and not os.path.exists(store_path):
                raise ValueError(
                    f"adagrad_master_state set but {path!r} carries no "
                    "accumulator store (saved without the flag?); resume "
                    "with the matching setting"
                )
            self.embed_acc = torch.from_numpy(np.load(acc_path)[mine]).to(self.device)
            with np.load(os.path.join(path, "dense_acc.npz")) as data:
                acc_leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
            self.dense_acc = params_from_jax(acc_leaves, n_bot=n_bot, device=self.device,
                                             md_proj=md)
            if self._acc_master is not None:
                with np.load(store_path) as data:
                    self._acc_master.load_payload(data)
        self.cache = torch.from_numpy(np.array(cache0[mine])).to(self.device)
        if self.touched is not None:
            touched0 = np.load(os.path.join(path, f"touched{tag}.npy"))[mine]
            self.touched = torch.from_numpy(touched0.astype(np.uint8)).to(self.device)
        with np.load(os.path.join(path, "occupancy.npz")) as data:
            self.controller.load_state_dict(dict(data))
        self._load_master(os.path.join(path, f"master{tag}.npz"))
        self.global_step = meta["global_step"]
        self.controller.rng.bit_generator.state = meta["rng_state"]
        self._cursor = tuple(meta.get("cursor", (0, 0)))

    def close(self) -> None:
        # the checkpoint writer first (its error must surface), and its
        # raise must not skip the shutdown below
        try:
            self._ckpt_writer.join()
        finally:
            if self._metrics_fp is not None:
                self._metrics_fp.close()
                self._metrics_fp = None
            if self._pipeline_started:
                threads = [t for t in (self._pipe, self._stager, self.prefetcher)
                           if t is not None]
                for t in threads:
                    t.stop()
                self.eviction_fifo.put(None)
                # join them: a daemon thread still inside a CUDA call when
                # the interpreter exits aborts the process. stop() drains a
                # thread's queue once, but the put it wakes can fill the
                # queue again (a fifo of one) and block the thread's final
                # sentinel put: drain again until it exits
                deadline = time.monotonic() + 60
                for t in threads + [self.eviction_manager]:
                    while t.ident is not None and t.is_alive() and time.monotonic() < deadline:
                        t.join(timeout=0.05)
                        if t in threads:
                            t.stop()


def _no_log(*_args, **_kwargs) -> None:
    """The ``log_fn`` of every rank but 0."""


def _pad_batch(batch: Batch, to_size: int) -> Batch:
    """Pad a short final batch to the eval batch size with id-0 lookups,
    zero features and masked bags; the padded rows' scores are dropped."""
    n = batch.x.shape[0]
    if n == to_size:
        return batch
    pad = to_size - n

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    def padded1(a):
        return np.concatenate([a, np.zeros(a.shape[:1] + (pad,) + a.shape[2:], a.dtype)], axis=1)

    mask = None if batch.ls_mask is None else padded1(batch.ls_mask)
    return Batch(padded(batch.x), padded1(batch.ls_i), mask, padded(batch.y))
