"""Cached DLRM serving on one device, the counterpart of the serving subset of
cdlrm_tpu/train/trainer.py::CachedDlrmTrainer.

The host side is cdlrm_tpu's, shared: masters, the cache controller
(occupancy, probe, insert plan), the synthetic and Criteo streams, metrics.
The device side is this package's: the cache ``[R, D]`` as one float32
tensor on ``device``, dense parameters as tensors, and the eval and refill
steps of train/step.py. The same config and seed give the same masters,
weights, probes and wire bytes as cdlrm_tpu, so a cdlrm_tpu checkpoint serves
here unchanged.

Ported: construction, ``evaluate`` (the pipelined ``--inference-only``
path), ``refill`` of one insert plan, ``load_checkpoint`` and ``close``.
Training comes later (ROADMAP.md queue 1).
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
from typing import Optional

import numpy as np
import torch

from cdlrm_tpu.cache.geometry import CacheGeometry
from cdlrm_tpu.cache.host_cache import HostCacheController, InsertPlan
from cdlrm_tpu.cache.master import MasterTables, VirtualMasterTables
from cdlrm_tpu.config import Config
from cdlrm_tpu.data.synthetic import Batch
from cdlrm_tpu.utils.metrics import StreamingAUC, accuracy_count
from cdlrm_tpu.utils.padding import pad_to_bucket, pow2_bucket
from cdlrm_tpu_torch.config import jax_free_host
from cdlrm_tpu_torch.models.dlrm import init_dlrm, params_from_jax
from cdlrm_tpu_torch.train import step as step_lib

# checkpoint layout versions this loader reads (cdlrm_tpu save_checkpoint)
CHECKPOINT_FORMAT_VERSION = 3


@dataclass
class TrainMetrics:
    """cdlrm_tpu's TrainMetrics fields that serving fills; the training
    counters come with the trainer."""

    caching_overhead_s: float = 0.0
    refills: int = 0
    # eval probes are counted apart from training's
    eval_hits: int = 0
    eval_lookups: int = 0

    @property
    def eval_hit_rate(self) -> float:
        return self.eval_hits / max(1, self.eval_lookups)


def _check_slice(cfg: Config) -> None:
    """Refuse the config fields this port does not implement yet, rather
    than ignore them (ROADMAP.md queue 1 names where each comes)."""
    unsupported = {
        "world_size > 1 (multi-GPU)": cfg.world_size > 1,
        "coordinator_address (multi-host)": bool(cfg.coordinator_address),
        "md_flag (cached mixed-dimension tables)": cfg.md_flag,
        "qr_flag (QR tables, full-table path)": cfg.qr_flag,
        "wire_rows_bf16": cfg.wire_rows_bf16,
        "wire_x_fp8": cfg.wire_x_fp8,
        "use_cache=False (full-table path)": not cfg.use_cache,
        "optimizer other than sgd (AdaGrad)": cfg.optimizer != "sgd",
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise ValueError(
            "cdlrm_tpu_torch does not implement " + ", ".join(bad)
            + " yet (ROADMAP.md queue 1)"
        )


class CachedDlrmTrainer:
    """Cached DLRM on one device: serving today, training later."""

    def __init__(self, cfg: Config, dataset, test_dataset=None, *,
                 device, pooled_width: Optional[int] = None):
        """``dataset`` / ``test_dataset`` expose batches() (restartable),
        __len__, m_den and ln_emb, as for cdlrm_tpu. ``device`` is where the
        cache and the dense parameters live. ``pooled_width``: P for padded
        multi-hot bags; by default read from the first training batch."""
        if cfg.ln_emb is None:
            raise ValueError(
                "call cdlrm_tpu_torch.config.finalize(cfg) (or build_dataset) first"
            )
        _check_slice(cfg)
        self.cfg = cfg
        self.test_dataset = test_dataset
        self.device = torch.device(device)
        if pooled_width is None:
            first = next(iter(dataset.batches()))
            pooled_width = 0 if first.ls_mask is None else first.ls_i.shape[2]
        self.pooled_width = pooled_width

        # one generator, drawn in cdlrm_tpu's order: masters, then the dense
        # weights — the same seed gives both packages the same values
        rng = np.random.default_rng(cfg.numpy_rand_seed)
        b_loc = cfg.local_batch_size
        test_b_loc = cfg.test_mini_batch_size
        aux_cap = cfg.aux_capacity if cfg.aux_capacity > 0 else (
            max(b_loc, test_b_loc) * max(1, pooled_width)
        )
        self.geo = CacheGeometry.build(
            cfg.ln_emb, cfg.m_spa, cfg.cache_size, cfg.num_ways, aux_cap
        )
        if cfg.master_init == "virtual":
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
        self.cache = torch.zeros(
            (self.geo.total_rows, self.geo.dim), dtype=torch.float32, device=self.device
        )

        # slot wire: bit-packed table-local ids at the smallest width that
        # addresses every table's cache block (train/step.py pack_slots)
        rows_per_table = self.geo.ways * self.geo.sets + self.geo.aux_capacity
        self._wire_bits = step_lib.wire_width(int(rows_per_table.max()) - 1)
        self._wire_pack = bool(cfg.pack_wire and self._wire_bits <= step_lib.WIRE_MAX_BITS)
        scfg = step_lib.StepConfig(
            interaction_op=cfg.arch_interaction_op,
            interaction_itself=cfg.arch_interaction_itself,
            loss_threshold=cfg.loss_threshold,
            refill_broadcast="off",
            compute_dtype=cfg.compute_dtype,
            wire_pack=self._wire_pack,
            wire_bits=self._wire_bits,
            optimizer=cfg.optimizer,
        )
        # the eval wire is always the plain slot wire (cdlrm_tpu
        # trainer.py:475-478): no dedup variant is needed to serve
        self.eval_step = step_lib.make_cached_eval_step(self.geo, scfg, self.pooled_width)
        self.refill_step = step_lib.make_refill_step(scfg, trash_row=self.geo.trash_row)
        self._probe_fn = (
            functools.partial(self.controller.probe_wire, bits=self._wire_bits)
            if self._wire_pack else self.controller.probe
        )
        self._eval_bucket_max = 0  # monotone eval staging bucket (_pack_aux)
        self._dummy_masks: dict = {}
        self.global_step = 0
        self.metrics = TrainMetrics()
        self._metrics_fp = None
        if cfg.metrics_log:
            log_dir = os.path.dirname(cfg.metrics_log)
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
            self._metrics_fp = open(cfg.metrics_log, "a")

    def _log_metrics(self, kind: str, payload: dict) -> None:
        if self._metrics_fp is None:
            return
        self._metrics_fp.write(json.dumps({"kind": kind, "step": self.global_step, **payload}) + "\n")
        self._metrics_fp.flush()

    def train(self, max_steps: Optional[int] = None):
        raise NotImplementedError(
            "training is not ported yet: the cached training step and trainer "
            "are ROADMAP.md queue 1"
        )

    # ------------------------------------------------------------------ refill
    def _refill_device_inputs(self, plan: InsertPlan):
        """The refill step's operands for an insert plan, padded to
        power-of-two buckets on the host (insert padding -> the trash row,
        evict padding -> row 0) and copied to the device."""
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        return (
            dev(pad_to_bucket(plan.insert_slots, self.geo.trash_row)),
            dev(pad_to_bucket(plan.insert_rows, 0.0)),
            dev(pad_to_bucket(plan.evict_slots, 0)),
        )

    def refill(self, plan: InsertPlan) -> np.ndarray:
        """Apply one insert plan (``self.controller.plan_insert``, which has
        already updated the occupancy) to the device cache through the refill
        step. Returns the evicted rows [E, D], their values before the
        insert, for the caller to write back to the masters. The window
        cadence that calls this while training comes with the trainer."""
        t0 = time.perf_counter()
        self.cache, evicted = self.refill_step(self.cache, *self._refill_device_inputs(plan))
        out = evicted[: plan.evict_slots.shape[0]].cpu().numpy()
        self.metrics.caching_overhead_s += time.perf_counter() - t0
        self.metrics.refills += 1
        return out

    # ------------------------------------------------------------------- batch
    def _pack_aux(self, aux_slots_in: np.ndarray, aux_rows_in: np.ndarray):
        """Pad one batch's miss rows to a power-of-two bucket; padding targets
        the trash row. The bucket is monotone (a running maximum), like
        cdlrm_tpu's single-host eval staging."""
        n = aux_slots_in.shape[0]
        k = self._eval_bucket_max = max(self._eval_bucket_max, pow2_bucket(n))
        aux_slots = np.full(k, self.geo.trash_row, dtype=np.int32)
        aux_rows = np.zeros((k, self.geo.dim), dtype=np.float32)
        aux_slots[:n] = aux_slots_in
        aux_rows[:n] = aux_rows_in
        return aux_slots, aux_rows

    def _dummy_mask(self, t_count: int, b: int) -> torch.Tensor:
        """The all-False mask of single-index batches: one device constant."""
        key = (t_count, b)
        mask = self._dummy_masks.get(key)
        if mask is None:
            mask = self._dummy_masks[key] = torch.zeros(key, dtype=torch.bool, device=self.device)
        return mask

    def _wire_x(self, x: np.ndarray) -> torch.Tensor:
        """Dense features on the host wire: bf16 when computing in bf16 (the
        forward rounds them to bf16 first anyway), else float32."""
        xt = torch.from_numpy(np.ascontiguousarray(x))
        if self.cfg.compute_dtype == "bfloat16":
            xt = xt.to(torch.bfloat16)
        return xt

    # -------------------------------------------------------------- eval path
    def _probe_eval(self, batch: Batch):
        """Host half of eval assembly: probe the batch against the occupancy
        and gather its miss rows from the masters."""
        ls_i, mask = batch.ls_i, batch.ls_mask
        t_count = ls_i.shape[0]
        if mask is not None:
            if ls_i.shape[2] != self.pooled_width:
                raise ValueError(
                    f"batch pooled width {ls_i.shape[2]} != trainer pooled_width {self.pooled_width}"
                )
        elif self.pooled_width:
            raise ValueError("trainer built for pooled batches, got single-index")
        with jax_free_host():
            if mask is None:
                pr = self._probe_fn(ls_i, self.master)
            else:
                pr = self._probe_fn(
                    ls_i.reshape(t_count, -1), self.master,
                    valid=mask.reshape(t_count, -1),
                )
        self.metrics.eval_hits += int(pr.hit_counts.sum())
        self.metrics.eval_lookups += pr.num_lookups
        return batch, pr.slots, pr.aux_slots, pr.aux_rows

    def _stage_eval(self, probed):
        """Device half of eval assembly: pad the miss rows and copy the eval
        step's inputs to the device (x, slots, mask, aux_slots, aux_rows)."""
        batch, slots, aux_slots, aux_rows = probed
        aux_slots, aux_rows = self._pack_aux(aux_slots, aux_rows)

        def dev(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            return t.to(self.device)

        t_count, b = batch.ls_i.shape[:2]
        mask = (
            self._dummy_mask(t_count, b) if batch.ls_mask is None else dev(batch.ls_mask)
        )
        return (dev(self._wire_x(batch.x)), dev(slots), mask, dev(aux_slots), dev(aux_rows))

    def evaluate(self, max_batches: Optional[int] = None, log_fn=print):
        """Eval over the test stream; returns (accuracy, auc).

        Pipelined as in cdlrm_tpu: a producer thread probes and stages up to
        ``pipeline_depth`` batches ahead of the forward, and each batch's
        scores come back to the host one batch late, so batch i-1's metrics
        are computed while batch i runs. The producer's copies and the
        forward share the device's default stream, so stream order puts each
        batch's inputs before its forward. Each batch's scores are copied
        into pinned host memory right after its forward, and an event marks
        the copy; the host waits on that event one batch later."""
        cfg = self.cfg
        tb = cfg.test_mini_batch_size
        total, correct = 0, 0
        auc = StreamingAUC()
        on_cuda = self.device.type == "cuda"

        depth = max(1, cfg.pipeline_depth)
        out: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()

        def produce():
            try:
                for i, batch in enumerate(self.test_dataset.batches()):
                    if max_batches is not None and i >= max_batches:
                        break
                    if stop.is_set():
                        return
                    n = batch.x.shape[0]
                    item = (n, batch.y, self._stage_eval(self._probe_eval(_pad_batch(batch, tb))))
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
                n, y, inputs = item
                self.cache, scores = self.eval_step(self.params, self.cache, *inputs)
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
        acc = correct / max(1, total)
        auc_v = auc.result()
        log_fn(f"Test accuracy = {100.0 * acc:.4f}%  AUC = {auc_v:.5f}")
        self._log_metrics(
            "eval",
            {
                "accuracy": acc,
                "auc": None if np.isnan(auc_v) else float(auc_v),
                "eval_hit_rate": self.metrics.eval_hit_rate,
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

    def load_checkpoint(self, path: str) -> None:
        """Load a single-host cdlrm_tpu checkpoint (meta.pkl,
        dense_params.npz, cache.npy, occupancy.npz, master.npz). Serving
        reads no optimizer state, so AdaGrad accumulators in the checkpoint
        are left unread, and the touched-row mask is aggregation state that
        one device never needs."""
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            meta = pickle.load(f)
        fmt = meta.get("format_version", 2 if "cursor" in meta else 1)
        if fmt not in (2, CHECKPOINT_FORMAT_VERSION):
            raise ValueError(
                f"incompatible checkpoint format v{fmt} at {path!r} (this build "
                f"reads v2-v{CHECKPOINT_FORMAT_VERSION})"
            )
        n_bot = len(self.params["bot"])
        n_leaves = 2 * (n_bot + len(self.params["top"]))
        with np.load(os.path.join(path, "dense_params.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
        self.params = params_from_jax(leaves, n_bot=n_bot, device=self.device)
        cache0 = np.load(os.path.join(path, "cache.npy"))
        if cache0.shape != tuple(self.cache.shape):
            raise ValueError(
                f"checkpoint cache {cache0.shape} != this geometry's "
                f"{tuple(self.cache.shape)} (one replica; saved with world_size=1?)"
            )
        self.cache = torch.from_numpy(cache0).to(self.device)
        with np.load(os.path.join(path, "occupancy.npz")) as data:
            self.controller.load_state_dict(dict(data))
        self._load_master(os.path.join(path, "master.npz"))
        self.global_step = meta["global_step"]
        self.controller.rng.bit_generator.state = meta["rng_state"]

    def close(self) -> None:
        if self._metrics_fp is not None:
            self._metrics_fp.close()
            self._metrics_fp = None


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
