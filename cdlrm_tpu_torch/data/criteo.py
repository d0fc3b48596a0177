"""Criteo Kaggle / Terabyte datasets and loaders.

Covers the reference's three loading paths with two implementations (the
reference's streaming day-file loader C15 (
data_loader_terabyte.py:19-172) and its memory-map CriteoDataset mode C17
(dlrm_data_pytorch.py:129-288) produce the same stream — here
they are ONE streaming dataset):

- CriteoStreamingDataset: iterates <prefix>_<i>_reordered.npz day files,
  stitching batches across day boundaries; train = given days, test = first
  half of the last day, val = second half (data_loader_terabyte.py:106-113).
- CriteoInMemoryDataset: single processed npz with train/val/test index
  splitting + day/total randomization (dlrm_data_pytorch.py:209-256).
- CriteoBinDataset: packed int32 binary with O(1) seek access
  (data_loader_terabyte.py:195-235), plus the numpy->binary converter.

All emit the canonical Batch: X = log(1+dense) f32 [B,13], ls_i int64 [26,B]
(optionally % max_ind_range), y f32 [B,1] (the reference's
_transform_features, data_loader_terabyte.py:68-87).
"""

from __future__ import annotations

import math
import os
import threading
from os import path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from cdlrm_tpu_torch.data.synthetic import Batch

DEN_FEA = 13
SPA_FEA = 26


def transform_batch(
    x_int: np.ndarray, x_cat: np.ndarray, y: np.ndarray, max_ind_range: int = -1
) -> Batch:
    if max_ind_range > 0:
        x_cat = x_cat % max_ind_range
    x = np.log(x_int.astype(np.float32) + 1.0)
    ls_i = np.ascontiguousarray(x_cat.T.astype(np.int64))
    t = y.astype(np.float32).reshape(-1, 1)
    return Batch(x, ls_i, None, t)


class CriteoStreamingDataset:
    """Streaming loader over reordered day files."""

    def __init__(
        self,
        npzfile_prefix: str,
        days: Sequence[int],
        batch_size: int,
        split: str = "train",
        max_ind_range: int = -1,
        drop_last: bool = False,
        counts_file: Optional[str] = None,
        num_workers: int = 0,
        pin_base: Optional[int] = None,
    ):
        """``num_workers`` > 0: decompress the NEXT day file on a background
        thread while the current day streams (the reference threads
        args.num_workers into its torch DataLoaders,
        dlrm_data_pytorch.py:528-543; here the npz day decompress is the
        heavy unit of read work, and zlib releases the GIL).

        ``pin_base``: pin loader threads at pin_base+id — the reference's
        criteo_worker_pin_fn layout (dlrm_data_pytorch.py:341-343), wired
        from config pin_cores by make_criteo_datasets."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.npzfile_prefix = npzfile_prefix
        self.days = list(days)
        self.batch_size = batch_size
        self.split = split
        self.max_ind_range = max_ind_range
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.pin_base = pin_base

        day_count_file = npzfile_prefix + "_count.npz"
        if not path.exists(day_count_file):
            # the reference stores it under <d_prefix>_day_count.npz where
            # npzfile_prefix == <d_prefix>_day
            day_count_file = npzfile_prefix + "_day_count.npz"
        with np.load(day_count_file) as data:
            per_file = data["total_per_file"][np.asarray(self.days)]
        self._day_lengths = {d: int(n) for d, n in zip(self.days, per_file)}
        self.length = int(np.sum(per_file))
        if split in ("test", "val"):
            self.length = int(np.ceil(self.length / 2.0))

        if counts_file is None:
            base = npzfile_prefix[: -len("_day")] if npzfile_prefix.endswith("_day") else npzfile_prefix
            counts_file = base + "_fea_count.npz"
        with np.load(counts_file) as data:
            self.counts = data["counts"]
        self.m_den = DEN_FEA

    @property
    def ln_emb(self) -> np.ndarray:
        return np.asarray(self.counts, dtype=np.int64)

    def __len__(self) -> int:
        if self.drop_last:
            return self.length // self.batch_size
        return math.ceil(self.length / self.batch_size)

    def _day_window(self, day: int):
        """(end, start) row window of this split within ``day``, from the
        counts file alone (no npz load): train = whole day; test = first
        half; val = second half (reference data_loader_terabyte.py:106-113)."""
        n = self._day_lengths[day]
        if self.split == "test":
            return int(np.ceil(n / 2.0)), 0
        if self.split == "val":
            return n, n - int(np.ceil(n / 2.0))
        return n, 0

    def batches(self, skip: int = 0) -> Iterator[Batch]:
        """``skip`` seeks past the first ``skip`` batches without reading
        their rows (checkpoint data-cursor contract, trainer.py): whole days
        are skipped by their counts, then an in-day offset positions the
        stream exactly where batch ``skip`` begins. Only exact (full-batch)
        multiples are skippable mid-stream, which is all the trainer needs —
        it drops partial batches."""

        def load_day(day):
            with np.load(f"{self.npzfile_prefix}_{day}_reordered.npz") as d:
                return d["X_int"], d["X_cat"], d["y"]

        for piece in self._column_batches(skip, load_day):
            yield transform_batch(*piece, self.max_ind_range)

    def index_batches(self, skip: int = 0) -> Iterator[np.ndarray]:
        """The prefetcher's INDEX-ONLY view of the same stream: identical
        batch boundaries/ordering as ``batches()``, but each yield is just
        the [26, B] int64 sparse-index array — and only the ``X_cat`` npz
        member is decompressed per day (npz members are individually
        loadable), skipping ~2/3 of the second pass's zlib work on the
        X_int/y bytes the cache stream never reads.
        Reference anchor: the cache_ld second stream,
        dlrm_data_pytorch.py:465-483, which re-reads full
        batches and drops everything but the indices."""

        def load_day(day):
            with np.load(f"{self.npzfile_prefix}_{day}_reordered.npz") as d:
                return (d["X_cat"],)

        for (x_cat,) in self._column_batches(skip, load_day):
            if self.max_ind_range > 0:
                x_cat = x_cat % self.max_ind_range
            yield np.ascontiguousarray(x_cat.T.astype(np.int64))

    def _column_batches(self, skip, load_day):
        """Shared day-stitching core: yields column tuples (whatever
        ``load_day`` returns, batch-sliced) with identical boundary/carry
        semantics for every column subset."""
        b = self.batch_size
        to_skip = skip * b  # examples to seek past
        carry = None  # tuple of column arrays

        # day-ahead decompression (num_workers > 0): figure out which days
        # this pass actually reads (skip may jump whole days; ``rem`` is the
        # in-day example remainder), then keep the next one loading in the
        # background
        live_days = []
        rem = to_skip
        for day in self.days:
            if live_days:
                live_days.append(day)
                continue
            n, start = self._day_window(day)
            if rem >= n - start:
                rem -= n - start
                continue
            live_days.append(day)
        pool = None
        futures = {}
        if self.num_workers > 0 and len(live_days) > 1:
            from concurrent.futures import ThreadPoolExecutor

            from cdlrm_tpu_torch.utils import affinity

            pin = affinity.make_pin(self.pin_base)
            pool = ThreadPoolExecutor(
                max_workers=1,
                **({"initializer": affinity.worker_pin, "initargs": pin}
                   if pin else {}),
            )
        try:
            yield from self._stream(
                live_days, rem, b, carry, load_day, pool, futures
            )
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _stream(self, live_days, to_skip, b, carry, load_day, pool, futures):
        for pos, day in enumerate(live_days):
            n, start = self._day_window(day)
            if pool is not None and day in futures:
                cols = futures.pop(day).result()
            else:
                cols = load_day(day)
            if pool is not None and pos + 1 < len(live_days):
                nxt = live_days[pos + 1]
                futures[nxt] = pool.submit(load_day, nxt)
            start += to_skip
            to_skip = 0
            while True:
                need = b - (0 if carry is None else carry[0].shape[0])
                if start + need > n:
                    sl = slice(start, n)
                    piece = tuple(c[sl] for c in cols)
                    carry = (
                        piece
                        if carry is None
                        else tuple(np.concatenate([c, p]) for c, p in zip(carry, piece))
                    )
                    break
                sl = slice(start, start + need)
                piece = tuple(c[sl] for c in cols)
                if carry is not None:
                    piece = tuple(np.concatenate([c, p]) for c, p in zip(carry, piece))
                    carry = None
                start += need
                yield piece
        if carry is not None and carry[0].shape[0] and not self.drop_last:
            yield carry


class CriteoInMemoryDataset:
    """Single processed-npz dataset with split/randomize index logic."""

    def __init__(
        self,
        pro_data: str,
        batch_size: int,
        split: str = "train",
        randomize: str = "total",
        max_ind_range: int = -1,
        day_count_file: Optional[str] = None,
        seed: int = 123,
        drop_last: bool = False,
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        with np.load(pro_data) as data:
            self.x_int = data["X_int"]
            self.x_cat = data["X_cat"]
            self.y = data["y"]
            self.counts = data["counts"]
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        self.m_den = self.x_int.shape[1]
        self.drop_last = drop_last
        rng = np.random.default_rng(seed)

        n = len(self.y)
        indices = np.arange(n)
        if split == "none":
            if randomize == "total":
                indices = rng.permutation(indices)
            self.indices = indices
        else:
            if day_count_file is None or not path.exists(day_count_file):
                raise FileNotFoundError(
                    "split != 'none' requires the <prefix>_day_count.npz file "
                    "to delimit days (reference dlrm_data_pytorch.py:118-127)"
                )
            with np.load(day_count_file) as data:
                per_file = data["total_per_file"]
            offsets = np.concatenate([[0], np.cumsum(per_file)])
            day_indices = [
                indices[offsets[i] : offsets[i + 1]] for i in range(len(per_file))
            ]
            if randomize == "day":
                day_indices = [rng.permutation(d) for d in day_indices[:-1]] + [
                    day_indices[-1]
                ]
            train_idx = np.concatenate(day_indices[:-1])
            test_idx, val_idx = np.array_split(day_indices[-1], 2)
            if randomize == "total":
                train_idx = rng.permutation(train_idx)
            self.indices = {"train": train_idx, "test": test_idx, "val": val_idx}[split]

    @property
    def ln_emb(self) -> np.ndarray:
        return np.asarray(self.counts, dtype=np.int64)

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.indices) // self.batch_size
        return math.ceil(len(self.indices) / self.batch_size)

    def batches(self, skip: int = 0) -> Iterator[Batch]:
        b = self.batch_size
        n = len(self.indices)
        end = (n // b) * b if self.drop_last else n
        for s in range(skip * b, end, b):
            idx = self.indices[s : s + b]
            yield transform_batch(
                self.x_int[idx], self.x_cat[idx], self.y[idx], self.max_ind_range
            )

    def index_batches(self, skip: int = 0) -> Iterator[np.ndarray]:
        """Index-only view of the same stream (prefetcher second pass): just
        the [26, B] int64 sparse array per batch, skipping the X_int log1p /
        float conversions the cache stream never reads."""
        b = self.batch_size
        n = len(self.indices)
        end = (n // b) * b if self.drop_last else n
        for s in range(skip * b, end, b):
            x_cat = self.x_cat[self.indices[s : s + b]]
            if self.max_ind_range > 0:
                x_cat = x_cat % self.max_ind_range
            yield np.ascontiguousarray(x_cat.T.astype(np.int64))


class CriteoBinDataset:
    """Packed int32 binary: each sample is [y, 13 dense, 26 sparse] int32;
    batches are fixed-size contiguous blocks addressed by seek
    (reference data_loader_terabyte.py:195-235)."""

    TOT_FEA = 1 + DEN_FEA + SPA_FEA

    def __init__(
        self,
        data_file: str,
        counts_file: str,
        batch_size: int = 1,
        max_ind_range: int = -1,
        bytes_per_feature: int = 4,
        shuffle: bool = False,
        seed: int = 123,
        num_workers: int = 0,
        pin_base: Optional[int] = None,
        host_rows: Optional[tuple] = None,
    ):
        """``shuffle``: seeded batch-order permutation, the equivalent of the
        reference's RandomSampler over the bin dataset
        (dlrm_data_pytorch.py:420, gated by --mlperf-bin-shuffle). Seek
        access makes any order O(1) per batch. torch's RandomSampler draws
        a NEW permutation each epoch; the restartable-stream analog here is
        a permutation seeded per (seed, epoch) — ``batches(epoch=e)``. Both
        stream passes and the checkpoint cursor reproduce the identical
        per-epoch order (the epoch is part of the data cursor), and
        epoch 0 is bit-identical to the pre-epoch-aware order.

        ``num_workers``: reference-DataLoader-style parallel batch fetch
        (dlrm_data_pytorch.py:528-543): random access makes batches
        independently fetchable, so ``batches()`` keeps up to 2*num_workers
        reads in flight on a thread pool and yields in order. 0 = fetch on
        the calling thread.

        ``pin_base``: pin fetch threads at pin_base+id (reference
        criteo_worker_pin_fn, dlrm_data_pytorch.py:341-343).

        ``host_rows``: multi-host train-pass IO slicing — (lo, hi) row range
        of each batch this host's replicas consume (contiguous, process-
        major; parallel/multihost.py determinism doc). Only those rows are
        READ (one contiguous seek+read of (hi-lo)/batch_size of the bytes);
        rows outside come back zero so batch shapes, skip/drop-last
        accounting, and the assembly's per-replica slicing are unchanged.
        The trainer touches only its local replicas' rows by construction;
        the prefetcher's index pass (index_batches / get_index_batch) always
        reads FULL rows regardless of host_rows — cache metadata must stay
        host-identical (parallel/multihost.py invariant). The reference has
        every rank consume the full loader stream and slice on device
        (main_no_ddp.py:388-391)."""
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.data_file = data_file
        self.batch_size = batch_size
        self.max_ind_range = max_ind_range
        self.bytes_per_entry = bytes_per_feature * self.TOT_FEA * batch_size
        self.num_entries = math.ceil(os.path.getsize(data_file) / self.bytes_per_entry)
        self.total_rows = os.path.getsize(data_file) // (
            bytes_per_feature * self.TOT_FEA
        )
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.pin_base = pin_base
        if host_rows is not None:
            lo, hi = host_rows
            if not (0 <= lo < hi <= batch_size):
                raise ValueError(
                    f"host_rows {host_rows} outside [0, {batch_size}]"
                )
        self.host_rows = host_rows
        with np.load(counts_file) as data:
            self.counts = data["counts"]
        self.m_den = DEN_FEA
        # persistent per-thread file handles (reference CriteoBinDataset
        # opens once, data_loader_terabyte.py:206-210; per-batch reopen
        # costs a syscall trio per batch and defeats OS readahead). Keyed by
        # pid too: a forked worker (process prefetch backend) must not share
        # a parent's file offset.
        self._tlocal = threading.local()

    @property
    def ln_emb(self) -> np.ndarray:
        return np.asarray(self.counts, dtype=np.int64)

    def __len__(self) -> int:
        return self.num_entries

    def _file(self):
        tl = self._tlocal
        if getattr(tl, "pid", None) != os.getpid() or tl.f.closed:
            tl.f = open(self.data_file, "rb")
            tl.pid = os.getpid()
        return tl.f

    def get_batch(self, idx: int) -> Batch:
        f = self._file()
        if self.host_rows is not None:
            row_bytes = self.bytes_per_entry // self.batch_size
            n = min(self.batch_size, self.total_rows - idx * self.batch_size)
            lo, hi = self.host_rows
            lo, hi = min(lo, n), min(hi, n)
            f.seek(idx * self.bytes_per_entry + lo * row_bytes, 0)
            raw = f.read((hi - lo) * row_bytes)
            arr = np.zeros((n, self.TOT_FEA), dtype=np.int32)
            arr[lo:hi] = np.frombuffer(raw, dtype=np.int32).reshape(
                -1, self.TOT_FEA
            )
        else:
            f.seek(idx * self.bytes_per_entry, 0)
            raw = f.read(self.bytes_per_entry)
            arr = np.frombuffer(raw, dtype=np.int32).reshape(-1, self.TOT_FEA)
        return transform_batch(
            arr[:, 1 : 1 + DEN_FEA], arr[:, 1 + DEN_FEA :], arr[:, 0], self.max_ind_range
        )

    # stream callers (train/pipeline.py _batches_from, the prefetcher's
    # cache stream) pass the epoch through when this attribute is present —
    # the per-epoch-permutation protocol (torch RandomSampler parity)
    epoch_seeded_shuffle = True

    def batch_order(self, epoch: int = 0) -> np.ndarray:
        if self.shuffle:
            # seed + epoch: epoch 0 reproduces the pre-epoch-aware order
            # bit-identically (checkpoint/artifact compatibility)
            return np.random.default_rng(
                self.seed + epoch
            ).permutation(self.num_entries)
        return np.arange(self.num_entries)

    def batches(self, skip: int = 0, epoch: int = 0) -> Iterator[Batch]:
        """``skip`` counts FULL batches — the same unit as the trainer's data
        cursor, which drops the partial last batch before counting. Under
        shuffle the partial entry lands at a random permuted position, so
        skipping raw entries would desynchronize the resumed stream by one
        whenever the partial precedes the resume point. ``epoch`` selects
        the shuffle permutation (class doc)."""
        order = self.batch_order(epoch)
        if skip and os.path.getsize(self.data_file) % self.bytes_per_entry:
            partial = self.num_entries - 1  # last entry is the short one
            full_mask = order != partial
            n_skipped = np.cumsum(full_mask)
            # first position where `skip` full batches lie strictly before it
            start = int(np.searchsorted(n_skipped, skip) + 1)
            order = order[start:]
        elif skip:
            order = order[skip:]
        if self.num_workers > 0:
            # in-order sliding window of in-flight reads; each worker thread
            # gets its own persistent handle (_file is thread-local)
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            from cdlrm_tpu_torch.utils import affinity

            pin = affinity.make_pin(self.pin_base)
            depth = 2 * self.num_workers
            with ThreadPoolExecutor(
                max_workers=self.num_workers,
                **({"initializer": affinity.worker_pin, "initargs": pin}
                   if pin else {}),
            ) as pool:
                pending: deque = deque()
                for i in order:
                    pending.append(pool.submit(self.get_batch, int(i)))
                    if len(pending) >= depth:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            return
        for i in order:
            yield self.get_batch(int(i))

    def get_index_batch(self, idx: int) -> np.ndarray:
        """Sparse columns of one packed entry, bypassing the dense float
        transforms (the packed layout still reads the whole rows — one
        seek+read — but the log1p/float32/label work is skipped)."""
        f = self._file()
        f.seek(idx * self.bytes_per_entry, 0)
        raw = f.read(self.bytes_per_entry)
        arr = np.frombuffer(raw, dtype=np.int32).reshape(-1, self.TOT_FEA)
        x_cat = arr[:, 1 + DEN_FEA :]
        if self.max_ind_range > 0:
            x_cat = x_cat % self.max_ind_range
        return np.ascontiguousarray(x_cat.T.astype(np.int64))

    def index_batches(self, skip: int = 0,
                      epoch: int = 0) -> Iterator[np.ndarray]:
        """Index-only view of ``batches()``: same order (incl. the per-epoch
        shuffle and the full-batch ``skip`` unit), yielding just [26, B]
        int64 arrays."""
        order = self.batch_order(epoch)
        if skip and os.path.getsize(self.data_file) % self.bytes_per_entry:
            partial = self.num_entries - 1
            full_mask = order != partial
            n_skipped = np.cumsum(full_mask)
            start = int(np.searchsorted(n_skipped, skip) + 1)
            order = order[start:]
        elif skip:
            order = order[skip:]
        for i in order:
            yield self.get_index_batch(int(i))


def numpy_to_binary(input_files: List[str], output_path: str, split: str = "train") -> None:
    """Convert reordered/processed npz day files into the packed binary
    (reference data_loader_terabyte.py:238-275). For test/val, writes the
    first/second half of the single input day."""
    with open(output_path, "wb") as out:
        if split == "train":
            for f in input_files:
                with np.load(f) as data:
                    block = np.concatenate(
                        [data["y"].reshape(-1, 1), data["X_int"], data["X_cat"]], axis=1
                    ).astype(np.int32)
                out.write(block.tobytes())
        else:
            assert len(input_files) == 1
            with np.load(input_files[0]) as data:
                block = np.concatenate(
                    [data["y"].reshape(-1, 1), data["X_int"], data["X_cat"]], axis=1
                ).astype(np.int32)
            mid = int(np.ceil(block.shape[0] / 2.0))
            sel = block[:mid] if split == "test" else block[mid:]
            out.write(sel.tobytes())


def make_criteo_datasets(cfg):
    """Dispatcher equivalent to the reference's make_criteo_data_and_loaders
    (dlrm_data_pytorch.py:386-547): returns (train_ds, test_ds, cfg) with
    cfg.finalize(ln_emb, m_den) applied. The prefetcher's cache stream is the
    trainer's second pass over train_ds (reference cache_ld)."""
    # cfg.finalize() (which defaults test_mini_batch_size to mini_batch_size,
    # reference main_no_ddp.py:515-517) runs AFTER dataset construction needs
    # the value — resolve it here; a -1 batch size would otherwise stream
    # empty batches forever
    if cfg.test_mini_batch_size <= 0:
        cfg.test_mini_batch_size = cfg.mini_batch_size
    # loader-worker pin layout: after the cache workers (the reference
    # hardcodes 13+id, dlrm_data_pytorch.py:341-343; derived here so the
    # layout composes with main/prefetcher/eviction/worker pins —
    # config.main_start_core doc). Train and test loaders share the range:
    # they are never hot concurrently (test cadences pause the train loop)
    lpin = (
        cfg.main_start_core + 3 + cfg.cache_workers
        if cfg.pin_cores else None
    )
    if cfg.mlperf_bin_loader:
        d_path = os.path.dirname(cfg.processed_data_file) or "."
        counts_file = os.path.join(d_path, "day_fea_count.npz")
        if not path.exists(counts_file):
            base = cfg.raw_data_file.split("/")[-1].split(".")[0]
            counts_file = os.path.join(d_path, base + "_fea_count.npz")
        host_rows = None
        if cfg.data_host_slice:
            # the cluster's shape comes from the config; the port runs one
            # process today, so the slice is the whole batch
            nproc = cfg.num_hosts if cfg.num_hosts > 0 else 1
            if nproc > 1:
                # contiguous process-major replica slice of each batch
                # (trainer asserts the same layout; CriteoBinDataset
                # host_rows doc). world % nproc and batch % world are
                # enforced at Config.finalize.
                pid, b = max(cfg.host_id, 0), cfg.mini_batch_size
                host_rows = (pid * b // nproc, (pid + 1) * b // nproc)
        train = CriteoBinDataset(
            os.path.join(d_path, "train_data.bin"), counts_file,
            cfg.mini_batch_size, cfg.max_ind_range,
            shuffle=cfg.mlperf_bin_shuffle, seed=cfg.numpy_rand_seed,
            num_workers=max(0, cfg.num_workers), pin_base=lpin,
            host_rows=host_rows,
        )
        test = CriteoBinDataset(
            os.path.join(d_path, "test_data.bin"), counts_file,
            cfg.test_mini_batch_size, cfg.max_ind_range,
            num_workers=max(0, cfg.test_num_workers), pin_base=lpin,
        )
        cfg.finalize(ln_emb=train.ln_emb, m_den=train.m_den)
        return train, test, cfg

    lstr = cfg.raw_data_file.split("/")
    d_path = "/".join(lstr[0:-1]) + "/"
    d_file = lstr[-1].split(".")[0] if cfg.data_set == "kaggle" else lstr[-1]
    npzfile_prefix = d_path + (
        (d_file + "_day") if cfg.data_set == "kaggle" else d_file
    )
    days = 7 if cfg.data_set == "kaggle" else 24

    if cfg.memory_map:
        # ensure reordered day files exist (runs offline preprocessing if not)
        from cdlrm_tpu_torch.data.preprocess import get_criteo_ad_data

        if not all(
            path.exists(f"{npzfile_prefix}_{i}_reordered.npz") for i in range(days)
        ):
            get_criteo_ad_data(
                cfg.raw_data_file,
                "criteo_processed",
                max_ind_range=cfg.max_ind_range,
                sub_sample_rate=cfg.data_sub_sample_rate,
                days=days,
                randomize=cfg.data_randomize,
                criteo_kaggle=cfg.data_set == "kaggle",
                memory_map=True,
                seed=cfg.numpy_rand_seed,
            )
        train = CriteoStreamingDataset(
            npzfile_prefix, range(days - 1), cfg.mini_batch_size,
            split="train", max_ind_range=cfg.max_ind_range, drop_last=True,
            num_workers=max(0, cfg.num_workers), pin_base=lpin,
        )
        test = CriteoStreamingDataset(
            npzfile_prefix, [days - 1], cfg.test_mini_batch_size,
            split="test", max_ind_range=cfg.max_ind_range,
            num_workers=max(0, cfg.test_num_workers), pin_base=lpin,
        )
        cfg.finalize(ln_emb=train.ln_emb, m_den=train.m_den)
        return train, test, cfg

    # in-memory processed npz
    pro_data = cfg.processed_data_file
    if not pro_data or not path.exists(pro_data):
        from cdlrm_tpu_torch.data.preprocess import get_criteo_ad_data

        pro_data = get_criteo_ad_data(
            cfg.raw_data_file,
            (pro_data or d_path + "criteo_processed").split("/")[-1].replace(".npz", ""),
            max_ind_range=cfg.max_ind_range,
            sub_sample_rate=cfg.data_sub_sample_rate,
            days=days,
            randomize=cfg.data_randomize,
            criteo_kaggle=cfg.data_set == "kaggle",
            memory_map=False,
            seed=cfg.numpy_rand_seed,
        )
    day_count = d_path + d_file + "_day_count.npz"
    train = CriteoInMemoryDataset(
        pro_data, cfg.mini_batch_size, split="train",
        randomize=cfg.data_randomize, max_ind_range=cfg.max_ind_range,
        day_count_file=day_count, seed=cfg.numpy_rand_seed, drop_last=True,
    )
    test = CriteoInMemoryDataset(
        pro_data, cfg.test_mini_batch_size, split="test",
        randomize=cfg.data_randomize, max_ind_range=cfg.max_ind_range,
        day_count_file=day_count, seed=cfg.numpy_rand_seed,
    )
    cfg.finalize(ln_emb=train.ln_emb, m_den=train.m_den)
    return train, test, cfg
