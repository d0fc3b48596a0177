"""One run of one cell: build the cell's trainer, warm it up, drive the
program's own entry (``train`` or the pipelined ``evaluate``) for the
measured window, read the metrics, and judge what the timed path produced
against the plain reference.

Everything about a cell is found by name: its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``, read by
streams.py), its per-layer metrics (``metrics/<metric>.py``) and its limits
(``limits/<cell>.json``).

The window. A training cell calls ``train()`` once: the first
``warmup_steps`` steps are set-up; the window starts when the last of them
has finished on the device, and the stream that the harness hands over stops
at the deadline (on a lookahead window boundary for the cached trainer), so
the window ends when ``train()`` returns and the device has finished. A
scoring cell fills the cache with ``fill_steps`` steps at learning rate 0 in
set-up (the served model is the seed's), then calls ``evaluate()`` once,
with ``warmup_batches`` batches of set-up before its window.

The harness wraps, on the trainer instance only, the step callables (an
event after each step, the first three steps' state for the check, the
traced stretch), the refill (its plan's sizes; at the second window's
refill, the evicted and inserted rows for the check) and the eval step (the
sampled scores). Nothing else is synchronized inside the window.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from perfbench import check, counts, streams
from perfbench.trace import Stretch, summarize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "cdlrm_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict  # the configuration file
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]

    @property
    def kw(self) -> dict:
        return self.config["config"]


def resolve(spec: dict, workload: str, here: str = HERE) -> Cell:
    """The cell of BENCHMARK.json named ``workload``, with every file it
    names loaded."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    cfg_file = load_json(os.path.join(ROOT, conf["file"]))

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload,
        config_name=w["config"],
        config=cfg_file,
        traffic=load_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if reports(m)],
        per_layer=[m for m in spec["per_layer"] if reports(m)],
        limits=load_json(os.path.join(here, "limits", workload + ".json")),
    )


def load_metric(name: str, here: str = HERE):
    """The reader module of per-layer metric ``name``."""
    path = os.path.join(here, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi unavailable"


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Counters:
    """The cached trainer's counters at one moment (zeros for the full-table
    trainer, which keeps none)."""

    eval_hits: int = 0
    eval_lookups: int = 0
    caching_overhead_s: float = 0.0
    refills: int = 0

    @classmethod
    def of(cls, trainer) -> "Counters":
        m = getattr(trainer, "metrics", None)
        if m is None:
            return cls()
        return cls(m.eval_hits, m.eval_lookups, m.caching_overhead_s, m.refills)


@dataclass
class Record:
    """What a run measured: the metric readers read it."""

    cell: Cell
    kind: str  # "cached" or "fulltable"
    entry: str  # "train" or "score"
    batch: int
    window_steps: int = 0
    window_s: float = 0.0
    start: Counters = field(default_factory=Counters)
    end: Counters = field(default_factory=Counters)
    trace: Optional[dict] = None
    stretch_steps: int = 0
    stretch_row_bytes: int = 0
    # (rows inserted, rows evicted) of each refill inside the window
    refills: List[tuple] = field(default_factory=list)


class WritebackCheck:
    """The cache's traffic with the masters at one refill of the warm-up,
    the one before step ``at`` (the second window's: the cache is full
    enough to evict): a sample, drawn from the seed, of the ids it evicts
    with their cache rows just before it, and of the ids it inserts with
    their cache rows just after it. Before the last warm-up step, behind the
    program's eviction fence (``EvictionManager.flush``), the evicted ids'
    rows are read from the masters; no refill falls in between, so each has
    to be what the cache held, bit for bit. An inserted row has to be the
    master's initial row, which the reference works out again (ids evicted
    by an earlier refill are left out: a row read while its writeback is in
    flight may be either value, as the program's design allows)."""

    SAMPLE = 65536

    def __init__(self, trainer, seed: int, at: int):
        self.trainer, self.at = trainer, at
        self.rng = np.random.default_rng([seed, 11])
        self.earlier: List[np.ndarray] = []  # keys of ids evicted before ``at``
        self.evicted = None  # (tables, ids, cache rows before the refill)
        self.inserted = None  # (tables, ids, slots), then the rows after it
        self.master_rows: Optional[np.ndarray] = None

    def _pick(self, n: int) -> np.ndarray:
        if n <= self.SAMPLE:
            return np.arange(n)
        return np.sort(self.rng.choice(n, size=self.SAMPLE, replace=False))

    def _cache_rows(self, slots: np.ndarray) -> np.ndarray:
        import torch

        idx = torch.from_numpy(np.asarray(slots, np.int64)).to(self.trainer.device)
        return torch.index_select(self.trainer.cache, 0, idx).cpu().numpy()

    @staticmethod
    def keys(tables: np.ndarray, ids: np.ndarray) -> np.ndarray:
        return (np.asarray(tables, np.int64) << 32) | np.asarray(ids, np.int64)

    def before(self, at: int, spec) -> None:
        if spec is None or at > self.at:
            return
        if at < self.at:
            self.earlier.append(self.keys(spec.evict_tables, spec.evict_idxs))
            return
        e = self._pick(spec.evict_slots.size)
        self.evicted = (np.asarray(spec.evict_tables[e], np.int64),
                        np.asarray(spec.evict_idxs[e], np.int64),
                        self._cache_rows(spec.evict_slots[e]))
        i = self._pick(spec.insert_slots.size)
        self.inserted = (np.asarray(spec.insert_tables[i], np.int64),
                         np.asarray(spec.insert_ids[i], np.int64), spec.insert_slots[i])

    def after(self, at: int) -> None:
        if at == self.at and self.inserted is not None:
            t, ids, slots = self.inserted
            self.inserted = (t, ids, self._cache_rows(slots))

    def fence(self) -> None:
        if self.evicted is None:
            return
        self.trainer.eviction_manager.flush()
        tables, ids, _ = self.evicted
        rows = np.empty_like(self.evicted[2])
        for t in np.unique(tables):
            sel = tables == t
            rows[sel] = self.trainer.master.gather(int(t), ids[sel])
        self.master_rows = rows

    def readings(self) -> Optional[dict]:
        """The program's side of the check (``check.writeback_numbers``),
        or None where the refill or the fence never came."""
        if self.evicted is None or self.master_rows is None or self.inserted is None:
            return None
        t, ids, rows = self.inserted
        keep = ~np.isin(self.keys(t, ids), np.concatenate(self.earlier or [np.zeros(0, np.int64)]))
        return {"evicted_cache": self.evicted[2], "evicted_master": self.master_rows,
                "inserted": (t[keep], ids[keep], rows[keep])}


class Probe:
    """The wrappers around the trainer's step callables."""

    def __init__(self, trainer, device, warmup: int, seconds: float,
                 deadline: streams.Deadline, stretches=(), keep=None, rows_fn=None):
        """``stretches``: (Stretch, first call, end call) to profile."""
        self.trainer, self.device = trainer, device
        self.warmup, self.seconds, self.deadline = warmup, seconds, deadline
        self.stretches = list(stretches)
        self.keep = keep
        self.rows_fn = rows_fn
        self.calls = 0
        self.events: list = []
        self.t_start: Optional[float] = None
        self.start_counters: Optional[Counters] = None
        self.stretch_calls: Dict[int, List[int]] = {id(st): [] for st, _, _ in self.stretches}
        self.losses: Dict[int, object] = {}
        self.states: Dict[int, tuple] = {}
        self.kept: Dict[int, object] = {}
        self.refills: List[tuple] = []
        self.writeback: Optional[WritebackCheck] = None
        self._wrapped: Dict[int, object] = {}
        self.on_cuda = device.type == "cuda"

    def _sync(self):
        import torch

        if self.on_cuda:
            torch.cuda.synchronize(self.device)

    def _mark(self):
        import torch

        if self.on_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        else:
            self.events.append(time.perf_counter())

    def _begin_window(self):
        self._sync()
        self.t_start = self.deadline.start(self.seconds)
        self.start_counters = Counters.of(self.trainer)

    def _trace_before(self, i: int):
        for st, lo, _ in self.stretches:
            if i == lo:
                st.start()

    def _trace_after(self, i: int, size: int):
        for st, lo, hi in self.stretches:
            if lo <= i < hi:
                self.stretch_calls[id(st)].append(i)
                if i + size >= hi:
                    st.stop()

    def before(self, i: int, params, table):
        if self.writeback is not None and i == self.warmup - 1:
            self.writeback.fence()
        self._trace_before(i)
        if self.rows_fn is not None and i == 0:
            self.states[-1] = (params, self.rows_fn(table))

    def after(self, i: int, out, size: int):
        self._mark()
        if self.rows_fn is not None and i in (0, 2):
            self.states[i] = (out[0], self.rows_fn(out[1]))
        if self.rows_fn is not None and i < 3:
            self.losses[i] = out[-2]
        self._trace_after(i, size)
        if i + size == self.warmup:
            self._begin_window()

    def span(self, name: str):
        """A host annotation in traced runs (the breakdown's gap labels)."""
        if not self.stretches:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def wrap_train(self, fn):
        key = id(fn)
        if key in self._wrapped:
            return self._wrapped[key]

        def wrapped(params, table, *args, **kw):
            i = self.calls
            self.before(i, params, table)
            with self.span("perfbench: train step call"):
                out = fn(params, table, *args, **kw)
            self.calls += 1
            self.after(i, out, 1)
            return out

        self._wrapped[key] = wrapped
        return wrapped

    def wrap_eval(self, fn):
        def wrapped(params, cache, *args):
            i = self.calls
            self._trace_before(i)
            with self.span("perfbench: eval step call"):
                out = fn(params, cache, *args)
            if self.keep is not None and self.keep(i):
                self.kept[i] = out[1].detach().clone()
            self.calls += 1
            self._trace_after(i, 1)
            if i + 1 == self.warmup:
                self._begin_window()
            return out

        return wrapped

    def wrap_refill(self, fn):
        def wrapped(window, *args, **kw):
            spec, at = window.plan_spec, self.calls
            if spec is not None:
                self.refills.append((at, int(spec.insert_slots.size), int(spec.evict_slots.size)))
            if self.writeback is not None:
                self.writeback.before(at, spec)
            with self.span("perfbench: refill"):
                out = fn(window, *args, **kw)
            if self.writeback is not None:
                self.writeback.after(at)
            return out

        return wrapped

    def wrap_pipeline_start(self, fn):
        """Annotate the train loop's waits on the assembly pipeline."""
        def wrapped():
            fn()
            pipe = self.trainer._pipe
            get = pipe.get

            def waited():
                with self.span("perfbench: train loop waits for the pipeline"):
                    return get()

            pipe.get = waited

        return wrapped

    def step_gaps_ms(self) -> np.ndarray:
        """The gaps between consecutive step completions in the window."""
        ev = self.events
        if self.on_cuda:
            gaps = [ev[i - 1].elapsed_time(ev[i]) for i in range(self.warmup, len(ev))]
        else:
            gaps = [1e3 * (ev[i] - ev[i - 1]) for i in range(self.warmup, len(ev))]
        return np.asarray(gaps, np.float64)


def build_config(cell: Cell, seed: int):
    """The program's Config of the cell; a scoring cell's at learning rate
    0 (its fill only fills the cache, and scoring takes no learning rate)."""
    from cdlrm_tpu_torch.config import Config

    kw = {k: v for k, v in cell.kw.items() if k != "ln_emb"}
    if cell.traffic["entry"] == "score":
        kw.update(learning_rate=0.0, lr_embeds=0.0)
    cfg = Config(**kw, numpy_rand_seed=int(seed))
    return cfg.finalize(ln_emb=np.asarray(cell.kw["ln_emb"], dtype=np.int64))


def _cached_rows_fn(trainer, ids: List[np.ndarray]):
    """Reads the rows of ``ids`` (sorted, per table) from the cache, through
    the program's slot map; the slots are resolved once, before step 1."""
    import torch

    slots = []
    for t, idx in enumerate(ids):
        s = trainer.controller.resident_slots(t, idx)
        if np.any(s < 0):
            raise RuntimeError(f"table {t}: {int((s < 0).sum())} of the first steps' ids "
                               "are not resident after the first refill")
        slots.append(np.asarray(s, np.int64))
    sizes = [s.size for s in slots]
    flat = torch.from_numpy(np.concatenate(slots)).to(trainer.device)

    def rows(cache):
        return (torch.index_select(cache, 0, flat).clone(), sizes)

    return rows


def _fulltable_rows_fn(trainer, ids: List[np.ndarray]):
    import torch

    rows_idx = np.concatenate([idx + int(off) for idx, off in zip(ids, trainer.table_offsets)])
    sizes = [idx.size for idx in ids]
    flat = torch.from_numpy(rows_idx.astype(np.int64)).to(trainer.device)

    def rows(tables):
        return (torch.index_select(tables, 0, flat).clone(), sizes)

    return rows


def _host_state(state) -> tuple:
    from cdlrm_tpu_torch.models.dlrm import param_leaves

    params, (rows, sizes) = state
    dense = [t.detach().double().cpu().numpy() for t in param_leaves(params)]
    flat = rows.double().cpu().numpy()
    return dense, np.split(flat, np.cumsum(sizes)[:-1])


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run; returns the result line's fields (the caller prints it)."""
    import torch

    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
    from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

    age0, t0 = process_age_s(), time.perf_counter()
    on_cuda = device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cfg = build_config(cell, seed)
    kw, tr = cell.kw, cell.traffic
    cached = bool(kw.get("use_cache", True))
    kind = "cached" if cached else "fulltable"
    entry = tr["entry"]
    ln_emb = np.asarray(kw["ln_emb"], dtype=np.int64)
    batch = int(kw["mini_batch_size"])
    deadline = streams.Deadline()
    # the stretch that the per-layer metrics read is traced on the device
    # alone; a shorter one after it, with the host's operators, labels the
    # idle gaps of the breakdown
    stretch = Stretch(device) if trace else None
    labels = Stretch(device, host=True) if trace else None
    rec = Record(cell=cell, kind=kind, entry=entry,
                 batch=batch if entry == "train" else int(kw["test_mini_batch_size"]))

    if entry == "train":
        train_ds = streams.Stream(ln_emb, batch, tr["ids"], seed, deadline=deadline,
                                  pool_examples=int(tr["pool_examples"]),
                                  align=cfg.lookahead if cached else 1, wrap=not cached)
        test_ds = None
        warmup = int(tr["warmup_steps"])
        trace_at, trace_len = warmup + int(tr["trace_offset"]), int(tr["trace_steps"])
    else:
        fill = int(tr["fill_steps"])
        train_ds = streams.Stream(ln_emb, batch, tr["fill_ids"], seed, limit=fill,
                                  pool_examples=fill * batch)
        test_ds = streams.Stream(ln_emb, rec.batch, tr["ids"], seed, salt=1, deadline=deadline,
                                 pool_examples=int(tr["pool_examples"]))
        warmup = int(tr["warmup_batches"])
        trace_at, trace_len = warmup + int(tr["trace_offset"]), int(tr["trace_batches"])

    probe = None
    trainer = None
    try:
        if cached:
            trainer = CachedDlrmTrainer(cfg, train_ds, test_ds, device=device, pooled_width=0)
        else:
            trainer = FullTableDlrmTrainer(cfg, train_ds, test_ds, device=device)
        stretches = []
        if trace:
            stretch.warm()
            label_at = trace_at + trace_len + int(tr["trace_offset"])
            stretches = [(stretch, trace_at, trace_at + trace_len),
                         (labels, label_at, label_at + max(1, trace_len // 4))]
        check_ids = None
        if entry == "train":
            first = train_ds.head(3)
            from perfbench.reference.dlrm import touched_ids

            check_ids = touched_ids(first, len(ln_emb))
            probe = Probe(trainer, device, warmup, seconds, deadline, stretches)
            if cached:
                orig_get = trainer._get_step

                def get_step(size, dedup, coalesce=False):
                    if size != 1:
                        raise RuntimeError("the benchmark drives single steps (scan_steps 1)")
                    return probe.wrap_train(orig_get(size, dedup, coalesce))

                trainer._get_step = get_step
                if not 0 < cfg.lookahead < warmup:
                    raise ValueError("a cached cell warms up past its second window's refill")
                probe.writeback = WritebackCheck(trainer, seed, at=cfg.lookahead)
                trainer._apply_refill = probe.wrap_refill(trainer._apply_refill)
                if trace:
                    trainer._start_pipeline = probe.wrap_pipeline_start(trainer._start_pipeline)
                rows_getter = {"fn": None}

                def rows_fn(cache):
                    if rows_getter["fn"] is None:
                        rows_getter["fn"] = _cached_rows_fn(trainer, check_ids)
                    return rows_getter["fn"](cache)

                probe.rows_fn = rows_fn
            else:
                trainer.train_step = probe.wrap_train(trainer.train_step)
                probe.rows_fn = _fulltable_rows_fn(trainer, check_ids)
            trainer.train(log_fn=lambda s: None)
        else:
            # the trainer was built at learning rate 0: the fill leaves the
            # model the seed's and fills the cache with its rows
            trainer.train(max_steps=int(tr["fill_steps"]), log_fn=lambda s: None)
            rng = np.random.default_rng([seed, 7])
            every = int(tr["check_every"])
            offset = int(rng.integers(every))
            probe = Probe(trainer, device, warmup, seconds, deadline, stretches,
                          keep=lambda i: i >= warmup and i % every == offset)
            trainer.eval_step = probe.wrap_eval(trainer.eval_step)
            trainer.evaluate(log_fn=lambda s: None)
        if on_cuda:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        if probe.t_start is None:
            raise RuntimeError(f"the run ended within its {warmup} warm-up steps")
        for st, _, _ in stretches:
            st.stop()
        rec.window_s = t_end - probe.t_start
        rec.window_steps = probe.calls - warmup
        rec.start = probe.start_counters
        rec.end = Counters.of(trainer)
        setup_s = age0 + (probe.t_start - t0)
        peak = int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0
        gaps = probe.step_gaps_ms() if entry == "train" else None
        prog_train = None
        if entry == "train":
            prog_train = {
                "loss": [float(probe.losses[i]) / batch for i in range(3)],
                "state": [_host_state(probe.states[k]) for k in (-1, 0, 2)],
            }
        prog_scores = {i: s.double().cpu().numpy()[:, 0] for i, s in probe.kept.items()
                       if i < probe.calls}
        refills = list(probe.refills)
        rec.refills = [(ins, ev) for at, ins, ev in refills if at >= warmup]
        wb = probe.writeback.readings() if probe.writeback is not None else None
        stretch_calls = list(probe.stretch_calls.get(id(stretch), []))
    finally:
        if trainer is not None:
            trainer.close()
    trainer = probe = None
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    # ---- per-layer readings of the traced stretch
    if stretch is not None and stretch.done:
        rec.trace = summarize(stretch, labels if labels.done else None)
        rec.stretch_steps = len(stretch_calls)
        if entry == "train" and stretch_calls:
            lo, hi = stretch_calls[0], stretch_calls[-1] + 1
            heads = train_ds.head(hi)
            dim = int(kw["arch_sparse_feature_size"])
            parts = [counts.train_row_bytes(b.ls_i, dim) for b in heads[lo:hi]]
            # a refill applied between two steps of the stretch
            parts += [counts.refill_row_bytes(ins, ev, dim)
                      for at, ins, ev in refills if lo < at < hi]
            rec.stretch_row_bytes = int(sum(parts))

    # ---- the check, once the window has closed and the program is freed
    lr = float(np.float32(kw["learning_rate"]))
    lr_emb = float(np.float32(kw["lr_embeds"]))
    ref_cfg = dict(kw, learning_rate=lr, lr_embeds=lr_emb)
    from perfbench.reference import dlrm as ref

    if entry == "train":
        ref_out = ref.three_steps(ref_cfg, seed, first, device, ids=check_ids)
        worst: Dict[str, int] = {}
        numbers = check.train_numbers(prog_train, ref_out, lr, lr_emb,
                                      n_dense=len(ref_out["state"][0][0]), worst=worst)
        if cached:
            ref_ins = None
            if wb is not None:
                t, ids, _ = wb["inserted"]
                ref_ins = ref.initial_rows(ref_cfg, seed, t, ids)
            numbers.update(check.writeback_numbers(wb, ref_ins))
    else:
        idx = sorted(prog_scores)
        held = test_ds.head(idx[-1] + 1 if idx else 0)
        ref_scores = ref.seed_scores(ref_cfg, seed, [held[i] for i in idx], device)
        numbers = check.score_numbers([prog_scores[i] for i in idx], ref_scores)
    correct = check.judge(numbers, cell.limits)

    # ---- metrics
    metrics: Dict[str, dict] = {}
    if not trace:
        for m in cell.end_to_end:
            name = m["name"]
            if name == "setup_s":
                value = setup_s
            elif name.endswith("examples_per_s"):
                value = rec.window_steps * rec.batch / rec.window_s
            elif name == "train_step_ms_p95":
                value = float(np.percentile(gaps, 95))
            else:
                raise KeyError(f"the harness does not measure {name!r}")
            metrics[name] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on_cuda else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": int(rec.window_steps), "failed": 0,
           "metrics": metrics, "device": dev_info}
    if trace and rec.trace is not None:
        dev_info["busy_s"] = float(rec.trace["busy_s"])
        dev_info["window_s"] = float(rec.trace["window_s"])
        out["breakdown"] = rec.trace["breakdown"]
    out["info"] = {"window_s": rec.window_s, "window_steps": rec.window_steps,
                   "batch": rec.batch, "refills": rec.end.refills - rec.start.refills,
                   "step_count": None if gaps is None else int(gaps.size),
                   "checked_batches": len(prog_scores) if entry == "score" else 3,
                   "pool_batches": len((train_ds if entry == "train" else test_ds).pool),
                   "rows_inserted": sum(ins for ins, _ in rec.refills),
                   "rows_evicted": sum(ev for _, ev in rec.refills)}
    if wb is not None:
        out["info"]["writeback_checked"] = {"evicted": int(wb["evicted_cache"].shape[0]),
                                            "inserted": int(wb["inserted"][0].size)}
    if entry == "train":
        out["info"]["losses"] = {"program": prog_train["loss"], "reference": ref_out["loss"]}
        out["info"]["worst_leaf"] = worst
        out["info"]["gaps_ms"] = {f"p{q}": float(np.percentile(gaps, q)) for q in (50, 90, 95, 99)}
    out["check"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))
