"""The program's spans and counters (cdlrm_tpu_torch/utils/profiling.py):
off by default and then recording nothing, the sites in the cached trainer
on their threads with their parents and ids, the copy counters against an
independent count, the clock anchor against torch.profiler, the CLI's
trace, the kernels' launch counters, and a traced run that computes what an
untraced one does."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bench_torch
from cdlrm_tpu_torch import cli
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.data.synthetic import SyntheticDataset
from cdlrm_tpu_torch.models.dlrm import param_leaves
from cdlrm_tpu_torch.ops import lookup, scatter
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from cdlrm_tpu_torch.utils import profiling
from cdlrm_tpu_torch.utils.padding import pow2_bucket

LN_EMB = np.array([1000, 500, 2000])
LOOKAHEAD = 4
STEPS = 24
DIM = 16


def _trainer():
    cfg = Config(arch_sparse_feature_size=DIM, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
                 mini_batch_size=64, cache_size=128, num_ways=4, loss_function="bce",
                 lookahead=LOOKAHEAD, print_freq=1000, round_targets=True)
    cfg.finalize(ln_emb=LN_EMB)
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * (STEPS + 8), mini_batch_size=64,
                          seed=5, round_targets=True)
    return CachedDlrmTrainer(cfg, ds, ds, device="cpu")


@pytest.fixture(scope="module")
def traced():
    """A cached run on the CPU (stager on, dedup auto, evicting windows)
    with the spans on over training and two eval batches, and an
    independent count of the bytes ``_to_device`` returned and of each
    refill's plan sizes."""
    tr = _trainer()
    seen, plans, lock = {}, [], threading.Lock()
    to_device, refill_inputs = tr._to_device, tr._refill_device_inputs

    def counted(a, counter=None):
        out = to_device(a, counter)
        if counter is not None:
            with lock:
                seen[counter] = seen.get(counter, 0) + out.nbytes
        return out

    def refill(plan, stage_acc=True):
        with lock:
            plans.append((plan.insert_slots.shape[0], plan.evict_slots.shape[0]))
        return refill_inputs(plan, stage_acc=stage_acc)

    tr._to_device, tr._refill_device_inputs = counted, refill
    profiling.start()
    try:
        tr.train(max_steps=STEPS, log_fn=lambda *_: None)
        tr.evaluate(max_batches=2, log_fn=lambda *_: None)
        tr.eviction_manager.flush()
    finally:
        spans, counts, anchors = profiling.stop()
        tr.close()
    return dict(spans=spans, counts=counts, seen=seen, plans=plans,
                main=threading.current_thread().name)


def _upto(n):
    return set(range(n))


# name: (thread, parent, check of the ids it carries)
SITES = {
    "train.step": ("main", None, lambda s: {x.step for x in s} == _upto(STEPS)),
    "train.wait_batch": ("main", None, lambda s: _upto(STEPS) <= {x.step for x in s}),
    "train.wait_window": ("main", None,
                          lambda s: {x.step for x in s} == set(range(0, STEPS, LOOKAHEAD))),
    "train.refill": ("main", None, lambda s: {(x.step, x.window) for x in s}
                     == {(w * LOOKAHEAD, w) for w in range(STEPS // LOOKAHEAD)}),
    "train.flush": ("main", None, lambda s: {x.step for x in s} == {STEPS}),
    "pipeline.assemble": ("assembly-pipeline", None,
                          lambda s: _upto(STEPS) <= {x.step for x in s}),
    "pipeline.probe": ("assembly-pipeline", "pipeline.assemble",
                       lambda s: _upto(STEPS) <= {x.step for x in s}),
    "pipeline.h2d": ("assembly-pipeline", "pipeline.assemble",
                     lambda s: _upto(STEPS) <= {x.step for x in s}),
    "prefetch.window": ("lookahead-prefetcher", None,
                        lambda s: _upto(STEPS // LOOKAHEAD) <= {x.window for x in s}),
    "prefetch.gather": ("lookahead-prefetcher", "prefetch.window",
                        lambda s: _upto(STEPS // LOOKAHEAD) <= {x.window for x in s}),
    "prefetch.plan": ("lookahead-prefetcher", "prefetch.window",
                      lambda s: _upto(STEPS // LOOKAHEAD) <= {x.window for x in s}),
    "prefetch.stats": ("lookahead-prefetcher", "prefetch.window",
                       lambda s: _upto(STEPS // LOOKAHEAD) <= {x.window for x in s}),
    "stage.window": ("window-stager", None,
                     lambda s: _upto(STEPS // LOOKAHEAD) <= {x.window for x in s}),
    "stage.h2d": ("window-stager", "stage.window",
                  lambda s: _upto(STEPS // LOOKAHEAD) <= {x.window for x in s}),
    "evict.writeback": ("eviction-manager", None,
                        lambda s: {x.window for x in s} <= set(range(1, STEPS // LOOKAHEAD))),
    "evict.d2h_wait": ("eviction-manager", "evict.writeback",
                       lambda s: {x.window for x in s} <= set(range(1, STEPS // LOOKAHEAD))),
}


@pytest.mark.parametrize("name", sorted(SITES))
def test_each_site_records_on_its_thread_with_its_parent_and_ids(traced, name):
    thread, parent, ids_ok = SITES[name]
    thread = traced["main"] if thread == "main" else thread
    by_id = {s.id: s for s in traced["spans"]}
    mine = [s for s in traced["spans"] if s.name == name and s.thread == thread]
    assert mine, name
    # the eval producer probes and stages too, on its own thread
    others = {s.thread for s in traced["spans"] if s.name == name} - {thread}
    assert others <= {"eval-pipeline"}, others
    for s in mine:
        assert s.end_ns >= s.start_ns
        got = by_id[s.parent].name if s.parent >= 0 else None
        assert got == parent, (name, got)
        if parent is not None:
            assert (s.step, s.window) == (by_id[s.parent].step, by_id[s.parent].window)
    assert ids_ok(mine), sorted((s.step, s.window) for s in mine)


@pytest.mark.parametrize("kind", ["batch", "refill", "eval"])
def test_copy_counters_equal_the_bytes_that_crossed(traced, kind):
    counter = f"h2d_bytes.{kind}"
    assert traced["counts"][counter] == traced["seen"][counter] > 0


def test_refill_padding_counter_equals_the_buckets_less_the_plans(traced):
    row, slot = DIM * 4, 4  # float32 rows and int32 slots
    want = sum((pow2_bucket(n) - n) * (row + slot) + (pow2_bucket(e) - e) * slot
               for n, e in traced["plans"])
    assert traced["counts"]["h2d_pad_bytes.refill"] == want > 0
    assert any(e > 0 for _, e in traced["plans"])  # the run evicts


def test_spans_off_record_nothing_and_counters_still_count():
    profiling.start()
    profiling.stop()
    assert not profiling.tracing()
    before = profiling.counters().get("c", 0)
    a, b = profiling.span("x", step=1), profiling.span("y")
    assert a is b  # one shared object, nothing made a call
    with a:
        profiling.count("c", 2)
    profiling.count("c", 3)
    spans, counts, anchors = profiling.stop()
    assert spans == [] and anchors == [] and counts == {"c": 5}
    # the counters are never reset: start() only moves the base stop() subtracts
    assert profiling.counters()["c"] == before + 5
    profiling.start()
    assert profiling.stop()[1] == {}


def test_a_span_takes_its_threads_cpu_time():
    """A span that sleeps ran for little of its wall time; one that spins
    ran for some of it (a loaded machine may take the core away)."""
    profiling.start()
    with profiling.span("sleeps"):
        time.sleep(0.05)
    with profiling.span("spins"):
        t = time.perf_counter()
        while time.perf_counter() - t < 0.02:
            pass
    spans, _, _ = profiling.stop()
    by = {s.name: s for s in spans}
    sleeps, spins = by["sleeps"], by["spins"]
    assert 0 <= sleeps.cpu_ns < 0.5 * (sleeps.end_ns - sleeps.start_ns)
    assert 0 < spins.cpu_ns <= 1.05 * (spins.end_ns - spins.start_ns) + 1_000_000


def test_spans_nest_per_thread_and_children_take_their_parents_ids():
    profiling.start()
    with profiling.span("outer", step=3):
        with profiling.span("inner", window=7):
            pass

    def other():
        with profiling.span("elsewhere", window=2):
            pass

    th = threading.Thread(target=other, name="other-thread")
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    spans, _, _ = profiling.stop()
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "inner", "elsewhere"}
    assert by["inner"].parent == by["outer"].id and (by["inner"].step, by["inner"].window) == (3, 7)
    assert by["outer"].parent == -1 and by["elsewhere"].parent == -1
    assert by["elsewhere"].thread == "other-thread" and by["outer"].thread != "other-thread"
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns


def test_counters_lose_no_update_across_threads():
    before = profiling.counters().get("k", 0)
    n, threads = 20000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [profiling.count("k", 1) for _ in range(n)])
              for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters()["k"] - before == n * threads


def test_the_anchor_maps_a_span_around_a_profiled_annotation(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.start()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        with profiling.span("around"):
            time.sleep(0.003)
            with record_function("inside"):
                time.sleep(0.002)
            time.sleep(0.003)
    finally:
        prof.stop()
        spans, _, anchors = profiling.stop()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    offset = profiling.anchor_offset_ns(trace["traceEvents"], anchors, base)
    assert offset is not None
    (around,) = [s for s in spans if s.name == "around"]
    (inside,) = [e for e in trace["traceEvents"] if e.get("name") == "inside"]
    a = around.start_ns + offset
    b = around.end_ns + offset
    lo = 1e3 * float(inside["ts"]) + base
    hi = lo + 1e3 * float(inside["dur"])
    assert a <= lo and hi <= b, (lo - a, b - hi)


def test_the_cli_trace_holds_the_program_spans(tmp_path):
    trace_dir = str(tmp_path / "trace")
    assert cli.main(["--device", "cpu", "--data-generation", "random", "--arch-embedding-size",
                     "1000-500-2000", "--arch-sparse-feature-size", "16", "--arch-mlp-bot",
                     "13-32-16", "--arch-mlp-top", "16-8-1", "--mini-batch-size", "64",
                     "--num-batches", "12", "--cache-size", "128", "--num-ways", "4",
                     "--loss-function", "bce", "--lookahead", "4", "--print-freq", "6",
                     "--test-freq", "6", "--test-mini-batch-size", "64",
                     "--enable-profiling", "--profile-dir", trace_dir]) == 0
    assert not profiling.tracing()
    with open(os.path.join(trace_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "cdlrm_span"]
    names = {e["name"] for e in spans}
    assert {"train.step", "pipeline.assemble", "prefetch.window", "stage.window"} <= names
    lanes = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("pid") == spans[0]["pid"]}
    assert {"assembly-pipeline", "lookahead-prefetcher", "window-stager"} <= lanes
    # the steps' operators lie inside the steps' spans on the profiler's clock
    steps = [e for e in spans if e["name"] == "train.step"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == steps[0]["tid"]]
    inside = [e for e in ops if any(s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                                    for s in steps)]
    assert len(inside) > len(ops) // 2
    # each counter that moved is a series of its track, from 0 at the
    # scope's start to what it added by the scope's end (the evaluations at
    # steps 6 and 12 copy their batches inside the scope)
    tracks = [e for e in events if e.get("ph") == "C" and e.get("pid") == spans[0]["pid"]]
    first, last = [e for e in tracks if e["name"] == "h2d_bytes"]
    assert first["ts"] < last["ts"] and set(first["args"]) == set(last["args"])
    assert set(first["args"].values()) == {0}
    assert all(last["args"][k] > 0 for k in ("batch", "refill", "eval"))


def test_launch_counts_come_from_the_tracer():
    for fn in (lookup.gather_rows, lookup.index_add_rows, scatter.scatter_set_rows,
               scatter.scatter_add_rows):
        assert not hasattr(fn, "launches")
    bench_torch.reset_launches()
    assert bench_torch.read_launches() == dict.fromkeys(bench_torch.KERNELS, 0)
    profiling.count("launches.scatter_add_rows", 3)
    assert bench_torch.read_launches() == dict(dict.fromkeys(bench_torch.KERNELS, 0),
                                               scatter_add_rows=3)
    bench_torch.reset_launches()
    assert bench_torch.read_launches()["scatter_add_rows"] == 0
    # a reset leaves a tracing session's spans and counters alone
    profiling.start()
    with profiling.span("kept"):
        profiling.count("launches.gather_rows", 2)
        bench_torch.reset_launches()
    spans, counts, _ = profiling.stop()
    assert [s.name for s in spans] == ["kept"] and counts == {"launches.gather_rows": 2}


def _held_run(trace: bool):
    """Train and evaluate with the eviction thread held (every writeback
    applied at the end, on this thread), so that two runs are
    deterministic; returns what the run computed."""
    tr = _trainer()
    tr.eviction_manager.start = lambda: None
    if trace:
        profiling.start()
    try:
        m = tr.train(max_steps=STEPS, log_fn=lambda *_: None)
        tr.eviction_manager.flush()
        acc, auc = tr.evaluate(max_batches=2, log_fn=lambda *_: None)
        masters = [tr.master.gather(t, np.arange(n)) for t, n in enumerate(LN_EMB)]
        params = [p.detach().clone() for p in param_leaves(tr.params)]
        return dict(loss=(m.loss_sum, m.correct), eval=(acc, auc), cache=tr.cache.clone(),
                    params=params, masters=masters, written=tr.eviction_manager.rows_written)
    finally:
        if trace:
            assert profiling.stop()[0]
        tr.close()


def test_a_traced_run_computes_what_an_untraced_one_does():
    off, on = _held_run(False), _held_run(True)
    assert on["loss"] == off["loss"] and on["eval"] == off["eval"]
    assert torch.equal(on["cache"], off["cache"])
    assert all(torch.equal(a, b) for a, b in zip(on["params"], off["params"]))
    assert all(np.array_equal(a, b) for a, b in zip(on["masters"], off["masters"]))
    assert on["written"] == off["written"] > 0
