"""The readers of the program's spans and counters (perfbench/spans.py and
their files under metrics/) on a record whose spans are known, with a
profiled stretch whose steps they must leave out, and the command's flow on
the CPU at test size."""

import statistics

import pytest
import torch

from cdlrm_tpu_torch.utils.profiling import ANCHOR, Anchor, Span
from perfbench import harness, spans
from perfbench.tests import tiny

SLOT_MS = 30  # each step's spans lie inside its own 30 ms of the clock
STEPS = 200
PROFILED = (50, 60)  # dropped with one step each side: 49 ... 60
SLOW = range(100, 105)  # steps whose dispatch takes 25 ms
MS = 1_000_000
BATCH_B, REFILL_B, PAD_B = 170_000, 54_000_000, 22_000_000


def _stretch_ns(lo, hi):
    """A stretch as the harness runs it: started inside step ``lo``'s call,
    stopped (and exported) inside step ``hi - 1``'s; tracer clock."""
    return (lo * SLOT_MS * MS + MS // 2, (hi - 1) * SLOT_MS * MS + 20 * MS)


def _record(with_spans=True):
    rec = harness.Record(cell=tiny.cell("cached", "train"), kind="cached", entry="train",
                         batch=64, window_steps=STEPS, window_s=6.0)
    if not with_spans:
        return rec
    out, ids = [], iter(range(10**6))

    def add(name, thread, step, a_ms, b_ms, window=None, cpu_ms=None):
        t = step * SLOT_MS * MS
        cpu = -1 if cpu_ms is None else int(cpu_ms * MS)
        out.append(Span(name, thread, t + int(a_ms * MS), t + int(b_ms * MS), step, window,
                        next(ids), -1, 1, cpu))

    for i in range(STEPS):
        prof = PROFILED[0] <= i < PROFILED[1]
        add("train.step", "MainThread", i, 0, 28 if prof else 25 if i in SLOW else 9,
            cpu_ms=4 if i in SLOW else None)
        add("train.wait_batch", "MainThread", i, 1, 2)
        add("pipeline.probe", "assembly-pipeline", i, 2, 2.5)
        if i % 10 == 0:
            add("train.wait_window", "MainThread", i, 3, 6)
        if i % 10 == 5:
            add("prefetch.stats", "lookahead-prefetcher", i, 4, 8, window=i // 10)
        if i % 10 == 7:
            add("evict.writeback", "eviction-manager", i, 2, 8, window=i // 10)
    rec.spans = out
    rec.counters = {"h2d_bytes.batch": STEPS * BATCH_B, "h2d_bytes.refill": 20 * REFILL_B,
                    "h2d_pad_bytes.refill": 20 * PAD_B, "h2d_bytes.eval": 10**9}
    rec.profiled = [_stretch_ns(*PROFILED)]
    return rec


KEPT = STEPS - (PROFILED[1] - PROFILED[0] + 2)  # 188
WANT = {
    "pipeline.batch_wait_ms_per_step": 1.0,
    "pipeline.window_wait_ms_per_step": 3.0 * 18 / KEPT,  # windows at 50 and 60 dropped
    "step.dispatch_ms_per_step": (9.0 * (KEPT - 5) + 25.0 * 5) / KEPT,
    "step.dispatch_ms_p99": statistics.quantiles([9.0] * (KEPT - 5) + [25.0] * 5, n=100)[98],
    "probe.ms_per_step": 0.5,
    "pipeline.prefetch_stats_ms_per_step": 4.0 * 19 / KEPT,  # 55 dropped
    "pipeline.writeback_ms_per_step": 6.0 * 19 / KEPT,  # 57 dropped
    "pipeline.h2d_mb_per_step": (STEPS * BATCH_B + 20 * REFILL_B) / 1e6 / STEPS,
    "refill.h2d_padding_share": 100.0 * PAD_B / REFILL_B,
}
LAYERS = {"pipeline.batch_wait_ms_per_step": ("pipeline", "ms", "program_span"),
          "pipeline.window_wait_ms_per_step": ("pipeline", "ms", "program_span"),
          "step.dispatch_ms_per_step": ("step", "ms", "program_span"),
          "step.dispatch_ms_p99": ("step", "ms", "program_span"),
          "probe.ms_per_step": ("probe", "ms", "program_span"),
          "pipeline.prefetch_stats_ms_per_step": ("pipeline", "ms", "program_span"),
          "pipeline.writeback_ms_per_step": ("pipeline", "ms", "program_span"),
          "pipeline.h2d_mb_per_step": ("pipeline", "MB", "program_counter"),
          "refill.h2d_padding_share": ("refill", "%", "program_counter")}


@pytest.mark.parametrize("name", spans.METRICS)
def test_each_reader_reads_its_spans_without_the_profiled_steps(name):
    mod = harness.load_metric(name)
    assert mod.NAME == name and mod.MOVES == "train_examples_per_s"
    assert (mod.LAYER, mod.UNIT, mod.SOURCE) == LAYERS[name]
    assert list(mod.CELLS) == ["criteo1tb.flat"]
    assert mod.read(_record()) == pytest.approx(WANT[name], rel=1e-12)
    # a run that recorded nothing (run.py's, or the parent's) reads nothing
    assert mod.read(_record(with_spans=False)) is None


def test_the_span_metrics_cover_the_spans_that_the_readers_name():
    assert set(spans.METRICS) == set(WANT) == set(LAYERS)


def test_idle_gaps_take_the_train_threads_span_through_the_anchor():
    """A device-only stretch whose two idle gaps fall in a step's dispatch
    and in a wait for the batch, on a profiler clock 5 s ahead of the
    tracer's; the anchor is read from the host-labelled stretch."""
    rec = _record()
    ahead_ns = 5_000_000_000
    rec.anchors = [Anchor(1_000, 1_010, 7, 0), Anchor(2_000, 2_010, 9, 0)]
    rec.labels_trace = ([{"name": ANCHOR, "ph": "X", "cat": "user_annotation", "tid": 7,
                          "ts": (1_000 + ahead_ns) / 1e3, "dur": 0.010}], 0)
    t = 10 * SLOT_MS * MS + ahead_ns  # step 10 on the profiler's clock

    def kernel(a_ms, b_ms):
        return {"ph": "X", "cat": "kernel", "name": "k", "ts": (t + a_ms * MS) / 1e3,
                "dur": (b_ms - a_ms) * MS / 1e3}

    # gaps: 0.4-0.6 ms (in train.step, which covers 0-9), 1.2-1.8 (in the
    # wait for the batch, the innermost there)
    rec.stretch_trace = ([kernel(0.1, 0.4), kernel(0.6, 1.2), kernel(1.8, 2.0)], 0)
    rec.trace = {"window_s": 0.0021, "busy_s": 0.0013}
    got = spans.idle_by_span(rec)
    assert got["by_span_s"] == pytest.approx({"train.step": 0.0002, "train.wait_batch": 0.0006})
    assert got["idle_s"] == pytest.approx(0.0008)


def test_the_longest_steps_name_what_other_threads_were_doing():
    rec = _record()
    t = 101 * SLOT_MS * MS  # a window's stats pass over all of step 101
    rec.spans.append(Span("prefetch.stats", "lookahead-prefetcher", t, t + SLOT_MS * MS, None, 99,
                          10**7, -1, 2))
    got = spans.longest_steps(rec, k=5)
    assert [e["step"] for e in got["train.step"]] == list(SLOW)  # the profiled ones dropped
    assert all(e["ms"] == 25.0 and e["cpu_ms"] == 4.0 for e in got["train.step"])
    assert got["train.step"][1]["others"] == [
        {"thread": "lookahead-prefetcher", "span": "prefetch.stats", "step": None, "window": 99,
         "ms": 30.0, "cpu_ms": None}]
    assert got["train.step"][0]["others"] == []


def test_the_command_adds_the_span_metrics_to_a_traced_cpu_run():
    cell = tiny.cell("cached", "train")
    out = spans.run_cell(cell, 2**31 + 29, 1.0, True, torch.device("cpu"))
    assert out["correct"] is True and list(out)[-1] == "check"
    for name in ("pipeline.batch_wait_ms_per_step", "step.dispatch_ms_per_step",
                 "probe.ms_per_step", "pipeline.h2d_mb_per_step", "refill.h2d_padding_share"):
        assert name in out["metrics"], name
    info = out["info"]
    assert info["spans"]["steps"] > 0
    n, ms, cpu_ms = info["spans"]["by_name"]["train.step"]
    assert n == info["spans"]["steps"] and 0 < cpu_ms <= 1.05 * ms + 1.0
    assert info["counters"]["h2d_bytes.batch"] > 0
    assert info["cpu_cores"] > 0
    assert set(info["longest_steps"]) == {"train.step", "train.wait_batch"}
    # nothing stays patched, and the tracer is off again
    from cdlrm_tpu_torch.utils import profiling

    assert harness.Record.__module__ == "perfbench.harness" and not profiling.tracing()


def test_the_clock_check_sets_each_step_beside_its_annotation():
    """The host-labelled stretch's annotations of steps 50-59, each 5 us
    inside its step's span, on a profiler clock 5 s ahead; the device lane's
    copies of them do not count, nor do the stretch's first and last."""
    rec = _record()
    ahead_ns = 5_000_000_000
    rec.anchors = [Anchor(1_000, 1_010, 7, 0)]
    events = [{"name": ANCHOR, "ph": "X", "cat": "user_annotation", "tid": 7,
               "ts": (1_000 + ahead_ns) / 1e3, "dur": 0.010}]
    rec.profiled = [_stretch_ns(10, 20), _stretch_ns(*PROFILED)]
    rec.labels_ns = _stretch_ns(*PROFILED)
    for i in range(*PROFILED):
        t = i * SLOT_MS * MS + ahead_ns
        for cat in ("user_annotation", "gpu_user_annotation"):
            events.append({"name": "perfbench: train step call", "ph": "X", "cat": cat,
                           "ts": (t + 5_000) / 1e3, "dur": (28 * MS - 10_000) / 1e3})
    rec.labels_trace = (events, 0)
    got = spans.clock(rec)
    assert got["steps"] == 8 and got["per_step"] == [[5.0, 5.0]] * 8
    assert got["start_us"] == pytest.approx([5.0] * 3) and got["end_us"] == pytest.approx([5.0] * 3)
    assert got["within_50us"] == [8, 8] and got["anchor_us"] == pytest.approx([0.010, 0.010])


def test_cpu_cores_are_the_process_cpu_over_the_window():
    rec = _record()
    assert spans.cpu_cores(rec) is None  # a run without the readings
    rec.cpu = [(10**9, 5 * 10**9), (3 * 10**9, 8 * 10**9)]
    assert spans.cpu_cores(rec) == pytest.approx(1.5)
