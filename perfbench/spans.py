#!/usr/bin/env python3
"""The program's spans and counters in a run of a training cell
(cdlrm_tpu_torch/utils/profiling.py): what the span and counter metrics
read, the traced run's two info outputs, and a command that runs a cell
with the program's tracer on.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs the cell as run.py does (same arguments, same line), with the
program's spans on from the window's start to its end, and adds to the
line's ``metrics`` every reader below that finds something to read and to
its ``info`` the span summary (``spans``), the counters, the cores the
process kept busy over the window (``cpu_cores``) and, with ``--trace 1``,
``idle_by_span``, ``longest_steps`` and ``clock``. run.py itself never
turns the tracer on.

What a reader reads, on a run's ``Record``: ``spans`` (the recorded spans,
``profiling.Span``), ``counters`` (the tracer's counters over the window),
``anchors`` (its clock anchors), ``profiled`` (each profiled stretch's
(start, end) on the tracer's clock, taken where the stretch starts the
profiler and where its stop has exported the trace), ``labels_ns`` (the
host-labelled stretch's) and, of a traced run, ``stretch_trace`` and
``labels_trace`` (each ``(traceEvents, baseTimeNanoseconds)`` of the
device-only and the host-labelled stretch). A record without them reads
None.

Every span metric leaves out the steps of the profiled stretches and one
step on each side: those steps run under torch.profiler, and the stretch's
own stop and export fall inside them. The window's other spans count,
on every thread, where their middle lies outside those steps.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_STEP = "train.step"
# the metrics that read the program's spans and counters (metrics/<name>.py)
METRICS = (
    "pipeline.batch_wait_ms_per_step", "pipeline.window_wait_ms_per_step",
    "step.dispatch_ms_per_step", "step.dispatch_ms_p99", "probe.ms_per_step",
    "pipeline.prefetch_stats_ms_per_step", "pipeline.writeback_ms_per_step",
    "pipeline.h2d_mb_per_step", "refill.h2d_padding_share",
)
LONGEST = 20


def _spans(rec) -> Optional[list]:
    if getattr(rec, "entry", None) != "train" or getattr(rec, "kind", None) != "cached":
        return None
    return getattr(rec, "spans", None) or None


def _steps_in(rec, a: int, b: int) -> Tuple[list, int, int]:
    """The ``train.step`` spans by start, and the [first, end) of those that
    overlap the tracer-clock interval (a, b)."""
    steps = sorted((s for s in rec.spans if s.name == TRAIN_STEP), key=lambda s: s.start_ns)
    ends = [s.end_ns for s in steps]
    starts = [s.start_ns for s in steps]
    return steps, bisect.bisect_left(ends, a), bisect.bisect_right(starts, b)


def dropped(rec) -> List[Tuple[int, int]]:
    """Tracer-clock intervals of the profiled stretches' steps, one step on
    each side included: from the start of the ``train.step`` span before
    the step that started a stretch to the end of the one after the step
    that stopped it."""
    out = []
    for a, b in getattr(rec, "profiled", None) or ():
        steps, lo, hi = _steps_in(rec, a, b)
        inside = steps[max(0, lo - 1):hi + 1]
        out.append((min([a] + [s.start_ns for s in inside]),
                    max([b] + [s.end_ns for s in inside])))
    return out


def kept(rec) -> Tuple[list, int]:
    """The window's spans outside the dropped steps, and how many trained
    steps that leaves (``train.step`` spans kept)."""
    cut = dropped(rec)
    out = [s for s in rec.spans
           if not any(a <= (s.start_ns + s.end_ns) // 2 <= b for a, b in cut)]
    return out, sum(s.name == TRAIN_STEP for s in out)


def ms_per_step(rec, name: str) -> Optional[float]:
    """Milliseconds of span ``name`` a trained step: the kept spans' sum
    over the kept steps."""
    if _spans(rec) is None:
        return None
    spans, steps = kept(rec)
    if steps <= 0:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans if s.name == name) / steps


def p99_ms(rec, name: str) -> Optional[float]:
    """The 99th percentile of span ``name``'s milliseconds over the kept
    spans (the linear interpolation of ``statistics.quantiles``)."""
    if _spans(rec) is None:
        return None
    spans, _ = kept(rec)
    ms = [1e-6 * (s.end_ns - s.start_ns) for s in spans if s.name == name]
    if len(ms) < 100:
        return None
    return statistics.quantiles(ms, n=100)[98]


def h2d_mb_per_step(rec) -> Optional[float]:
    """MB (1e6 bytes) a trained step copied to the device for the batches
    and the refills, over the whole window (counted where the copy is
    made: the assembly thread runs a few batches and the stager one window
    ahead of the steps)."""
    c = getattr(rec, "counters", None)
    if not c or rec.window_steps <= 0 or rec.kind != "cached" or rec.entry != "train":
        return None
    n = c.get("h2d_bytes.batch", 0) + c.get("h2d_bytes.refill", 0)
    return 1e-6 * n / rec.window_steps if n > 0 else None


def padding_share(rec) -> Optional[float]:
    """Percent of the refill's device-bound bytes that are padding."""
    c = getattr(rec, "counters", None)
    if not c or c.get("h2d_bytes.refill", 0) <= 0:
        return None
    return 100.0 * c.get("h2d_pad_bytes.refill", 0) / c["h2d_bytes.refill"]


# ---------------------------------------------------------------- the clock


def _stretch_offset(rec) -> Optional[int]:
    """Tracer clock to the host-labelled stretch's trace clock, in ns (its
    ``baseTimeNanoseconds`` included)."""
    from cdlrm_tpu_torch.utils import profiling

    lab = getattr(rec, "labels_trace", None)
    if lab is None:
        return None
    events, base = lab
    return profiling.anchor_offset_ns(events, getattr(rec, "anchors", []), base)


def _device_gaps(events: list) -> List[Tuple[float, float]]:
    """Idle gaps (start, end; trace microseconds) between the device's
    operations in a stretch (trace.py's busy intervals)."""
    from perfbench.trace import DEVICE_CATS, _intervals, _union

    busy = _union(_intervals(events, DEVICE_CATS))
    return [(end, start) for (_, end), (start, _) in zip(busy[:-1], busy[1:]) if start > end]


def _innermost(spans: list, t_ns: int) -> Optional[object]:
    """The shortest of ``spans`` that covers ``t_ns``."""
    best = None
    for s in spans:
        if s.start_ns <= t_ns <= s.end_ns and (best is None or
                                               s.end_ns - s.start_ns < best.end_ns - best.start_ns):
            best = s
    return best


def _innermost_sorted(spans: list, starts: list, t_ns: int, back: int = 64) -> Optional[object]:
    """:func:`_innermost` over one thread's spans sorted by start
    (``starts``): spans of one thread nest, so the covering span that
    started last is the innermost; a step opens a few spans on the train
    thread, so ``back`` spans before ``t_ns`` are enough to look at."""
    i = bisect.bisect_right(starts, t_ns)
    for s in reversed(spans[max(0, i - back):i]):
        if s.end_ns >= t_ns:
            return s
    return None


def _train_thread(spans: list) -> Optional[str]:
    for s in spans:
        if s.name == TRAIN_STEP:
            return s.thread
    return None


def idle_by_span(rec) -> Optional[dict]:
    """The device-only stretch's idle seconds between device operations,
    each gap by the train thread's innermost program span at its middle
    (``no span`` where none is open), mapped through the clock anchor of
    the host-labelled stretch: both exports of one process share the
    profiler's time base, each with its own ``baseTimeNanoseconds``.
    ``idle_s``: the gaps' sum; ``stretch_idle_s``: the stretch's wall time
    less its busy time, for comparison."""
    spans = _spans(rec)
    st = getattr(rec, "stretch_trace", None)
    offset = _stretch_offset(rec)
    if spans is None or st is None or offset is None:
        return None
    events, base = st
    thread = _train_thread(spans)
    train = sorted((s for s in spans if s.thread == thread), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in train]
    out: Dict[str, float] = {}
    for a, b in _device_gaps(events):
        mid = int(round(1e3 * 0.5 * (a + b))) + base - offset
        s = _innermost_sorted(train, starts, mid)
        label = "no span" if s is None else s.name
        out[label] = out.get(label, 0.0) + 1e-6 * (b - a)
    res = {k: out[k] for k in sorted(out, key=lambda k: -out[k])}
    trace = getattr(rec, "trace", None) or {}
    return {"by_span_s": res, "idle_s": sum(out.values()),
            "stretch_idle_s": (trace.get("window_s") or 0.0) - trace.get("busy_s", 0.0)}


def _cpu_ms(s) -> Optional[float]:
    """The span's CPU time on its thread, in ms (None: not taken)."""
    return round(1e-6 * s.cpu_ns, 3) if s.cpu_ns >= 0 else None


def _around(spans: list, s, t_ns: int) -> list:
    """The innermost span open at ``t_ns`` on each thread other than ``s``'s."""
    by_thread: Dict[str, list] = {}
    for x in spans:
        if x.thread != s.thread and x.start_ns <= t_ns <= x.end_ns:
            by_thread.setdefault(x.thread, []).append(x)
    out = []
    for thread in sorted(by_thread):
        x = _innermost(by_thread[thread], t_ns)
        out.append({"thread": thread, "span": x.name, "step": x.step, "window": x.window,
                    "ms": round(1e-6 * (x.end_ns - x.start_ns), 3), "cpu_ms": _cpu_ms(x)})
    return out


def longest_steps(rec, k: int = LONGEST) -> Optional[dict]:
    """The ``k`` longest kept ``train.step`` and ``train.wait_batch`` spans,
    each with its step, its milliseconds, its thread's CPU milliseconds over
    it and the spans open on the other threads at its middle (with theirs:
    a span's CPU time far below its wall time waited rather than ran)."""
    if _spans(rec) is None:
        return None
    spans, _ = kept(rec)
    out = {}
    for name in (TRAIN_STEP, "train.wait_batch"):
        mine = sorted((s for s in spans if s.name == name),
                      key=lambda s: s.start_ns - s.end_ns)[:k]
        out[name] = [{"step": s.step, "ms": round(1e-6 * (s.end_ns - s.start_ns), 3),
                      "cpu_ms": _cpu_ms(s),
                      "others": _around(spans, s, (s.start_ns + s.end_ns) // 2)} for s in mine]
    return out


def clock(rec) -> Optional[dict]:
    """How well the anchor maps the tracer's clock: each ``train.step`` span
    of the host-labelled stretch against the harness's annotation of the
    same step call ("perfbench: train step call", in step order; the
    stretch's first and last steps, which start and stop the profiler, left
    out). ``per_step``: how far each span starts before its annotation and
    ends after it, in microseconds (positive: the span covers it; the span
    also holds the harness's own work around the call); ``start_us`` and
    ``end_us``: their least, median and largest; ``within_50us``: the steps
    whose start and whose end lie 0-50 us out; ``anchor_us``: the tracer's
    time across the anchor annotation and the profiler's duration of it
    (half their difference bounds the mapping's error)."""
    spans = _spans(rec)
    lab = getattr(rec, "labels_trace", None)
    offset = _stretch_offset(rec)
    at = getattr(rec, "labels_ns", None)
    if spans is None or lab is None or offset is None or at is None:
        return None
    events, base = lab
    # the host's annotations (a traced device lane repeats them as
    # ``gpu_user_annotation``)
    host = [e for e in events if e.get("cat") == "user_annotation"]
    notes = sorted((e for e in host if e.get("name") == "perfbench: train step call"),
                   key=lambda e: float(e["ts"]))
    steps, lo, hi = _steps_in(rec, *at)
    pairs = list(zip(steps[lo:hi], notes))[1:-1]
    per_step = []
    for s, e in pairs:
        a = 1e3 * float(e["ts"]) + base - offset
        b = a + 1e3 * float(e["dur"])
        per_step.append([round(1e-3 * (a - s.start_ns), 1), round(1e-3 * (s.end_ns - b), 1)])
    if not per_step:
        return None
    starts, ends = [p[0] for p in per_step], [p[1] for p in per_step]
    out = {"steps": len(per_step),
           "start_us": [min(starts), statistics.median(starts), max(starts)],
           "end_us": [min(ends), statistics.median(ends), max(ends)],
           "within_50us": [sum(0 <= x <= 50 for x in starts), sum(0 <= x <= 50 for x in ends)],
           "per_step": per_step}
    from cdlrm_tpu_torch.utils.profiling import ANCHOR

    marks = [e for e in host if e.get("name") == ANCHOR]
    if marks:
        e = max(marks, key=lambda e: float(e["ts"]))
        mid = 1e3 * float(e["ts"]) + base
        mine = [a for a in getattr(rec, "anchors", []) if a.tid == int(e["tid"])]
        if mine:
            a = min(mine, key=lambda a: abs(a.wall_ns - mid))
            out["anchor_us"] = [1e-3 * (a.after_ns - a.before_ns), float(e.get("dur", 0.0))]
    return out


def summary(rec) -> Optional[dict]:
    """Per span name: the kept spans' count, and their milliseconds and
    their threads' CPU milliseconds a kept step."""
    if _spans(rec) is None:
        return None
    spans, steps = kept(rec)
    out: Dict[str, list] = {}
    for s in spans:
        e = out.setdefault(s.name, [0, 0.0, 0.0])
        e[0] += 1
        e[1] += 1e-6 * (s.end_ns - s.start_ns)
        e[2] += 1e-6 * max(s.cpu_ns, 0)
    per = max(1, steps)
    return {"steps": steps,
            "by_name": {k: [n, ms / per, cpu / per] for k, (n, ms, cpu) in sorted(out.items())}}


def cpu_cores(rec) -> Optional[float]:
    """The process's CPU seconds (all its threads, ``time.process_time``) a
    second of the window: how many of the host's cores it kept busy.
    ``rec.cpu``: (tracer clock, process CPU ns) at the window's start and
    end; the profiled stretches are not left out."""
    c = getattr(rec, "cpu", None)
    if not c or len(c) < 2 or c[1][0] <= c[0][0]:
        return None
    return (c[1][1] - c[0][1]) / (c[1][0] - c[0][0])


# ------------------------------------------------------------ the command


def _install(state: dict):
    """Patch, in this process only, the harness and the trainer so that the
    program's tracer runs over the window and what it recorded reaches the
    run's Record; returns a function that undoes the patches.

    Scaffolding, to be deleted with ``run_cell`` and ``main`` by the
    benchmark change that makes perfbench/harness.py turn the tracer on
    itself (PERF.md section 7 lists the edit); the readers above stay."""
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
    from cdlrm_tpu_torch.utils import profiling
    from perfbench import harness

    saved = [(harness.Probe, "_begin_window", harness.Probe._begin_window),
             (CachedDlrmTrainer, "close", CachedDlrmTrainer.close),
             (harness, "Record", harness.Record), (harness, "Stretch", harness.Stretch)]
    begin, close = harness.Probe._begin_window, CachedDlrmTrainer.close

    def begin_window(self):
        begin(self)
        profiling.start()
        state["cpu"] = [(time.perf_counter_ns(), time.process_time_ns())]

    def close_first(self):
        if profiling.tracing():
            state["cpu"].append((time.perf_counter_ns(), time.process_time_ns()))
            state["spans"], state["counters"], state["anchors"] = profiling.stop()
        close(self)

    class Record(harness.Record):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            state["rec"] = self

    class Stretch(harness.Stretch):
        """Keeps its trace's ``baseTimeNanoseconds``, which the harness's
        drops, and the tracer's clock where it starts and where its stop
        has exported the trace."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.base_ns = 0
            self.span_ns = None
            state.setdefault("stretches", []).append(self)

        def start(self):
            t = time.perf_counter_ns()
            super().start()
            self.span_ns = (t, None)

        def stop(self):
            prof = self.prof
            if prof is None or self.wall_s is not None:
                return
            export = prof.export_chrome_trace

            def keep(path):
                export(path)
                with open(path) as f:
                    self.base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))

            prof.export_chrome_trace = keep
            super().stop()
            self.span_ns = (self.span_ns[0], time.perf_counter_ns())

    harness.Probe._begin_window = begin_window
    CachedDlrmTrainer.close = close_first
    harness.Record, harness.Stretch = Record, Stretch

    def undo():
        for obj, name, value in saved:
            setattr(obj, name, value)

    return undo


def run_cell(cell, seed: int, seconds: float, trace: bool, device, run=None) -> dict:
    """harness.run_cell with the program's tracer on over the window, and
    the span metrics and info added to its line."""
    from perfbench import harness

    run = run or harness.run_cell
    state: dict = {}
    undo = _install(state)
    try:
        out = run(cell, seed, seconds, trace, device)
    finally:
        undo()
    rec = state.get("rec")
    if rec is None or "spans" not in state:
        return out
    rec.spans, rec.counters, rec.anchors = state["spans"], state["counters"], state["anchors"]
    rec.cpu = state["cpu"]
    if trace and cell.traffic.get("entry") == "train":
        done = [st for st in state.get("stretches", []) if st.done]
        rec.profiled = [st.span_ns for st in done]
        for st in done:
            if st.host:
                rec.labels_trace, rec.labels_ns = (st.events, st.base_ns), st.span_ns
            else:
                rec.stretch_trace = (st.events, st.base_ns)
    for name in METRICS:
        m = harness.load_metric(name)
        value = m.read(rec)
        if value is not None:
            out["metrics"][name] = {"value": float(value), "unit": m.UNIT}
    info = out.setdefault("info", {})
    info["spans"] = summary(rec)
    info["counters"] = dict(rec.counters)
    info["cpu_cores"] = cpu_cores(rec)
    if trace:
        info["idle_by_span"] = idle_by_span(rec)
        info["longest_steps"] = longest_steps(rec)
        info["clock"] = clock(rec)
    # the check stays the line's last key
    out["check"] = out.pop("check")
    return out


def main(argv=None) -> int:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench import harness, run

    real = harness.run_cell

    def traced(cell, seed, seconds, trace, device):
        return run_cell(cell, seed, seconds, trace, device, run=real)

    harness.run_cell = traced
    try:
        return run.main(argv)
    finally:
        harness.run_cell = real


if __name__ == "__main__":
    sys.exit(main())
