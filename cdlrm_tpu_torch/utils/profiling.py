"""Tracing: the program's spans and counters, and the torch.profiler scope
of the CLI.

- :func:`span`: a named interval on the calling thread, with the ids that
  join it to work on other threads (``step``: the global step on the train
  thread, the batch's data cursor on the assembly thread; ``window``: the
  lookahead window's index). Off by default: it then returns one shared
  object that does nothing. :func:`start` turns spans on, :func:`stop`
  turns them off and returns what was recorded. A span also takes the
  thread's CPU time over its body (``time.thread_time_ns``): a span whose
  CPU time lies far below its wall time waited (on a lock, the GIL, the
  scheduler or a driver call) rather than ran.
- :func:`count`: named counters (bytes copied to the device, kernel
  launches), always on and never reset: :func:`counters` reads their totals
  since the process began, :func:`stop` what they added since
  :func:`start`.
- Clock anchor: spans are timed with ``time.perf_counter_ns``. When a span
  opens on a thread while a torch.profiler session runs, the tracer opens
  one ``record_function("cdlrm.clock_anchor")`` on that thread (once a
  session and thread) and keeps its own clock on both sides of it; the
  profiler's timestamp of that annotation maps the tracer's clock onto the
  profiler's (:func:`anchor_offset_ns`). The profiler records annotations
  of the thread that started it only, so only that thread's anchor shows in
  its trace.
- :func:`profile_trace`: a torch.profiler scope that writes a Chrome trace
  (``chrome://tracing``, Perfetto) into a directory, with the program's
  spans on their own lane for each thread and the counters that moved as
  counter tracks, on the profiler's clock: the ``--enable-profiling`` /
  ``--profile-dir`` flags of the CLI.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

# the trace file profile_trace writes into its directory
TRACE_FILE = "trace.json"
ANCHOR = "cdlrm.clock_anchor"
# the process under which a trace shows the program's spans
SPAN_PID = "cdlrm_tpu_torch spans"


class Span(NamedTuple):
    """One recorded span; ``parent`` is the ``id`` of the span that was open
    on the same thread when it opened (-1: none)."""

    name: str
    thread: str
    start_ns: int
    end_ns: int
    step: Optional[int]
    window: Optional[int]
    id: int
    parent: int
    tid: int  # the thread's native id, as the profiler's trace names it
    cpu_ns: int = -1  # the thread's CPU time over the span (-1: not taken)


class Anchor(NamedTuple):
    """The tracer's clock just before and just after one clock-anchor
    annotation on the thread ``tid``, and the wall clock (``time.time_ns``)
    after it, which tells one session's anchor from another's."""

    before_ns: int
    after_ns: int
    tid: int
    wall_ns: int


class _Thread:
    """One thread's spans of one generation (since the last :func:`start`),
    as plain tuples of :class:`Span`'s fields, and its stack of open spans,
    which outlives generations: each thread appends only to its own, so
    spans take no lock."""

    __slots__ = ("gen", "name", "tid", "spans", "stack")

    def __init__(self, gen: int, stack: list):
        cur = threading.current_thread()
        self.gen, self.name, self.tid = gen, cur.name, threading.get_native_id()
        self.spans: List[tuple] = []
        self.stack = stack


class _Tracer:
    def __init__(self):
        self.on = False
        self.gen = 0
        self.threads: List[_Thread] = []
        # each thread's counters, kept for the process's life (a thread adds
        # only to its own)
        self.counts: List[Dict[str, int]] = []
        self.base: Dict[str, int] = {}  # the counters' totals at start()
        self.anchors: List[Anchor] = []
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        # the profiler session an anchor was taken in, by thread (see _anchor)
        self.anchored: Dict[int, int] = {}
        self.session = 0
        self.seen_profiler = False

    def slot(self) -> _Thread:
        th = getattr(self.local, "slot", None)
        if th is None or th.gen != self.gen:
            with self.lock:
                th = _Thread(self.gen, [] if th is None else th.stack)
                self.threads.append(th)
            self.local.slot = th
        return th

    def counts_of_thread(self) -> Dict[str, int]:
        c = getattr(self.local, "counts", None)
        if c is None:
            c = self.local.counts = {}
            with self.lock:
                self.counts.append(c)
        return c


_T = _Tracer()
_PROFILER = torch.autograd.profiler
_now = time.perf_counter_ns
_cpu = time.thread_time_ns


class _Off:
    """What :func:`span` returns while spans are off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "step", "window", "id", "parent", "start_ns", "cpu_ns", "slot")

    def __init__(self, name: str, step, window):
        self.name, self.step, self.window = name, step, window

    def __enter__(self):
        if _PROFILER._is_profiler_enabled or _T.seen_profiler:
            _anchor()
        slot = self.slot = _T.slot()
        stack = slot.stack
        if stack:
            parent = stack[-1]
            # a child joins its parent's work: it takes the ids it was not given
            if self.step is None:
                self.step = parent.step
            if self.window is None:
                self.window = parent.window
            self.parent = parent.id
        else:
            self.parent = -1
        self.id = next(_T.ids)
        stack.append(self)
        self.cpu_ns = _cpu()
        self.start_ns = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        cpu = _cpu() - self.cpu_ns
        s = self.slot
        s.stack.pop()
        s.spans.append((self.name, s.name, self.start_ns, end, self.step, self.window,
                        self.id, self.parent, s.tid, cpu))
        return False


def span(name: str, step: Optional[int] = None, window: Optional[int] = None):
    """A context manager that records ``name`` over its body on the calling
    thread while spans are on (:func:`start`); otherwise one shared object
    that does nothing. A span opened inside another on the same thread is
    its child and takes the ids it is not given from it."""
    if not _T.on:
        return _OFF
    return _On(name, step, window)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (always on; per thread, no lock)."""
    c = _T.counts_of_thread()
    c[name] = c.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's total since the process began, summed over the
    threads."""
    with _T.lock:
        dicts = list(_T.counts)
    out: Dict[str, int] = {}
    for d in dicts:
        for k, v in list(d.items()):
            out[k] = out.get(k, 0) + v
    return out


def start() -> None:
    """Drop the spans recorded so far, take the counters' totals as the
    base that :func:`stop` subtracts, and turn spans on."""
    with _T.lock:
        _T.gen += 1
        _T.threads = []
        _T.anchors = []
        _T.anchored = {}
    _T.base = counters()
    _T.on = True


def tracing() -> bool:
    return _T.on


def stop() -> Tuple[List[Span], Dict[str, int], List[Anchor]]:
    """Turn spans off; returns the spans recorded since :func:`start`
    (ordered by start), what each counter added since then (the counters
    that moved) and the clock anchors. A span still open on another thread
    is left out."""
    _T.on = False
    with _T.lock:
        threads = list(_T.threads)
        anchors = list(_T.anchors)
    spans = sorted((Span._make(s) for th in threads for s in list(th.spans)),
                   key=lambda s: s.start_ns)
    base = _T.base
    added = {k: v - base.get(k, 0) for k, v in counters().items() if v != base.get(k, 0)}
    return spans, added, anchors


def _anchor() -> None:
    """Take a clock anchor on this thread if a torch.profiler session runs
    and this thread has none in it yet."""
    prof = _PROFILER
    if not prof._is_profiler_enabled:
        if _T.seen_profiler:
            _T.seen_profiler = False
        return
    tid = threading.get_native_id()
    with _T.lock:
        if not _T.seen_profiler:
            # the first span that sees this session: a new session
            _T.seen_profiler = True
            _T.session += 1
        if _T.anchored.get(tid) == _T.session:
            return
        _T.anchored[tid] = _T.session
    with prof.record_function(ANCHOR):  # once first: the call's own set-up is paid
        pass
    before = time.perf_counter_ns()
    with prof.record_function(ANCHOR):
        pass
    after = time.perf_counter_ns()
    with _T.lock:
        _T.anchors.append(Anchor(before, after, tid, time.time_ns()))


def anchor_offset_ns(events: list, anchors: List[Anchor], base_ns: int = 0) -> Optional[int]:
    """Nanoseconds to add to the tracer's clock to reach the profiler's, from
    a chrome trace's ``traceEvents`` (timestamps in microseconds, plus
    ``base_ns``, the trace's ``baseTimeNanoseconds`` where it has one): the
    midpoint of the trace's last anchor annotation against the midpoint of
    the tracer's anchor on the same thread that is nearest to it on the wall
    clock (the profiler's timestamps are the wall clock's). None where the
    trace holds no anchor of the tracer."""
    marks = {}
    for e in events:
        # the host's annotation (a traced device lane repeats it)
        if e.get("name") == ANCHOR and e.get("cat") == "user_annotation":
            tid = int(e["tid"])
            if tid not in marks or float(e["ts"]) > float(marks[tid]["ts"]):
                marks[tid] = e
    for tid, e in marks.items():
        prof_mid = 1e3 * (float(e["ts"]) + 0.5 * float(e.get("dur", 0.0))) + base_ns
        mine = [a for a in anchors if a.tid == tid]
        if mine:
            a = min(mine, key=lambda a: abs(a.wall_ns - prof_mid))
            return int(round(prof_mid - 0.5 * (a.before_ns + a.after_ns)))
    return None


def spans_to_events(spans: List[Span], offset_ns: int, base_ns: int = 0) -> list:
    """The spans as chrome trace events on the profiler's clock: one lane a
    thread, under a process of their own (``SPAN_PID``)."""
    out, lanes = [], set()
    for s in spans:
        if s.tid not in lanes:
            lanes.add(s.tid)
            out.append({"ph": "M", "name": "thread_name", "pid": SPAN_PID, "tid": s.tid,
                        "args": {"name": s.thread}})
        args = {k: v for k, v in (("step", s.step), ("window", s.window)) if v is not None}
        if s.cpu_ns >= 0:
            args["cpu_us"] = s.cpu_ns / 1e3
        out.append({"ph": "X", "cat": "cdlrm_span", "name": s.name, "pid": SPAN_PID,
                    "tid": s.tid, "ts": (s.start_ns + offset_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    return out


def counters_to_events(counts: Dict[str, int], start_ns: int, end_ns: int, offset_ns: int,
                       base_ns: int = 0) -> list:
    """Counters as chrome counter tracks on the profiler's clock, under the
    spans' process: one track a name's first part (``h2d_bytes``,
    ``launches``), one series a counter, at zero at ``start_ns`` and at what
    it added by ``end_ns`` (tracer clock)."""
    tracks: Dict[str, Dict[str, int]] = {}
    for k in sorted(counts):
        head, _, tail = k.partition(".")
        tracks.setdefault(head, {})[tail or head] = counts[k]
    out = []
    for head, series in tracks.items():
        for t, args in ((start_ns, dict.fromkeys(series, 0)), (end_ns, series)):
            out.append({"ph": "C", "name": head, "pid": SPAN_PID,
                        "ts": (t + offset_ns - base_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str], device=None):
    """torch.profiler scope; a no-op when ``trace_dir`` is falsy.

    Records the host's operators on every thread and, when ``device`` is a
    CUDA device (by default: when one is present), the kernels they launch
    (the hand-written kernels of csrc/row_ops.cu appear under their own
    names), with the program's spans on, and on exit writes
    ``trace_dir/trace.json``: the profiler's events, the spans and what the
    counters added over the scope, mapped onto the profiler's clock through
    the clock anchor. The trace holds every step of the scope: keep the
    scope short (``--num-batches``), a trace of thousands of steps is large
    and slow to export."""
    if not trace_dir:
        yield
        return
    os.makedirs(trace_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    on_cuda = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    if on_cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    start()
    prof.start()
    t0 = _now()
    try:
        # this thread started the profiler: its anchor is the one recorded
        with span("profile_trace"):
            yield
    finally:
        if on_cuda:
            torch.cuda.synchronize()
        t1 = _now()
        prof.stop()
        spans, counts, anchors = stop()
        path = os.path.join(trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        base = int(trace.get("baseTimeNanoseconds", 0))
        offset = anchor_offset_ns(trace.get("traceEvents", []), anchors, base)
        if offset is not None:
            trace.setdefault("traceEvents", []).extend(
                spans_to_events(spans, offset, base)
                + counters_to_events(counts, t0, t1, offset, base))
            with open(path, "w") as f:
                json.dump(trace, f)
