"""The traced stretch: torch.profiler over a run of steps chosen by the
harness, read from the profiler's chrome trace.

- ``busy_s``: the union of the intervals in which a kernel, a copy or a
  memset ran on the device;
- kernel time by name, and the row kernels' time (names of the program's
  hand-written row kernels);
- the breakdown: the device operations that took most time, and the
  longest idle gaps by the host annotation or operator that covered them.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ROW_KERNELS = ("gather_rows", "scatter_set_rows", "scatter_add_rows", "index_add_rows")
HOST_CATS = ("user_annotation", "cpu_op", "python_function")


class Stretch:
    """Profile from :meth:`start` to :meth:`stop`; both synchronize the
    device first, so the stretch holds exactly the work called between
    them."""

    def __init__(self, device, host: bool = False):
        """``host``: trace the host's operators too (they cost time)."""
        self.device, self.host = device, host
        self.prof = None
        self.wall_s: Optional[float] = None
        self.events: Optional[list] = None
        self._t0 = 0.0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = []
        if self.host or self.device.type != "cuda":
            acts.append(ProfilerActivity.CPU)
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts, record_shapes=False, with_stack=False)

    def warm(self):
        """Start and stop the profiler once, so that the device tracer's
        set-up is paid before the measured run."""
        prof = self._profiler()
        prof.start()
        self._sync()
        prof.stop()

    def start(self):
        self._sync()
        self.prof = self._profiler()
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        if self.prof is None or self.wall_s is not None:
            return
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        self.prof = None

    @property
    def done(self) -> bool:
        return self.events is not None


def _intervals(events, cats) -> List[tuple]:
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in cats and "dur" in e:
            out.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", "")))
    out.sort()
    return out


def _union(iv: List[tuple]) -> List[tuple]:
    merged: List[list] = []
    for a, b, _ in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(st: Stretch) -> Dict[str, float]:
    """Idle seconds between device operations, by the innermost host
    operator or annotation that covers each gap's middle."""
    busy = _union(_intervals(st.events, DEVICE_CATS))
    host = _intervals(st.events, HOST_CATS)
    gaps: Dict[str, float] = defaultdict(float)
    active: List[tuple] = []
    nxt = 0
    for (_, end), (start, _) in zip(busy[:-1], busy[1:]):
        if start <= end:
            continue
        mid = 0.5 * (start + end)
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        label = "host: no traced operation"
        if active:
            label = min(active, key=lambda h: h[1] - h[0])[2]
        gaps[label] += (start - end) * 1e-6
    return gaps


def summarize(st: Stretch, labels: Optional[Stretch] = None) -> Dict:
    """busy and wall seconds of the stretch, seconds by kernel name, the row
    kernels' seconds, and the breakdown (its idle gaps from ``labels``, a
    stretch traced with the host's operators)."""
    dev = _intervals(st.events, DEVICE_CATS)
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    row_s = sum(s for name, s in by_name.items() if any(k in name for k in ROW_KERNELS))
    gaps = idle_gaps(labels if labels is not None else st)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_s,
        "window_s": st.wall_s,
        "by_name": dict(by_name),
        "row_kernel_s": row_s,
        "breakdown": {"device_ops": [[k, v] for k, v in top_ops],
                      "idle_gaps": [[k, v] for k, v in top_gaps]},
    }
