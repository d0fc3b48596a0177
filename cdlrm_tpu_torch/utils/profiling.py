"""Tracing and timing utilities, the counterpart of
cdlrm_tpu/utils/profiling.py.

- :func:`device_time`: wall clock after the device has finished what was
  enqueued for the given tensors (``torch.cuda.synchronize`` + ``time.time()``).
- :func:`profile_trace`: a context manager around ``torch.profiler`` that
  writes a Chrome trace (``chrome://tracing``, Perfetto) into a directory:
  the ``--enable-profiling`` / ``--profile-dir`` flags of the CLI.
- :class:`StepTimer`: windowed ms/it accounting.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

# the trace file profile_trace writes into its directory
TRACE_FILE = "trace.json"


def device_time(*tensors) -> float:
    """Wall clock after every CUDA device that holds one of ``tensors`` has
    finished its queued work (a CPU tensor has nothing to wait for)."""
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return time.time()


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str], device=None):
    """torch.profiler scope; a no-op when ``trace_dir`` is falsy.

    Records the host's operators on every thread and, when ``device`` is a
    CUDA device (by default: when one is present), the kernels they launch (the hand-written kernels of
    csrc/row_ops.cu appear under their own names), and on exit writes
    ``trace_dir/trace.json``. The trace holds every step of the scope: keep
    the scope short (``--num-batches``), a trace of thousands of steps is
    large and slow to export."""
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
    prof.start()
    try:
        yield
    finally:
        if on_cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


class StepTimer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    @property
    def ms_per_iter(self) -> float:
        dt = time.perf_counter() - self._t0
        return 1000.0 * dt / max(1, self.steps)
