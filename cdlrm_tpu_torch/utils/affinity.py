"""Thread core pinning — the reference's taskset layout as
`os.sched_setaffinity` (cache_manager.py:20-25,50-52,67-68,
main_no_ddp.py:328-333,632-634, dlrm_data_pytorch.py:341-343), opt-in via
config `pin_cores` + `main_start_core`. Cores wrap modulo the host's CPU
count; non-Linux / restricted environments degrade to a no-op."""

from __future__ import annotations

import os
from typing import Optional


def pin_current_thread(core: int) -> None:
    try:
        os.sched_setaffinity(0, {core % os.cpu_count()})
    except (AttributeError, OSError):  # non-Linux or restricted
        pass


def worker_pin(counter, base: int) -> None:
    """Pin the calling pool worker to base + (its arrival rank) — the
    reference's per-worker layout (cache_manager.py:21-23,79,
    dlrm_data_pytorch.py:341-343). ``counter`` is a multiprocessing.Value
    so the same code serves thread pools (shared in-process) and
    fork-inherited process workers."""
    with counter.get_lock():
        rank = counter.value
        counter.value += 1
    pin_current_thread(base + rank)


def make_pin(base: Optional[int]):
    """Build the (counter, base) pair worker_pin expects, or None when
    pinning is off. The Value is fork-inheritable for process pools."""
    if base is None:
        return None
    import multiprocessing as mp

    return (mp.Value("i", 0), base)
