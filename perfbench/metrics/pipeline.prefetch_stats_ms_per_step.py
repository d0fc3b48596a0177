"""pipeline.prefetch_stats_ms_per_step: milliseconds of the prefetcher's window-stats pass a trained step.

The prefetcher thread's ``prefetch.stats`` spans (``_window_stats``,
cache/prefetcher.py: ``count_probe_stats`` of every batch of the window
on the worker pool) over the window's steps.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "pipeline.prefetch_stats_ms_per_step"
LAYER = "pipeline"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.ms_per_step(rec, "prefetch.stats")
