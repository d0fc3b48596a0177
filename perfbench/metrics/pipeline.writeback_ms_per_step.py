"""pipeline.writeback_ms_per_step: milliseconds of eviction writeback a trained step.

The eviction thread's ``evict.writeback`` spans (``EvictionManager._apply``,
cache/prefetcher.py: the wait for the evicted rows' copy and the masters'
write) over the window's steps.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "pipeline.writeback_ms_per_step"
LAYER = "pipeline"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.ms_per_step(rec, "evict.writeback")
