"""pipeline.window_wait_ms_per_step: milliseconds a trained step waits for its window.

The train thread's ``train.wait_window`` spans (the boundary's pop of the
next window from the refill stager or the prefetcher, train/trainer.py)
over the window's steps; ``refill.ms_per_step`` leaves this wait out.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "pipeline.window_wait_ms_per_step"
LAYER = "pipeline"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.ms_per_step(rec, "train.wait_window")
