"""pipeline.h2d_mb_per_step: MB copied to the device a trained step.

The program's counters ``h2d_bytes.batch`` and ``h2d_bytes.refill``
(``_to_device``, train/trainer.py: the bytes of each host array that
crosses, by call site) over the window, divided by the window's steps.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "pipeline.h2d_mb_per_step"
LAYER = "pipeline"
UNIT = "MB"
MOVES = "train_examples_per_s"
SOURCE = "program_counter"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.h2d_mb_per_step(rec)
