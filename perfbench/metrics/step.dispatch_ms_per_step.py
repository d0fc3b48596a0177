"""step.dispatch_ms_per_step: milliseconds of host dispatch a trained step.

The train thread's ``train.step`` spans (the call of the step in
``run_step``, train/trainer.py: the step's Python and its launches, no
loop bookkeeping) over the window's steps.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "step.dispatch_ms_per_step"
LAYER = "step"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.ms_per_step(rec, "train.step")
