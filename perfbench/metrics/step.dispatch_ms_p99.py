"""step.dispatch_ms_p99: the 99th percentile of a step's host dispatch.

The train thread's ``train.step`` spans over the window's steps (about
1,800 in a 50 s run of flat, so some 18 lie beyond it).

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "step.dispatch_ms_p99"
LAYER = "step"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.p99_ms(rec, "train.step")
