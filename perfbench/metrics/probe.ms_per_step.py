"""probe.ms_per_step: milliseconds of host probe a trained step.

The assembly thread's ``pipeline.probe`` spans (``_probe`` of each batch
against the occupancy, its misses' rows gathered) over the window's steps.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "probe.ms_per_step"
LAYER = "probe"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.ms_per_step(rec, "pipeline.probe")
