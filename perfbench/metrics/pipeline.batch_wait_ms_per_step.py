"""pipeline.batch_wait_ms_per_step: milliseconds a trained step waits for its batch.

The train thread's ``train.wait_batch`` spans (the loop's
``AssemblyPipeline.get``, train/trainer.py) over the window's steps: the
time the step loop starves on the assembly pipeline (probe and staging of
the batches ahead).

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "pipeline.batch_wait_ms_per_step"
LAYER = "pipeline"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_span"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.ms_per_step(rec, "train.wait_batch")
