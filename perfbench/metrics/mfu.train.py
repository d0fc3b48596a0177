"""mfu.train: the whole training step's share of the card's peak.

Model FLOPs a trained example (counts.train_flops_per_example: three times
the forward pass's MLP multiply-adds and the dot interaction's needed
pairs, from the configuration's widths) times the examples a second of the
traced run's whole window (its steps times the batch over its wall time, as
``train_examples_per_s`` counts them; the profiled stretches inside it slow
it a little), over the published dense peak of the precision the step's
matrix products run in (float32 without TF32: 67 TFLOP/s; counts.py)."""

from perfbench import counts

NAME = "mfu.train"
LAYER = "step"
UNIT = "%"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"
CELLS = ("criteo1tb.flat",)


def read(rec):
    if rec.entry != "train" or rec.trace is None or rec.window_steps <= 0:
        return None
    cfg = rec.cell.kw
    flops = counts.train_flops_per_example(cfg) * rec.window_steps * rec.batch
    peak = counts.PEAK_FLOPS[counts.matmul_precision(cfg)]
    return 100.0 * flops / rec.window_s / peak
