"""refill.ms_per_step: milliseconds of refill a trained step.

The trainer's own host clock around the refill on the train thread
(``TrainMetrics.caching_overhead_s``, train/trainer.py ``_apply_refill``),
over the window, divided by the window's steps. No print falls inside a
window, so nothing resets the counter there. Cached trainer only."""

NAME = "refill.ms_per_step"
LAYER = "refill"
UNIT = "ms"
MOVES = "train_examples_per_s"
SOURCE = "program_counter"
CELLS = ("criteo1tb.flat",)


def read(rec):
    if rec.kind != "cached" or rec.entry != "train" or rec.window_steps <= 0:
        return None
    return 1e3 * (rec.end.caching_overhead_s - rec.start.caching_overhead_s) / rec.window_steps
