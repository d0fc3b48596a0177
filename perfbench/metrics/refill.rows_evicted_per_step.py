"""refill.rows_evicted_per_step: cache rows that the window's refills
evict, over the window's steps (each refill plan's eviction count, as the
program's planner gives it to ``_apply_refill``). The rows the eviction
writeback carries to the masters a step. Cached trainer only."""

NAME = "refill.rows_evicted_per_step"
LAYER = "refill"
UNIT = "rows"
MOVES = "train_examples_per_s"
SOURCE = "program_counter"
CELLS = ("criteo1tb.flat",)


def read(rec):
    if rec.kind != "cached" or rec.entry != "train" or rec.window_steps <= 0:
        return None
    return sum(ev for _, ev in rec.refills) / rec.window_steps
