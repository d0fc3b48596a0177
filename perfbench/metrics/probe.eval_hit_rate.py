"""probe.eval_hit_rate: the share of the window's scoring lookups that the
host probe found in the cache (``TrainMetrics.eval_hits / eval_lookups``).
Cached trainer only."""

NAME = "probe.eval_hit_rate"
LAYER = "probe"
UNIT = "%"
MOVES = "score_examples_per_s"
SOURCE = "program_counter"
CELLS = ("criteo1tb.score",)


def read(rec):
    if rec.kind != "cached" or rec.entry != "score":
        return None
    lookups = rec.end.eval_lookups - rec.start.eval_lookups
    if lookups <= 0:
        return None
    return 100.0 * (rec.end.eval_hits - rec.start.eval_hits) / lookups
