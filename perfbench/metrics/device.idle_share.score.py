"""device.idle_share.score: as device.idle_share.train, over the pipelined
``evaluate``'s window: the device's busy time a scored batch from the
traced stretch, the batches a second from the whole window."""

NAME = "device.idle_share.score"
LAYER = "device"
UNIT = "%"
MOVES = "score_examples_per_s"
SOURCE = "device_trace"
CELLS = ("criteo1tb.score",)


def read(rec):
    if (rec.entry != "score" or rec.trace is None or rec.stretch_steps <= 0
            or rec.window_steps <= 0):
        return None
    busy_per_batch = rec.trace["busy_s"] / rec.stretch_steps
    return 100.0 * (1.0 - busy_per_batch * rec.window_steps / rec.window_s)
