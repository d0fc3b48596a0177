"""device.idle_share.train: the share of the training window in which
nothing ran on the device.

The device's busy time a step comes from torch.profiler's trace of a
stretch of the window (the union of the kernel, copy and memset intervals
over the stretch's steps, trace.py); the steps a second come from the whole
window. The profiler slows the host in its stretch, not the device's
operations, so the stretch's own wall time would read the share too high.
Idle = 1 - (busy seconds a step) x (steps a second of the window)."""

NAME = "device.idle_share.train"
LAYER = "device"
UNIT = "%"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"
CELLS = ("criteo1tb.flat",)


def read(rec):
    if (rec.entry != "train" or rec.trace is None or rec.stretch_steps <= 0
            or rec.window_steps <= 0):
        return None
    busy_per_step = rec.trace["busy_s"] / rec.stretch_steps
    return 100.0 * (1.0 - busy_per_step * rec.window_steps / rec.window_s)
