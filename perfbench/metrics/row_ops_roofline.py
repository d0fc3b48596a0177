"""row_ops_roofline: the row kernels' share of their roofline.

The least time of the stretch's embedding-row traffic (counts.py: each
distinct row read once and each lookup's row written once in the forward,
each lookup's gradient read and each distinct row read and written once in
the update, each refilled or evicted row read and written once; from the
window's ids and the cell's shapes, whatever kernels run it) at 3.35 TB/s,
over the device time that torch.profiler gives the program's row kernels
(csrc/row_ops.cu: gather_rows, scatter_set_rows, scatter_add_rows,
index_add_rows) in the same stretch."""

from perfbench import counts

NAME = "row_ops_roofline"
LAYER = "kernels"
UNIT = "%"
MOVES = "train_examples_per_s"
SOURCE = "device_trace"
CELLS = ("criteo1tb.flat",)


def read(rec):
    if rec.entry != "train" or rec.trace is None or rec.stretch_row_bytes <= 0:
        return None
    kernel_s = rec.trace["row_kernel_s"]
    if kernel_s <= 0:
        return None
    return 100.0 * (rec.stretch_row_bytes / counts.PEAK_BYTES_PER_S) / kernel_s
