"""refill.h2d_padding_share: the share of the refill's copied bytes that is padding.

The program's counter ``h2d_pad_bytes.refill`` (the rows and slots that
``pad_to_bucket`` adds in ``_refill_device_inputs``) over
``h2d_bytes.refill``, over the window.

The reader finds nothing where the run recorded no spans and counters
(perfbench/spans.py says what it reads)."""

from perfbench import spans

NAME = "refill.h2d_padding_share"
LAYER = "refill"
UNIT = "%"
MOVES = "train_examples_per_s"
SOURCE = "program_counter"
CELLS = ("criteo1tb.flat",)


def read(rec):
    return spans.padding_share(rec)
