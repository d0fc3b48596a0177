"""The FLOP and byte arithmetic against counts by hand."""

import json
import os

import numpy as np

from perfbench import counts

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)["config"]


def test_criteo1tb_flops_by_hand():
    # bottom 13-512-256-128; 27 features, 351 pairs of dim 128; top
    # 479-512-512-256-1
    bot = 13 * 512 + 512 * 256 + 256 * 128
    inter = 351 * 128
    top = 479 * 512 + 512 * 512 + 512 * 256 + 256 * 1
    assert (bot, inter, top) == (170_496, 44_928, 638_720)
    cfg = config("cdlrm-criteo1tb")
    assert counts.forward_macs(cfg) == 854_144
    assert counts.train_flops_per_example(cfg) == 6 * 854_144 == 5_124_864
    assert counts.matmul_precision(cfg) == "float32"


def test_kaggle_flops_by_hand():
    # bottom 13-512-256-64-16; 351 pairs of dim 16; top 367-512-256-1
    bot = 13 * 512 + 512 * 256 + 256 * 64 + 64 * 16
    inter = 351 * 16
    top = 367 * 512 + 512 * 256 + 256 * 1
    assert (bot, inter, top) == (155_136, 5_616, 319_232)
    cfg = config("dlrm-criteo-kaggle")
    assert counts.forward_macs(cfg) == 479_984
    assert counts.train_flops_per_example(cfg) == 2_879_904


def test_row_bytes_by_hand():
    # two tables, four lookups each: table 0 has ids {1, 1, 2, 2} (2
    # distinct), table 1 {5, 6, 7, 8} (4 distinct); dim 128
    ls_i = np.array([[1, 1, 2, 2], [5, 6, 7, 8]])
    n, u = 8, 6
    assert counts.train_row_bytes(ls_i, 128) == (2 * n + 3 * u) * 128 * 4 == 17_408
    assert counts.refill_row_bytes(10, 3, 16) == 2 * 13 * 16 * 4


def test_table_sizes_by_hand():
    tb, kg = config("cdlrm-criteo1tb")["ln_emb"], config("dlrm-criteo-kaggle")["ln_emb"]
    assert (len(tb), sum(tb)) == (26, 204_184_588)
    assert (len(kg), sum(kg)) == (26, 33_762_577)


def test_peaks_are_the_data_sheets():
    assert counts.PEAK_FLOPS == {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
    assert counts.PEAK_BYTES_PER_S == 3.35e12
