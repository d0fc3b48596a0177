"""The control comes out not correct: the reference computed with TF32
matrix products in the program's place fails one of each cell's numbers
against its limits, at the cell's own widths and batch (three steps, or a
few scored batches). Needs a card: TF32 exists there only. On a card:
``python -m pytest perfbench/tests -m card``."""

import json
import os

import pytest

from perfbench import check, harness

ROOT = harness.ROOT


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", cells())
def test_the_control_fails_the_cells_limits(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control computes in TF32")
    from perfbench import control

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), name)
    cell.traffic = dict(cell.traffic, control_batches=4)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        out = control.readings(cell, seed, torch.device("cuda", 0))
        assert not check.judge(out["control_tf32"], cell.limits), out
        if "fault_half_batch" in out:
            assert not check.judge(out["fault_half_batch"], cell.limits), out
