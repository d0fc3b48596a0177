"""The harness's flows end to end on the CPU at test size (never a device
number), the result line's keys, and the command's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny

ROOT = harness.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("kind,entry,trace", [
    ("cached", "train", False), ("cached", "train", True), ("fulltable", "train", False),
    ("cached", "score", False), ("cached", "score", True)])
def test_a_cpu_run_is_correct_and_has_the_line_keys(kind, entry, trace):
    cell = tiny.cell(kind, entry)
    out = harness.run_cell(cell, 2**31 + 11, 1.0, trace, torch.device("cpu"))
    assert list(out)[: len(KEYS)] == KEYS and list(out)[-1] == "check"
    assert out["correct"] is True, out["check"]
    assert out["device"]["platform"] == "cpu"  # a CPU run is never a device reading
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names
    for k, v in out["check"].items():
        assert v["value"] <= v["limit"], k
    json.dumps(out)


def test_without_a_card_the_command_fails_and_prints_no_result():
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "criteo1tb.flat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_beside_only_its_own_files_the_command_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "criteo1tb.flat",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0 and res.stdout.strip() == ""
