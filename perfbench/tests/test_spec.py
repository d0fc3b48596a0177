"""BENCHMARK.json against the benchmark's contract, and every name in it
against its file."""

import json
import os
import re

import pytest

from perfbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|_state|proj|(^|_)heads?(_|$)|expan|arch_")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "perfbench/run.py"]
    assert s["paths"] == ["perfbench"]
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    cells = len(s["workloads"])
    # a full check: 2 + 14 runs a cell, run_seconds + 60 each, 180 s a cell
    # to compile, 1200 s spare, within 43200 s at the full 24 cells
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and sum(w["chips"] == 4 for w in s["workloads"]) <= max(1, cells // 4)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_their_keys_and_names():
    s = spec()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [x["name"] for x in s["configs"] + s["workloads"] + s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    s = spec()
    for w in s["workloads"]:
        cell = harness.resolve(s, w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    s = spec()
    c = harness.resolve(s, cell)
    conf = next(x for x in s["configs"] if x["name"] == c.config_name)
    assert c.config["name"] == conf["name"]
    assert len(c.config["source"]) <= 200
    assert set(conf["reduced"]) == set(c.config["reduced"])
    for key in ("deployment", "assumed", "init", "reference"):
        assert c.config[key]
    assert os.path.exists(os.path.join(ROOT, "perfbench", "reference", c.config["reference"] + ".py"))
    assert c.traffic["entry"] in ("train", "score")
    assert set(c.limits) >= ({"score_gap"} if c.traffic["entry"] == "score"
                             else {"loss_gap", "grad_gap", "change_gap", "rows_off"})
    assert c.limits.get("rows_off", 0) == 0
    if c.traffic["entry"] == "train" and c.kw.get("use_cache", True):
        # the writeback and the inserts are compared exactly
        assert c.limits["writeback_off"] == 0 and c.limits["insert_off"] == 0


@pytest.mark.parametrize("metric", [m["name"] for m in spec()["per_layer"]])
def test_every_per_layer_metric_resolves_to_its_reader(metric):
    m = next(x for x in spec()["per_layer"] if x["name"] == metric)
    mod = harness.load_metric(metric)
    assert mod.NAME == metric and callable(mod.read)
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (m["layer"], m["unit"], m["moves"], m["source"])
    assert list(mod.CELLS) == m["workloads"]


def test_the_configurations_keep_their_published_widths():
    s = spec()
    tb = harness.resolve(s, "criteo1tb.flat").kw
    assert (tb["arch_sparse_feature_size"], tb["arch_mlp_bot"], tb["arch_mlp_top"]) == (
        128, "13-512-256-128", "512-512-256-1")
    assert (tb["cache_size"], tb["num_ways"], tb["learning_rate"], tb["lr_embeds"]) == (
        150000, 16, 0.8, 0.8)
    # the Kaggle configuration waits for its cell (PERF.md, Open questions)
    kg = harness.load_json(os.path.join(ROOT, "perfbench", "configs", "dlrm-criteo-kaggle.json"))["config"]
    assert (kg["arch_sparse_feature_size"], kg["arch_mlp_bot"], kg["arch_mlp_top"]) == (
        16, "13-512-256-64-16", "512-256-1")
    assert kg["use_cache"] is False
