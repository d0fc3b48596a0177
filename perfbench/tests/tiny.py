"""Tiny cells for the CPU tests: the benchmark's cells' flows at test size.
The metrics of a cell are found as the harness finds them: by the cell's
name, in BENCHMARK.json and in the readers' ``CELLS``."""

import glob
import json
import os

from perfbench import harness

ROOT = harness.ROOT
NAMES = {("cached", "train"): "criteo1tb.flat", ("fulltable", "train"): "kaggle.fulltable",
         ("cached", "score"): "criteo1tb.score"}


def _metrics(name: str, entry: str):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    e2e = [{"name": "setup_s", "unit": "s"},
           {"name": "train_examples_per_s", "unit": "examples/s"},
           {"name": "train_step_ms_p95", "unit": "ms"}] if entry == "train" else [
           {"name": "setup_s", "unit": "s"}, {"name": "score_examples_per_s", "unit": "examples/s"}]
    per_layer = {m["name"]: m for m in spec["per_layer"] if name in m.get("workloads", [name])}
    for path in glob.glob(os.path.join(harness.HERE, "metrics", "*.py")):
        mod = harness.load_metric(os.path.basename(path)[:-3])
        if name in mod.CELLS:
            per_layer.setdefault(mod.NAME, {"name": mod.NAME, "unit": mod.UNIT})
    return e2e, sorted(per_layer.values(), key=lambda m: m["name"])


def cell(kind: str, entry: str, ids: str = "loguniform", cache_size: int = 8000):
    kw = {"arch_sparse_feature_size": 16, "arch_mlp_bot": "13-32-16", "arch_mlp_top": "32-16-1",
          "ln_emb": [5000, 3, 800, 20000], "loss_function": "bce", "round_targets": True,
          "mini_batch_size": 64, "test_mini_batch_size": 128, "world_size": 1,
          "optimizer": "sgd", "learning_rate": 0.8, "lr_embeds": 0.8,
          "compute_dtype": "float32", "nepochs": 1, "print_freq": 1000000}
    if kind == "cached":
        kw.update(use_cache=True, cache_size=cache_size, num_ways=4, lookahead=10,
                  cache_workers=2, batch_fifo_size=4, master_init="virtual", scan_steps=1)
    else:
        kw.update(use_cache=False, num_indices_per_lookup=1, num_indices_per_lookup_fixed=True)
    if entry == "train":
        traffic = {"entry": "train", "ids": {"kind": ids}, "warmup_steps": 20,
                   "pool_examples": 64 * 2000,
                   "trace_offset": 5, "trace_steps": 10}
        limits = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "rows_off": 0}
        if kind == "cached":
            limits.update(writeback_off=0, insert_off=0)
    else:
        traffic = {"entry": "score", "fill_ids": {"kind": ids}, "fill_steps": 10,
                   "ids": {"kind": ids}, "warmup_batches": 3,
                   "pool_examples": 128 * 50,
                   "trace_offset": 1, "trace_batches": 4, "check_every": 3}
        limits = {"score_gap": 1e-4}
    name = NAMES[(kind, entry)]
    e2e, per_layer = _metrics(name, entry)
    return harness.Cell(name=name, config_name="tiny", config={"config": kw}, traffic=traffic,
                        end_to_end=e2e, per_layer=per_layer, limits=limits)
