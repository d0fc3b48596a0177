#!/usr/bin/env python3
"""Readings that the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, on a card:

- the control: the reference put in the program's place and computed one
  precision step below the configuration's float32, float32 with TF32
  matrix products, judged by the same numbers against the reference
  (float32, TF32 off);
- the reference in float64, the same numbers (how far float32's own
  rounding reads against exact arithmetic);
- training cells: the planted fault "half of the batch left out, the mean
  taken over the rest", in the reference put in the program's place.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13

One JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, device) -> dict:
    import numpy as np

    from perfbench import check, streams
    from perfbench.reference import dlrm as ref

    kw, tr = cell.kw, cell.traffic
    lr = float(np.float32(kw["learning_rate"]))
    lr_emb = float(np.float32(kw["lr_embeds"]))
    cfg = dict(kw, learning_rate=lr, lr_embeds=lr_emb)
    ln_emb = np.asarray(kw["ln_emb"], np.int64)
    out = {"workload": cell.name, "seed": seed}
    if tr["entry"] == "train":
        batch = int(kw["mini_batch_size"])
        batches = streams.Stream(ln_emb, batch, tr["ids"], seed, pool_examples=3 * batch).head(3)
        base = ref.three_steps(cfg, seed, batches, device, ref.REFERENCE)
        n_dense = len(base["state"][0][0])
        for label, mode, half in (("control_tf32", "tf32", False), ("float64", "fp64", False),
                                  ("fault_half_batch", ref.REFERENCE, True)):
            other = ref.three_steps(cfg, seed, batches, device, mode, half=half, ids=base["ids"])
            out[label] = check.train_numbers(other, base, lr, lr_emb, n_dense)
    else:
        every, count = int(tr["check_every"]), int(tr.get("control_batches", 24))
        tb = int(kw["test_mini_batch_size"])
        held = streams.Stream(ln_emb, tb, tr["ids"], seed, salt=1,
                              pool_examples=every * count * tb).head(every * count)
        picked = held[::every]
        base = ref.seed_scores(cfg, seed, picked, device, ref.REFERENCE)
        for label, mode in (("control_tf32", "tf32"), ("float64", "fp64")):
            other = ref.seed_scores(cfg, seed, picked, device, mode)
            out[label] = check.score_numbers(other, base)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device (TF32 exists on the card only)", file=sys.stderr)
        return 1
    cell = harness.resolve(harness.load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
