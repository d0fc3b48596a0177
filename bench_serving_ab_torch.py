#!/usr/bin/env python3
"""Serial against pipelined serving in cdlrm_tpu_torch, at near-full
residency, so that what differs is the overlap of a batch's host assembly
with the previous batch's forward, not the misses' rows on the host link.

The port's counterpart of bench_serving_ab.py, on its geometry and flow: the
headline model (26 x 250k tables, dim 128, batch 4096, bfloat16, virtual
masters, scan blocks of 10), trained 12 steps at lookahead 40 on the
loguniform stream, then served from the same stream's seed, so the eval
batches' ids are the trained window's and almost every lookup hits. Two arms
over 20 batches each:

  serial     probe, stage, eval step, scores to the host, one batch at a
             time (bench_serving_ab.py:88-100);
  pipelined  ``CachedDlrmTrainer.evaluate``: a producer thread probes and
             stages ahead, and each batch's scores come back one batch late.

Two rounds of each, interleaved (serial, pipelined, pipelined, serial), after
one warm pass of each; host clock, each arm ending with its scores on the
host. Run from the repository root (``python3 bench_serving_ab_torch.py``);
the last stdout line is the JSON record. ``SERVINGAB_CPU=1`` runs the
reference's CPU geometry on one rank (the reference's CPU mode runs an
8-device mesh; the port has one process per device), a smoke of the flow,
never a number to report. Without a card and without it, it exits 1.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import bench_torch


def log(msg: str) -> None:
    print(f"[servingab_torch] {msg}", file=sys.stderr, flush=True)


def geometry(cpu: bool) -> dict:
    """bench_serving_ab.py:38-49's geometries."""
    if cpu:
        return dict(tables=4, dim=16, batch=256, rows=3_000, cache_size=512, ways=4,
                    bot="13-32-16", top="32-16-1")
    return dict(tables=26, dim=128, batch=4096, rows=250_000, cache_size=16_384, ways=8,
                bot="13-512-256-128", top="512-256-1")


def run(env: dict) -> dict:
    """Both arms, two interleaved rounds each; returns the line."""
    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer, _pad_batch

    cpu = bool(env.get("SERVINGAB_CPU"))
    dev = bench_torch.device_for(cpu, "bench_serving_ab_torch", "SERVINGAB_CPU")
    device = None if cpu else bench_torch.card_line()
    geo = geometry(cpu)
    batch = geo["batch"]
    ln_emb = np.full(geo["tables"], geo["rows"], dtype=np.int64)
    cfg = Config(
        arch_sparse_feature_size=geo["dim"], arch_mlp_bot=geo["bot"], arch_mlp_top=geo["top"],
        mini_batch_size=batch, world_size=1, cache_size=geo["cache_size"],
        num_ways=geo["ways"], loss_function="bce", lookahead=40, table_agg_freq=1_000_000,
        print_freq=1_000_000, round_targets=True, compute_dtype="bfloat16",
        master_init="virtual", scan_steps=10, batch_fifo_size=4,
    ).finalize(ln_emb=ln_emb)

    bench_torch.reset_launches()
    # the same seed for train and eval: the eval ids are the trained window's
    tr = CachedDlrmTrainer(cfg, bench_torch.ZipfDataset(ln_emb, batch, 36, seed=0),
                           bench_torch.ZipfDataset(ln_emb, batch, 24, seed=0), device=dev)
    try:
        log(f"trainer built on {dev}; filling the cache (one window)")
        tr.train(max_steps=12, log_fn=lambda s: None)
        tb = tr._test_b_loc * tr.ndev

        def serial_eval(nb):
            for i, b in enumerate(tr.test_dataset.batches()):
                if i >= nb:
                    break
                n = b.x.shape[0]
                inputs = tr._stage_eval(tr._probe_eval(_pad_batch(b, tb)))
                tr.cache, scores = tr.eval_step(tr.params, tr.cache, *inputs)
                scores.cpu().numpy()[:n]

        def pipelined_eval(nb):
            tr.evaluate(max_batches=nb, log_fn=lambda s: None)

        def wall(fn, nb):
            t0 = time.perf_counter()
            fn(nb)
            return time.perf_counter() - t0

        nb = 20
        serial_eval(2)  # warm both paths
        pipelined_eval(2)
        dt_serial = wall(serial_eval, nb)
        dt_pipe = wall(pipelined_eval, nb)
        dt_pipe2 = wall(pipelined_eval, nb)
        dt_serial2 = wall(serial_eval, nb)
        hit = tr.metrics.eval_hit_rate
    finally:
        tr.close()

    def eps(dt):
        return round(nb * batch / dt, 1)

    rec = {
        "metric": "serving_pipeline_ab",
        "eval_hit_rate": round(hit, 4),
        "serial_examples_per_sec": eps((dt_serial + dt_serial2) / 2),
        "pipelined_examples_per_sec": eps((dt_pipe + dt_pipe2) / 2),
        "speedup": round((dt_serial + dt_serial2) / (dt_pipe + dt_pipe2), 3),
        "rounds_examples_per_sec": {"serial": [eps(dt_serial), eps(dt_serial2)],
                                    "pipelined": [eps(dt_pipe), eps(dt_pipe2)]},
        "batches": nb, "batch": batch,
        "ranks": 1,
        "backend": dev.type,
        "device": device,
        "launches": bench_torch.read_launches(),
    }
    if cpu:
        rec["note"] = ("one rank: bench_serving_ab.py's CPU mode serves on an 8-device mesh, "
                       "the port runs one process per device")
    return rec


if __name__ == "__main__":
    sys.exit(bench_torch.main(run))
