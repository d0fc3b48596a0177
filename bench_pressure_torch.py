#!/usr/bin/env python3
"""Convergence under cache pressure at the bench geometry, in
cdlrm_tpu_torch: a full-table oracle against cached runs whose cache holds
about 30%, 10% and 3% of a table, with evictions and writebacks live.

The port's counterpart of bench_pressure.py, on its stream, configuration
and knobs: 26 tables x 250,000 ids, dim 128, bottom MLP 13-512-256-128, top
MLP 512-256-1, batch 4096, bfloat16 compute, the bfloat16 row wire, scan
blocks of 4, lookahead 8, 8 ways, 240 steps. The stream is the reference's
``LatentSignalDataset`` (copied here): skewed ids whose label is carried by
hidden per-id latents, y = 1[sum_t v_t[id_t] > 0], so only trained
embedding rows can learn it and misses, evictions and writebacks shape the
trajectory. The oracle is ``FullTableDlrmTrainer`` (3.3 GB of tables on the
card); each capacity point is ``CachedDlrmTrainer`` with ``cache_size`` =
max(64, ids * capacity // ways) sets. The lookahead window's unique rows
(about 15,000 a table at the defaults) still fit 10% of a table, so the 3%
point is the one below the window's unique set, where real misses,
set-conflict drops and evictions are guaranteed.

The line: ``pressure_auc_gap`` (the oracle's AUC less each cached run's, per
capacity point), ``oracle`` and ``cached`` (acc, auc, loss, hit_rate of the
last print window, rows_written after the writebacks are flushed,
rows_per_table, wall_s), and ``pressure_real`` (the hardest point's hit rate
under 0.99 and rows written above 0), with the full ``geometry``, the
``backend``, the ``device`` (the card's name and power limit) and the
kernels' ``launches``. No artifact file is written.

Run from the repository root:

    python3 bench_pressure_torch.py          # on cuda:0
    PRESSURE_CPU=1 PRESSURE_TABLES=2 PRESSURE_IDS=20000 PRESSURE_DIM=8 \\
        PRESSURE_BATCH=256 PRESSURE_STEPS=48 python3 bench_pressure_torch.py
                                             # the CPU: a smoke of the flow

The knobs are the reference's, with its defaults: ``PRESSURE_TABLES``,
``_IDS``, ``_DIM``, ``_BATCH``, ``_STEPS``, ``_EVAL_BATCHES``, ``_STREAM``
(loguniform or zipfA), ``_HETERO``, ``_MD``, ``_LOOKAHEAD``, ``_WAYS``,
``_LR``, ``_LR_EMBEDS``, ``_ROWS_BF16``, ``_AVG_WB``, ``_OPT``,
``_ADAGRAD_MASTER``, ``_CAPS`` (default 0.3,0.1,0.03), ``_ORACLE`` ("acc,auc"
of an earlier oracle run, reused instead of training it: valid only while
the stream, steps, learning rates, optimizer and table sizes are the same)
and ``PRESSURE_CPU``. Without a card and without ``PRESSURE_CPU`` it exits 1.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import bench_torch


def log(msg: str) -> None:
    print(f"[pressure_torch] {msg}", file=sys.stderr, flush=True)


def geometry(env: dict) -> dict:
    """bench_pressure.py:29-56's knobs, with its defaults."""
    tables = int(env.get("PRESSURE_TABLES", "26"))
    ids = int(env.get("PRESSURE_IDS", "250000"))
    hetero = env.get("PRESSURE_HETERO", "0") == "1"
    sizes = (np.geomspace(max(1000, ids // 10), ids, tables).astype(np.int64) if hetero
             else np.full(tables, ids, dtype=np.int64))
    return dict(
        tables=tables, ids=ids, dim=int(env.get("PRESSURE_DIM", "128")),
        batch=int(env.get("PRESSURE_BATCH", "4096")),
        steps=int(env.get("PRESSURE_STEPS", "240")),
        eval_batches=int(env.get("PRESSURE_EVAL_BATCHES", "4")),
        stream=env.get("PRESSURE_STREAM", "loguniform"), hetero=hetero,
        md=env.get("PRESSURE_MD", "0") == "1", sizes=sizes,
        lookahead=int(env.get("PRESSURE_LOOKAHEAD", "8")),
        ways=int(env.get("PRESSURE_WAYS", "8")),
        avg_writeback=env.get("PRESSURE_AVG_WB", "0") == "1",
    )


class LatentSignalDataset:
    """bench_pressure.py:62's stream: a skewed stream whose label is carried
    by hidden per-id latents, y = 1[sum_t v_t[id_t] > 0]."""

    m_den = 13

    def __init__(self, geo: dict, num_batches: int, seed: int = 0, label_seed: int = 99):
        self.geo = geo
        self.ln_emb = geo["sizes"].copy()
        self.num_batches = num_batches
        self.seed = seed
        lrng = np.random.default_rng(label_seed)
        self.latents = lrng.normal(size=(geo["tables"], int(geo["sizes"].max()))).astype(
            np.float32)

    def __len__(self):
        return self.num_batches

    def batches(self):
        from cdlrm_tpu_torch.data.synthetic import Batch

        g = self.geo
        tables, batch, sizes, stream = g["tables"], g["batch"], g["sizes"], g["stream"]
        rng = np.random.Generator(np.random.SFC64(self.seed))
        for _ in range(self.num_batches):
            x = rng.random((batch, self.m_den), dtype=np.float32)
            u = rng.random((tables, batch), dtype=np.float32)
            n_t = sizes[:, None].astype(np.float64)
            if stream.startswith("zipf"):
                # bounded Pareto over [1, n_t] (inverse CDF): P(k) ~ k^-a
                a = float(stream[4:])
                ls = (((n_t ** (1.0 - a) - 1.0) * u + 1.0) ** (1.0 / (1.0 - a))).astype(
                    np.int64) - 1
            else:  # loguniform
                ls = np.exp(u * np.log(n_t)).astype(np.int64) - 1
            ls %= sizes[:, None]
            v = self.latents[np.arange(tables)[:, None], ls].sum(axis=0)
            y = (v > 0).astype(np.float32)[:, None]
            yield Batch(x, ls, None, y)


def config_kwargs(env: dict, geo: dict, **kw) -> dict:
    """bench_pressure.py:104's ``_cfg`` keyword arguments."""
    dim = geo["dim"]
    base = dict(
        arch_sparse_feature_size=dim,
        arch_mlp_bot=f"13-512-256-{dim}",  # the bottom MLP's output is the row width
        arch_mlp_top="512-256-1",
        mini_batch_size=geo["batch"],
        world_size=1,
        loss_function="bce",
        lookahead=geo["lookahead"],
        table_agg_freq=1_000_000,
        print_freq=40,
        learning_rate=float(env.get("PRESSURE_LR", "0.1")),
        lr_embeds=float(env.get("PRESSURE_LR_EMBEDS", "0.5")),
        num_ways=geo["ways"],
        eviction_fifo_size=256,
        compute_dtype="bfloat16",
        round_targets=True,
        scan_steps=4,
        wire_rows_bf16=env.get("PRESSURE_ROWS_BF16", "1") == "1",
        batch_fifo_size=4,
        average_on_writeback=geo["avg_writeback"],
        optimizer=env.get("PRESSURE_OPT", "sgd"),
        adagrad_master_state=env.get("PRESSURE_ADAGRAD_MASTER", "0") == "1",
        dedup_lookups="on" if env.get("PRESSURE_OPT") == "adagrad" else "auto",
        md_flag=geo["md"],
    )
    base.update(kw)
    return base


def make_config(env: dict, geo: dict, **kw):
    from cdlrm_tpu_torch.config import Config

    cfg = Config(**config_kwargs(env, geo, **kw))
    cfg.finalize(ln_emb=geo["sizes"].copy())
    return cfg


def run_cached(env: dict, geo: dict, capacity_frac: float, dev) -> dict:
    """One capacity point (bench_pressure.py:148-180)."""
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    sets = max(64, int(geo["ids"] * capacity_frac) // geo["ways"])
    cfg = make_config(env, geo, cache_size=sets)
    train = LatentSignalDataset(geo, geo["steps"] + geo["lookahead"])
    test = LatentSignalDataset(geo, geo["eval_batches"], seed=1234)
    t0 = time.perf_counter()
    tr = CachedDlrmTrainer(cfg, train, test, device=dev)
    final = {}
    try:
        def cap(line):
            if tr.last_window is not None:
                final.update(tr.last_window)
            log(f"cap={capacity_frac}: {line}")

        tr.train(max_steps=geo["steps"], log_fn=cap)
        acc, auc = tr.evaluate(log_fn=lambda s: None)
        tr.eviction_manager.flush()
        rows_written = tr.eviction_manager.rows_written
        rows_per_table = int(np.max(tr.geo.ways * tr.geo.sets))
    finally:
        tr.close()
    out = {
        "capacity_frac": capacity_frac,
        "rows_per_table": rows_per_table,
        "acc": float(acc), "auc": float(auc),
        "loss": float(final.get("loss", np.nan)),
        "hit_rate": float(final.get("hit_rate", np.nan)),
        "rows_written": int(rows_written),
        "wall_s": round(time.perf_counter() - t0, 1),
    }
    log(f"cached {capacity_frac}: {out}")
    return out


def run_oracle(env: dict, geo: dict, dev) -> dict:
    """The full-table oracle (bench_pressure.py:183-197)."""
    from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

    cfg = make_config(env, geo, use_cache=False, num_indices_per_lookup=1,
                      num_indices_per_lookup_fixed=True)
    train = LatentSignalDataset(geo, geo["steps"] + geo["lookahead"])
    test = LatentSignalDataset(geo, geo["eval_batches"], seed=1234)
    t0 = time.perf_counter()
    log(f"building the full-table oracle ({4 * int(geo['sizes'].sum()) * geo['dim'] / 1e9:.2f} "
        f"GB of tables on {dev})")
    tr = FullTableDlrmTrainer(cfg, train, test, device=dev)
    try:
        tr.train(max_steps=geo["steps"], log_fn=lambda s: log(f"oracle: {s}"))
        acc, auc = tr.evaluate(log_fn=lambda s: None)
    finally:
        tr.close()
    out = {"acc": float(acc), "auc": float(auc), "wall_s": round(time.perf_counter() - t0, 1)}
    log(f"oracle: {out}")
    return out


def run(env: dict) -> dict:
    """The oracle (or its reused point) and every capacity point; returns
    the line."""
    cpu = bool(env.get("PRESSURE_CPU"))
    dev = bench_torch.device_for(cpu, "bench_pressure_torch", "PRESSURE_CPU")
    device = None if cpu else bench_torch.card_line()
    geo = geometry(env)
    log(f"backend={dev.type}, steps={geo['steps']}")
    bench_torch.reset_launches()
    if env.get("PRESSURE_ORACLE"):
        acc_s, auc_s = env["PRESSURE_ORACLE"].split(",")
        oracle = {"acc": float(acc_s), "auc": float(auc_s), "reused": True}
        log(f"oracle reused: {oracle}")
    else:
        oracle = run_oracle(env, geo, dev)
    caps = [float(c) for c in env.get("PRESSURE_CAPS", "0.3,0.1,0.03").split(",")]
    cached = [run_cached(env, geo, c, dev) for c in caps]
    hardest = cached[-1]
    return {
        "metric": "pressure_auc_gap",
        "backend": dev.type,
        "device": device,
        "steps": geo["steps"],
        "geometry": {"tables": geo["tables"], "ids": geo["ids"], "dim": geo["dim"],
                     "batch": geo["batch"], "ways": geo["ways"],
                     "lookahead": geo["lookahead"], "stream": geo["stream"],
                     "hetero": geo["hetero"], "md": geo["md"],
                     "avg_writeback": geo["avg_writeback"],
                     "eval_batches": geo["eval_batches"], "caps": caps,
                     "config": {k: v for k, v in config_kwargs(env, geo).items()
                                if k not in ("world_size",)}},
        "oracle": oracle,
        "cached": cached,
        "pressure_auc_gap": {f"{c * 100:g}%": round(oracle["auc"] - r["auc"], 4)
                             for c, r in zip(caps, cached)},
        "pressure_real": bool(hardest["hit_rate"] < 0.99 and hardest["rows_written"] > 0),
        "launches": bench_torch.read_launches(),
    }


if __name__ == "__main__":
    sys.exit(bench_torch.main(run))
