#!/usr/bin/env python3
"""Smoke run of cdlrm_tpu_torch on one NVIDIA GPU (built for an H100).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/row_ops.cu, checks each one bit-exact
against its plain PyTorch version at the serving shapes and times both,
serves synthetic traffic through the port's cached serving path at the full
width of the headline model (26 tables x 250,000 rows, dim 128, bottom MLP
13-512-256-128, top MLP 512-256-1, cache 16,384 sets x 8 ways, batch 4096,
bfloat16), checks one batch's scores against the same inputs run through the
port on the CPU, and runs the port's CLI. Any failed phase raises, and the
script exits non-zero without printing a result; with no CUDA device it exits
1 at once. The last line of standard output is a JSON object
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the line before that the per-kernel JSON summary.
"""

from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TABLES, ROWS, DIM = 26, 250_000, 128
BATCH, SERVE_BATCHES, WARM_BATCHES = 4096, 20, 10
TIMING_REPS = 25
# serving scores (probabilities) on the card vs the CPU: both round the same
# operands to bf16 and accumulate in float32, so they differ by summation
# order, and at worst by one bf16 rounding step (2^-8 relative) of an
# activation that lands on the other side of a rounding boundary
SCORE_TOL = 5e-3


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(card: str, rows: int, dev: torch.device) -> dict:
    """Phase 2: both kernels against their plain versions, bit-exact, at the
    serving shapes and at edge shapes; times at the serving shapes."""
    from cdlrm_tpu_torch.ops.lookup import gather_rows, gather_rows_ref
    from cdlrm_tpu_torch.ops.scatter import scatter_set_rows, scatter_set_rows_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    cache = torch.randn((rows, DIM), generator=g, device=dev)
    report = {}

    # gather: one serving batch's lookups, duplicates included
    n = TABLES * BATCH
    slots = torch.randint(0, rows, (n,), generator=g, device=dev, dtype=torch.int32)
    assert int(torch.unique(slots).numel()) < n, "want duplicate slots"
    out, ref = gather_rows(cache, slots), gather_rows_ref(cache, slots)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    assert torch.equal(out, ref), f"gather_rows differs from index_select by {err}"
    for d in (16, 6):  # float4 rows of another width; the scalar path
        c = torch.randn((5000, d), generator=g, device=dev)
        s = torch.randint(0, 5000, (3001,), generator=g, device=dev, dtype=torch.int32)
        assert torch.equal(gather_rows(c, s), gather_rows_ref(c, s)), f"gather_rows D={d}"
    ms = time_ms(lambda: gather_rows(cache, slots))
    plain_ms = time_ms(lambda: gather_rows_ref(cache, slots))
    gbytes = 2 * n * DIM * 4 / 1e9
    print(f"[{card}] gather_rows N={n} from [{rows}, {DIM}]: kernel {ms:.4f} ms "
          f"({gbytes / ms * 1e3:.1f} GB/s effective, {gbytes * 1e3:.1f} MB moved), "
          f"index_select {plain_ms:.4f} ms ({gbytes / plain_ms * 1e3:.1f} GB/s)")
    report["gather_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # row set: a refill-sized bucket, valid prefix ~100k, trash-padded tail
    def set_case(c0, u, nv, distinct_all=False):
        r = c0.shape[0]
        s = torch.full((u,), r - 1, dtype=torch.int32, device=dev)
        k = u if distinct_all else nv
        s[:k] = torch.randperm(r - 1, generator=g, device=dev)[:k].to(torch.int32)
        rows_in = torch.randn((u, c0.shape[1]), generator=g, device=dev)
        got = scatter_set_rows(c0.clone(), s, rows_in,
                               torch.tensor(nv, dtype=torch.int64, device=dev))
        want = scatter_set_rows_ref(c0.clone(), s, rows_in, nv)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        assert torch.equal(got, want), f"scatter_set_rows u={u} nv={nv} differs by {e}"
        assert torch.equal(got[r - 1], c0[r - 1]), "trash row written"
        if nv < u and not distinct_all:
            assert torch.equal(got[s[nv:].long()], c0[s[nv:].long()]), "row past nvalid written"
        return s, rows_in, e

    u, nv = 131_072, 100_000
    s_main, rows_main, err_set = set_case(cache, u, nv)
    for case in ((cache, u, 0), (cache, u, u, True), (cache, 100_003, 77_777)):
        err_set = max(err_set, set_case(*case)[2])
    small = torch.randn((20_000, 16), generator=g, device=dev)
    for case in ((small, 4096, 3000), (small, 4096, 4096, True), (small, 999, 0)):
        err_set = max(err_set, set_case(*case)[2])
    err_set = max(err_set, set_case(torch.randn((3000, 6), generator=g, device=dev), 512, 300)[2])
    nv_dev = torch.tensor(nv, dtype=torch.int64, device=dev)
    ms = time_ms(lambda: scatter_set_rows(cache, s_main, rows_main, nv_dev))
    plain_ms = time_ms(lambda: scatter_set_rows_ref(cache, s_main, rows_main, nv))
    gbytes = 2 * nv * DIM * 4 / 1e9
    print(f"[{card}] scatter_set_rows U={u} nvalid={nv} into [{rows}, {DIM}]: kernel "
          f"{ms:.4f} ms ({gbytes / ms * 1e3:.1f} GB/s effective, {gbytes * 1e3:.1f} MB moved), "
          f"index_copy_ {plain_ms:.4f} ms ({gbytes / plain_ms * 1e3:.1f} GB/s)")
    report["scatter_set_rows"] = dict(max_abs_err=err_set, ms=ms, plain_ms=plain_ms)
    print("kernels: bit-exact against their plain versions")
    return report


def serve(card: str, dev: torch.device) -> dict:
    """Phase 3: the cached serving path at the headline model's full width."""
    from cdlrm_tpu.config import Config
    from cdlrm_tpu.data.synthetic import SyntheticDataset
    from cdlrm_tpu_torch.config import finalize
    from cdlrm_tpu_torch.ops.lookup import gather_rows
    from cdlrm_tpu_torch.ops.scatter import scatter_set_rows
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer, TrainMetrics

    cfg = finalize(Config(
        arch_sparse_feature_size=DIM, arch_mlp_bot="13-512-256-128",
        arch_mlp_top="512-256-1", mini_batch_size=BATCH, world_size=1,
        cache_size=16_384, num_ways=8, loss_function="bce", round_targets=True,
        compute_dtype="bfloat16", master_init="virtual", inference_only=True,
        numpy_rand_seed=SEED,
    ), ln_emb=np.full(TABLES, ROWS, dtype=np.int64))
    test_ds = SyntheticDataset(
        m_den=13, ln_emb=cfg.ln_emb, data_size=BATCH * SERVE_BATCHES,
        mini_batch_size=BATCH, num_indices_per_lookup=1,
        num_indices_per_lookup_fixed=True, round_targets=True, seed=SEED + 1,
    )
    t0 = time.perf_counter()
    tr = CachedDlrmTrainer(cfg, test_ds, test_ds, device=dev)
    print(f"[{card}] trainer built in {time.perf_counter() - t0:.2f} s: cache "
          f"{tuple(tr.cache.shape)} float32 ({tr.cache.numel() * 4 / 1e9:.3f} GB) on {dev}")
    try:
        # warm the cache: one insert of the first batches' unique ids
        warm = list(itertools.islice(test_ds.batches(), WARM_BATCHES))
        uniques = [np.unique(np.concatenate([b.ls_i[t] for b in warm])) for t in range(TABLES)]
        plan = tr.controller.plan_insert(uniques, tr.master.gather_all(uniques))
        t0 = time.perf_counter()
        evicted = tr.refill(plan)
        torch.cuda.synchronize()
        print(f"[{card}] warm-up refill: {plan.insert_slots.size} rows inserted, "
              f"{evicted.shape[0]} evicted, {time.perf_counter() - t0:.3f} s host wall")
        tr.evaluate(max_batches=2, log_fn=lambda *_: None)  # first-call set-up
        tr.metrics = TrainMetrics()

        gather_rows.launches = 0
        scatter_set_rows.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, auc = tr.evaluate(max_batches=SERVE_BATCHES)
        wall = time.perf_counter() - t0
        launches = {"gather_rows": gather_rows.launches,
                    "scatter_set_rows": scatter_set_rows.launches}
        hit = tr.metrics.eval_hit_rate
        print(f"[{card}] served {SERVE_BATCHES} batches of {BATCH}: accuracy {acc:.6f} "
              f"AUC {auc:.6f} eval hit rate {hit:.6f}, {SERVE_BATCHES * BATCH / wall:.1f} "
              f"examples/s ({wall:.3f} s host wall), kernel launches {launches}")
        assert np.isfinite(acc) and np.isfinite(auc), (acc, auc)
        assert hit > 0, "the warm-up refill left no hits"
        assert launches["gather_rows"] == SERVE_BATCHES, launches
        assert launches["scatter_set_rows"] > 0, launches

        # one batch on the card against the same inputs through the port on
        # the CPU (plain versions), from the same starting cache
        batch = next(iter(test_ds.batches()))
        inputs = tr._stage_eval(tr._probe_eval(batch))
        cache_cpu = tr.cache.cpu()
        params_cpu = {k: [(w.cpu(), b.cpu()) for w, b in v] for k, v in tr.params.items()}
        _, s_dev = tr.eval_step(tr.params, tr.cache, *inputs)
        _, s_cpu = tr.eval_step(params_cpu, cache_cpu, *[x.cpu() for x in inputs])
        s_dev = s_dev.cpu()
        assert s_dev.shape == (BATCH, 1) and bool(torch.isfinite(s_dev).all())
        score_err = float((s_dev - s_cpu).abs().max())
        assert torch.equal(tr.cache.cpu(), cache_cpu), "staged cache differs from the CPU's"
        assert score_err <= SCORE_TOL, f"scores differ from the CPU run by {score_err}"
        print(f"one batch vs the CPU run: max |score difference| {score_err:.3e} "
              f"(tolerance {SCORE_TOL}), staged caches equal")
    finally:
        tr.close()
    return launches


def run_cli(dev: torch.device) -> None:
    """Phase 4: the port's CLI at a small size on the card."""
    cmd = [
        sys.executable, "-m", "cdlrm_tpu_torch.cli", "--device", dev.type,
        "--inference-only", "--data-generation", "random",
        "--arch-embedding-size", "1000-500-2000", "--arch-sparse-feature-size", "16",
        "--arch-mlp-bot", "13-32-16", "--arch-mlp-top", "16-8-1",
        "--mini-batch-size", "64", "--num-batches", "10", "--cache-size", "128",
        "--num-ways", "4", "--loss-function", "bce", "--round-targets",
    ]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    if res.returncode != 0 or "Test accuracy" not in res.stdout:
        raise RuntimeError(f"CLI failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    print("cli:", res.stdout.strip().splitlines()[-1])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from cdlrm_tpu.cache.geometry import CacheGeometry
    from cdlrm_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[{card}] kernel library built and loaded in {time.perf_counter() - t0:.2f} s")

    rows = CacheGeometry.build(
        [ROWS] * TABLES, DIM, 16_384, 8, BATCH
    ).total_rows  # the serving cache's row count
    kernels = check_kernels(card, rows, dev)
    torch.cuda.empty_cache()
    launches = serve(card, dev)
    run_cli(dev)
    assert "jax" not in sys.modules, "the port imported jax"

    sources = {"gather_rows": "cdlrm_tpu/ops/lookup.py:70",
               "scatter_set_rows": "cdlrm_tpu/ops/scatter.py:257"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "cdlrm_tpu_torch/csrc/row_ops.cu",
         "replaces": sources[name], "launches": launches[name], **kernels[name]}
        for name in ("gather_rows", "scatter_set_rows")
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
