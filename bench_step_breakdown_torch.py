#!/usr/bin/env python3
"""Where the block-coalesced train step of cdlrm_tpu_torch goes: each of its
components timed alone at the headline shapes, on the port's kernels and
model, beside the port's measured block step.

The port's counterpart of bench_step_breakdown.py, at its shapes (26 x 250k
tables, dim 128, batch 4096, so N = 106,496 lookups; a flat cache of
3,538,944 x 128 float32 rows; a per-step unique bucket of 65,536 with 46,600
valid; a block-union pending buffer of 524,288 rows with 300,000 valid):

  gather_uniq    ``gather_rows``: the step's unique rows from the cache
  expand_take    ``gather_rows``: the per-lookup rows from the unique rows
  pend_scatter   ``index_add_rows``: the per-lookup gradients into the
                 pending buffer (duplicate ranks; the coalesced step's
                 replacement of the cache update)
  cache_scatter  ``scatter_add_rows``: the per-step path's unique-row update
                 of the cache (what coalescing amortises over a block)
  flush_scatter  ``scatter_add_rows``: the block's one flush of its union
  dense_fwdbwd   models/dlrm.py's forward and backward at batch 4096 in
                 bfloat16, the embedding rows an autograd leaf

Each component is called back to back between one pair of CUDA events, after
a warm call, and its time is the pair's over the calls. The summary line adds
the components as the coalesced and the per-step paths would, and beside the
sum ``block_step_ms_per_iter``: the trainer's coalesced block of 10 steps
(``_get_step(10, True, True)``) timed as bench_torch.py times it, on the
headline trainer with the unpacked dedup wire.

Run from the repository root (``python3 bench_step_breakdown_torch.py``); it
prints one JSON line per component and the summary line last.
``BREAKDOWN_CPU=1`` runs the reference's tiny shapes and bench_torch.py's CPU
geometry on the CPU: a smoke of the flow, never a number to report. Without
a card and without it, it exits 1.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import bench_torch


def log(msg: str) -> None:
    print(f"[breakdown_torch] {msg}", file=sys.stderr, flush=True)


def shapes(cpu: bool) -> dict:
    """bench_step_breakdown.py:64-77's shapes, or its CPU ones (:78-81)."""
    if cpu:
        return dict(T=4, B=128, D=32, R=20_000, UB=1024, NV=700, P=4096, PV=2000,
                    bot="13-64-32", top="64-32-1", iters=5)
    return dict(T=26, B=4096, D=128, R=3_538_944, UB=65_536, NV=46_600, P=524_288,
                PV=300_000, bot="13-512-256-128", top="512-256-1", iters=30)


HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device-memory rate (NVIDIA's data sheet)
BF16_FLOPS_PER_S = 989e12  # its dense bfloat16 tensor-core rate


def dense_bound(cfg, s) -> dict:
    """The least time the card could take for ``dense_fwdbwd``: the larger of
    its bytes (the rows read and their gradient written, the dense features,
    the targets, every parameter read and its gradient written, in float32)
    over the memory rate, and its operations (forward multiply-adds of the
    MLPs and of the [F, F] dot interaction, F = T + 1, at 2 operations each,
    and the backward's twice the forward) over the bfloat16 rate."""
    T, B, D = s["T"], s["B"], s["D"]
    mlp = sum(a * b for ln in (cfg.ln_bot, cfg.ln_top) for a, b in zip(ln[:-1], ln[1:]))
    params = sum(a * b + b for ln in (cfg.ln_bot, cfg.ln_top) for a, b in zip(ln[:-1], ln[1:]))
    flops = 3 * 2 * B * (mlp + (T + 1) ** 2 * D)
    nbytes = 4 * (2 * T * B * D + B * (cfg.ln_bot[0] + 1) + 2 * params)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations", "flops": flops, "bytes": nbytes}


def _dense_step(cfg, dev, s, rng):
    """The dense forward and backward of one step: the rows [T*B, D] an
    autograd leaf, gradients with respect to the parameters and the rows."""
    import torch

    from cdlrm_tpu_torch.models.dlrm import (
        compute_loss, dense_from_leaves, dlrm_forward, init_dlrm, param_leaves,
    )

    T, B, D = s["T"], s["B"], s["D"]
    params = init_dlrm(rng, cfg.ln_bot, cfg.ln_top, device=dev)
    leaves = [p.requires_grad_() for p in param_leaves(params)]
    live = dense_from_leaves(leaves, params)
    x = torch.from_numpy(rng.normal(size=(B, 13)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(rng.normal(size=(T * B, D)).astype(np.float32)).to(dev)
    rows.requires_grad_()
    y = torch.from_numpy((rng.random((B, 1)) < 0.5).astype(np.float32)).to(dev)

    def step():
        p = dlrm_forward(live, x, rows.view(T, B, D), cfg.arch_interaction_op,
                         cfg.arch_interaction_itself, cfg.loss_threshold, torch.bfloat16)
        loss = compute_loss(p, y, "bce")
        torch.autograd.grad(loss, leaves + [rows])
        return loss

    return step


def block_step(env_cpu: bool, dev) -> tuple:
    """The port's coalesced block of 10 on the headline trainer (unpacked
    dedup wire, block-coalesced update): bench_torch.device_block_ms after
    one window's warm-up block. Returns (ms per step, coalesced)."""
    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    env = {"BENCH_DEDUP": "on", "BENCH_PACK": "0", "BENCH_BLOCK": "1"}
    if env_cpu:
        env["BENCH_CPU"] = "1"
    geo = bench_torch.geometry(env)
    ln_emb = np.full(geo["tables"], geo["rows"], dtype=np.int64)
    cfg = Config(**bench_torch.config_kwargs(env, geo)).finalize(ln_emb=ln_emb)
    k = cfg.scan_steps
    ds = bench_torch.ZipfDataset(ln_emb, geo["batch"], 2 * k)
    tr = CachedDlrmTrainer(cfg, ds, device=dev)
    try:
        tr.train(max_steps=k, log_fn=lambda *_: None)
        bench_torch.synchronize(dev)
        ms, coalesced, _ = bench_torch.device_block_ms(tr, ds, dev)
    finally:
        tr.close()
    return ms, coalesced


def run(env: dict) -> dict:
    """Time the components and the block step; returns the summary line."""
    import torch

    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.ops.lookup import gather_rows, index_add_rows
    from cdlrm_tpu_torch.ops.scatter import scatter_add_rows

    cpu = bool(env.get("BREAKDOWN_CPU"))
    dev = bench_torch.device_for(cpu, "bench_step_breakdown_torch", "BREAKDOWN_CPU")
    device = None if cpu else bench_torch.card_line()
    s = shapes(cpu)
    T, B, D, R, UB, NV, P, PV = (s[k] for k in ("T", "B", "D", "R", "UB", "NV", "P", "PV"))
    N, iters = T * B, s["iters"]
    rng = np.random.default_rng(7)
    results = []

    def timed(name, fn, note=""):
        fn()  # warm
        with bench_torch.DeviceClock(dev) as clock:
            for _ in range(iters):
                fn()
        rec = {"component": name, "ms": round(clock.ms / iters, 4), "note": note}
        results.append(rec)
        print(json.dumps(rec), flush=True)

    bench_torch.reset_launches()
    log(f"allocating on {dev}: cache {R}x{D} float32 ({R * D * 4 / 1e9:.2f} GB), pending {P}x{D}")
    gen = torch.Generator(device=dev).manual_seed(7)
    cache = torch.randn((R, D), generator=gen, device=dev)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # the valid unique rows distinct, the padding after them spread over
    # rows (the kernels touch only the valid prefix)
    uniq = to_dev(np.concatenate([rng.choice(R - 1, NV, replace=False),
                                  np.arange(UB - NV) % (R - 1)]).astype(np.int32))
    inv = to_dev(rng.integers(0, NV, N).astype(np.int32))
    d_rows = torch.randn((N, D), generator=gen, device=dev)
    blk_rank = to_dev(rng.integers(0, PV, N).astype(np.int32))
    pend = torch.zeros((P, D), device=dev)
    blk_slots = to_dev(np.concatenate([np.sort(rng.choice(R - 1, PV, replace=False)),
                                       np.arange(P - PV) % (R - 1)]).astype(np.int32))
    pend_full = torch.randn((P, D), generator=gen, device=dev)
    delta = torch.randn((UB, D), generator=gen, device=dev)
    nv_uniq = torch.tensor([NV], dtype=torch.int64, device=dev)
    nv_blk = torch.tensor([PV], dtype=torch.int64, device=dev)
    uniq_rows = gather_rows(cache, uniq)
    bench_torch.synchronize(dev)

    timed("gather_uniq", lambda: gather_rows(cache, uniq), f"{UB} rows from {R}x{D} f32")
    timed("expand_take", lambda: gather_rows(uniq_rows, inv), f"{N} from {UB} rows")
    timed("pend_scatter", lambda: index_add_rows(pend, blk_rank, d_rows),
          f"{N} duplicate-rank rows into {P}x{D}")
    timed("cache_scatter", lambda: scatter_add_rows(cache, uniq, delta, nv_uniq),
          f"{UB}-bucket ({NV} valid) into {R}x{D}")
    timed("flush_scatter", lambda: scatter_add_rows(cache, blk_slots, pend_full, nv_blk),
          f"{P}-bucket ({PV} valid) into {R}x{D}, once per block")
    del cache, pend, pend_full, uniq_rows
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cfg = Config(arch_sparse_feature_size=D, arch_mlp_bot=s["bot"], arch_mlp_top=s["top"],
                 mini_batch_size=B, loss_function="bce", compute_dtype="bfloat16")
    cfg = cfg.finalize(ln_emb=np.full(T, 1000, dtype=np.int64))
    timed("dense_fwdbwd", _dense_step(cfg, dev, s, rng),
          f"bot {cfg.arch_mlp_bot} top {'-'.join(map(str, cfg.ln_top))} + dot interaction, "
          f"batch {B} bf16, gradients of the parameters and the rows")
    kernel_launches = bench_torch.read_launches()

    t0 = time.perf_counter()
    blk_ms, blk_coalesced = block_step(cpu, dev)
    log(f"block step measured in {time.perf_counter() - t0:.1f} s")
    comp = {r["component"]: r["ms"] for r in results}
    coalesced = comp["gather_uniq"] + comp["expand_take"] + comp["pend_scatter"] \
        + comp["dense_fwdbwd"]
    perstep = comp["gather_uniq"] + comp["expand_take"] + comp["cache_scatter"] \
        + comp["dense_fwdbwd"]
    return {
        "metric": "step_breakdown",
        "backend": dev.type,
        "device": device,
        "sum_components_coalesced_ms": round(coalesced, 4),
        "flush_amortized_ms_at_block10": round(comp["flush_scatter"] / 10, 4),
        "sum_components_perstep_ms": round(perstep, 4),
        "components": comp,
        "dense_fwdbwd_bound": dense_bound(cfg, s),
        "block_step_ms_per_iter": round(blk_ms, 4),
        "block_coalesced": blk_coalesced,
        "component_launches": kernel_launches,
        "launches": bench_torch.read_launches(),
        "note": ("isolated-kernel sums against the trainer's coalesced block of 10 "
                 "(block_step_ms_per_iter, bench_torch.py's geometry and timing)"),
    }


if __name__ == "__main__":
    sys.exit(bench_torch.main(run))
