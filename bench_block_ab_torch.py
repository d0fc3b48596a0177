#!/usr/bin/env python3
"""Block-coalesced sparse update against the per-step dedup scatter, at the
kernel level, on cdlrm_tpu_torch's hand-written row kernels.

The port's counterpart of bench_block_ab.py, on its streams, host-side
inputs and chains. Both arms pay the same N-row segment sum each step (the
gradient of the dedup expand); they differ in the extra work:

  A (the dedup wire)       per step, ``index_add_rows`` of the step's N
                           gradient rows into a zeroed ``[u_bucket, D]``,
                           then ``scatter_add_rows`` of the step's unique
                           rows into the cache (``nvalid`` = the step's
                           unique count: the padding is not added, as in
                           the Pallas branch);
  B (block-coalesced)      per step, ``index_add_rows`` into the pending
                           buffer and the effective-weight read
                           ``cache[ua] - 0.1 * pend[ublk]`` through two
                           ``gather_rows``; per block of 10 steps, one
                           ``scatter_add_rows`` of the block union
                           (``nvalid`` = U_block) and the pending buffer
                           zeroed.

Both are exact SGD up to the order of the adds, so each arm's cache after
one chain from zero is held, with the same chain run through the kernels'
plain PyTorch versions, to a float64 sum of the same terms: every element
within 1e-5 of it, relative to 1 + the sum of its terms' magnitudes (the
scale of a reassociated float32 sum's error); rows outside the block union
stay exactly zero.

Timing as the reference's: 2 warm-up chains, then 5 timed 10-step chains on
the host clock, ending in a copy to the host, and one pair of CUDA events
around the same 5 chains (``per_step_ms_*_events``). Streams: loguniform
and zipf(1.2) over 26 tables x 250,000 ids at batch 4096 (N = 106,496
lookups a step), drawn from SFC64(7) after the gradients, as the reference
draws them; the cache is 3,520,000 x 128 float32.

Run from the repository root:

    python3 bench_block_ab_torch.py                 # on cuda:0
    BLOCKAB_CPU=1 BLOCKAB_TABLES=2 BLOCKAB_IDS=500 BLOCKAB_BATCH=32 \\
        BLOCKAB_CACHE_ROWS=2048 python3 bench_block_ab_torch.py
                                                    # the CPU: a smoke of the
                                                    # flow, never a number

The knobs are the reference's: ``BLOCKAB_TABLES``, ``BLOCKAB_IDS``,
``BLOCKAB_BATCH``, ``BLOCKAB_CACHE_ROWS``, ``BLOCKAB_CPU``. Without a card and
without ``BLOCKAB_CPU`` it exits 1. It prints one JSON line per stream, the
reference's keys plus ``backend``, ``device`` (the card's name and power
limit), the check's errors and the stream's kernel ``launches``.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np

import bench_torch

D = 128
STEPS = 10
REPS = 5
STREAMS = ("loguniform", "zipf12")
# every element of a chain's cache within this of the float64 sum of its
# terms, relative to 1 + the sum of the terms' magnitudes
CHECK_TOL = 1e-5


def log(msg: str) -> None:
    print(f"[blockab_torch] {msg}", file=sys.stderr, flush=True)


def knobs(env: dict) -> dict:
    """bench_block_ab.py:36-39's geometry knobs, with its defaults."""
    return dict(tables=int(env.get("BLOCKAB_TABLES", "26")),
                batch=int(env.get("BLOCKAB_BATCH", "4096")),
                ids=int(env.get("BLOCKAB_IDS", "250000")),
                cache_rows=int(env.get("BLOCKAB_CACHE_ROWS", str(3_520_000))))


def stream_indices(kind: str, steps: int, rng, tables: int, batch: int, ids: int) -> list:
    """bench_block_ab.py:43's id streams, ``[tables, batch]`` int64 a step."""
    out = []
    for _ in range(steps):
        if kind == "loguniform":
            u = rng.random((tables, batch), dtype=np.float32)
            ls = (np.exp(u * np.log(ids)).astype(np.int64) - 1) % ids
        else:
            a = 1.2
            u = rng.random((tables, batch), dtype=np.float64)
            v = np.minimum(np.power(1.0 - u, -1.0 / (a - 1.0)), 9e18)
            ls = (v.astype(np.int64) - 1) % ids
        out.append(ls.astype(np.int64))
    return out


def pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def host_inputs(ls: list, tables: int, cache_rows: int) -> dict:
    """The reference's host side (bench_block_ab.py:78-121): the steps' ids
    flattened to cache rows (table t owns rows from t * (cache_rows //
    tables)), each step's uniques and ranks (arm A), the block union and
    each step's ranks in it (arm B), and the pow2 buckets.

    The flattening can pass the cache's end: at the defaults the last
    table's rows run to 25 * 135,384 + 249,999 = 3,634,599 of 3,520,000.
    The reference's XLA ops drop an add past the end and clamp a gather to
    the last row; the kernels check no bound, so here the adds stop at the
    in-range prefix of each sorted list (``nvalid``, ``u_valid``) and the
    gathered slots are clamped to the last row: the same values."""
    offsets = np.arange(tables, dtype=np.int64) * (cache_rows // tables)
    flat = [(l + offsets[:, None]).reshape(-1) for l in ls]
    step_u, step_ranks, step_uniq = [], [], []
    for f in flat:
        uniq, ranks = np.unique(f, return_inverse=True)
        step_u.append(len(uniq))
        step_ranks.append(ranks.astype(np.int32))
        step_uniq.append(uniq.astype(np.int32))
    bu = np.unique(np.concatenate(flat))
    u_block = len(bu)
    u_bucket = pow2(max(step_u))
    p_rows = pow2(u_block)
    last = cache_rows - 1
    return dict(
        flat=flat, step_u=step_u, u_bucket=u_bucket, u_block=u_block, p_rows=p_rows,
        u_valid=int(np.searchsorted(bu, cache_rows)),
        ranks_a=np.stack(step_ranks),
        uniq_a=np.stack([np.pad(np.minimum(u, last), (0, u_bucket - len(u)),
                                constant_values=last) for u in step_uniq]),
        nvalid=np.array([np.searchsorted(u, cache_rows) for u in step_uniq], np.int64),
        ranks_b=np.stack([np.searchsorted(bu, f).astype(np.int32) for f in flat]),
        uniq_blk=np.stack([np.pad(np.searchsorted(bu, u).astype(np.int32),
                                  (0, u_bucket - len(u)), constant_values=0)
                           for u in step_uniq]),
        uniq_b=np.pad(np.minimum(bu, last).astype(np.int32), (0, p_rows - u_block),
                      constant_values=last),
    )


def row_ops(plain: bool = False) -> SimpleNamespace:
    """The three wrappers the arms call, or their plain PyTorch versions
    (which launch nothing and count nothing)."""
    from cdlrm_tpu_torch.ops import lookup, scatter

    if plain:
        return SimpleNamespace(gather_rows=lookup.gather_rows_ref,
                               index_add_rows=lookup.index_add_rows_ref,
                               scatter_add_rows=scatter.scatter_add_rows_ref)
    return SimpleNamespace(gather_rows=lookup.gather_rows, index_add_rows=lookup.index_add_rows,
                           scatter_add_rows=scatter.scatter_add_rows)


def chain_a(cache, t: SimpleNamespace, grads, ops):
    """One 10-step chain of arm A on ``cache``, in place."""
    import torch

    for s in range(STEPS):
        seg = torch.zeros((t.u_bucket, D), dtype=torch.float32, device=cache.device)
        ops.index_add_rows(seg, t.ranks_a[s], grads[s])
        ops.scatter_add_rows(cache, t.uniq_a[s], seg, t.nvalid[s:s + 1])
    return cache


def chain_b(cache, pend, t: SimpleNamespace, grads, ops):
    """One 10-step chain of arm B on ``cache`` and the pending buffer, in
    place; returns the sum of the effective weights read (the reference's
    ``s``)."""
    total = cache.new_zeros(())
    for s in range(STEPS):
        ops.index_add_rows(pend, t.ranks_b[s], grads[s])
        eff = ops.gather_rows(cache, t.uniq_a[s]) - 0.1 * ops.gather_rows(pend, t.uniq_blk[s])
        total += eff.sum()
    ops.scatter_add_rows(cache, t.uniq_b, pend, t.u_valid_t)
    pend.zero_()
    return total


def check_chains(t: SimpleNamespace, grads, cache_rows: int, dev) -> dict:
    """Each arm's cache after one chain from zero, through the kernels and
    through their plain versions, against the float64 sum of the same
    terms over the block union; rows outside it must stay zero."""
    import torch

    union = t.uniq_b[: t.u_valid]
    ref = torch.zeros((t.p_rows, D), dtype=torch.float64, device=dev)
    mag = torch.zeros_like(ref)
    for s in range(STEPS):
        g = grads[s].double()
        ref.index_add_(0, t.ranks_b[s].long(), g)
        mag.index_add_(0, t.ranks_b[s].long(), g.abs())
    ref, scale = ref[: t.u_valid], 1.0 + mag[: t.u_valid]
    errs, rows = {}, {}
    for name, plain in (("A", False), ("B", False), ("A_plain", True), ("B_plain", True)):
        ops = row_ops(plain)
        cache = torch.zeros((cache_rows, D), dtype=torch.float32, device=dev)
        if name.startswith("A"):
            chain_a(cache, t, grads, ops)
        else:
            pend = torch.zeros((t.p_rows, D), dtype=torch.float32, device=dev)
            chain_b(cache, pend, t, grads, ops)
            del pend
        got = cache.index_select(0, union.long())
        errs[name] = float(((got.double() - ref).abs() / scale).max())
        rows[name] = got
        outside = float(cache.index_fill_(0, union.long(), 0.0).abs().max())
        assert outside == 0.0, f"arm {name} wrote outside the block union ({outside})"
        del cache
    for a, b in (("A", "B"), ("A", "A_plain"), ("B", "B_plain")):
        errs[f"{a}_vs_{b}"] = float(((rows[a].double() - rows[b].double()).abs() / scale).max())
    for name, e in errs.items():
        assert e <= CHECK_TOL, f"block A/B check: {name} off by {e} (tolerance {CHECK_TOL})"
    return errs


def timed(dev, chain, sync) -> tuple:
    """The reference's discipline: 2 warm-up chains, a copy to the host,
    then ``REPS`` chains ending in a copy to the host on the host clock,
    with one pair of CUDA events around the same chains. Returns (host ms,
    event ms) a step."""
    chain()
    sync(chain())
    t0 = time.perf_counter()
    with bench_torch.DeviceClock(dev) as clock:
        for _ in range(REPS - 1):
            chain()
        last = chain()
    sync(last)
    host_ms = (time.perf_counter() - t0) / (REPS * STEPS) * 1e3
    return host_ms, clock.ms / (REPS * STEPS)


def run(env: dict) -> dict:
    """Both arms on both streams; returns ``{"streams": [line, line], ...}``,
    one line per stream as the reference prints them."""
    import torch

    cpu = bool(env.get("BLOCKAB_CPU"))
    dev = bench_torch.device_for(cpu, "bench_block_ab_torch", "BLOCKAB_CPU")
    device = None if cpu else bench_torch.card_line()
    k = knobs(env)
    n = k["tables"] * k["batch"]
    rng = np.random.Generator(np.random.SFC64(7))
    grads = torch.from_numpy(rng.random((STEPS, n, D), np.float32) - 0.5).to(dev)
    lines = []
    bench_torch.reset_launches()
    for kind in STREAMS:
        h = host_inputs(stream_indices(kind, STEPS, rng, k["tables"], k["batch"], k["ids"]),
                        k["tables"], k["cache_rows"])
        t = SimpleNamespace(**{key: torch.from_numpy(np.ascontiguousarray(h[key])).to(dev)
                               for key in ("ranks_a", "uniq_a", "nvalid", "ranks_b",
                                           "uniq_blk", "uniq_b")},
                            u_bucket=h["u_bucket"], u_valid=h["u_valid"], p_rows=h["p_rows"])
        t.u_valid_t = torch.tensor([h["u_valid"]], dtype=torch.int64, device=dev)
        log(f"{kind}: N={n} U_step_max={max(h['step_u'])} U_block={h['u_block']} on {dev}")
        before = bench_torch.read_launches()
        errs = check_chains(t, grads, k["cache_rows"], dev)
        ops = row_ops()

        cache = torch.zeros((k["cache_rows"], D), dtype=torch.float32, device=dev)
        a_ms, a_ev = timed(dev, lambda: chain_a(cache, t, grads, ops),
                           lambda c: float(c[0, 0]))
        del cache
        cache = torch.zeros((k["cache_rows"], D), dtype=torch.float32, device=dev)
        pend = torch.zeros((h["p_rows"], D), dtype=torch.float32, device=dev)
        b_ms, b_ev = timed(dev, lambda: chain_b(cache, pend, t, grads, ops), float)
        del cache, pend
        after = bench_torch.read_launches()
        launches = {name: after[name] - before[name] for name in after}
        lines.append({
            "stream": kind, "N": n, "U_step_max": int(max(h["step_u"])),
            "u_bucket": h["u_bucket"], "U_block": int(h["u_block"]), "p_rows": h["p_rows"],
            "U_block_past_cache": h["u_block"] - h["u_valid"],
            "per_step_ms_A_dedup": round(a_ms, 4),
            "per_step_ms_B_coalesced": round(b_ms, 4),
            "B_over_A": round(b_ms / a_ms, 4),
            "per_step_ms_A_dedup_events": round(a_ev, 4),
            "per_step_ms_B_coalesced_events": round(b_ev, 4),
            "B_over_A_events": round(b_ev / a_ev, 4),
            "check_max_err": {name: float(f"{e:.3e}") for name, e in errs.items()},
            "check_tol": CHECK_TOL,
            "backend": dev.type, "device": device, "launches": launches,
        })
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"metric": "block_ab", "streams": lines, "backend": dev.type, "device": device,
            "launches": bench_torch.read_launches()}


if __name__ == "__main__":
    sys.exit(bench_torch.main(run, lines=lambda rec: rec["streams"]))
