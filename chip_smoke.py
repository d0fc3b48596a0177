#!/usr/bin/env python3
"""Smoke run of cdlrm_tpu_torch on one NVIDIA GPU (built for an H100).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's two libraries from its sources (the CUDA kernels of
cdlrm_tpu_torch/csrc/row_ops.cu with nvcc, the host kernels of
cdlrm_tpu_torch/csrc/host_ops.cpp with g++) and checks each CUDA kernel
against its plain PyTorch version at the main path's shapes and at edge
shapes (the row gather, set and add bit-exact; the duplicate-slot row add
within a stated tolerance of a float64 reference), and times each in six interleaved rounds against the one PyTorch
call that computes the same, beside its byte bound and, for the two row
copies, a device-to-device copy of the same bytes.
Then it drives the port's main paths at the full width of the headline model
(26 tables x 250,000 rows, dim 128, bottom MLP 13-512-256-128, top MLP
512-256-1, cache 16,384 sets x 8 ways, batch 4096, bfloat16): cached
serving; cached training in two runs of 30 steps at lookahead 2, one with
the default flags (the wire chosen per window, here the plain wire) and one
on the packed dedup wire; cached training with bench.py's flags (scan blocks
of 10, the unpacked wires, lookahead 20) on bench.py's loguniform id stream
in two runs of 40 counted steps, (c) with the block-coalesced update and (d)
without; full-table training with the tables on the card; cached AdaGrad in
two runs of 30 steps on the packed dedup wire, the cache cut to 2,048 sets
so that windows evict, (e) with the master state, whose checkpoint is saved
asynchronously, loaded bit-equal into a fresh trainer and trained on, and
(f) without; full-table AdaGrad, saved and loaded bit-equal; and the wire
and model variants: (g) run (b) on the byte-lean wires (bfloat16 rows,
float8 dense features), with the bytes each step and window put on the
host-to-device link beside run (b)'s; (h) cached mixed-dimension tables on a
ladder of 26 table sizes from 2,500 to 250,000 rows, with an eval pass and
the padded cache columns read back exactly zero; (i) full-table QR and (j)
full-table MD on the same ladder, each saved and loaded bit-equal; and a
short cached training under the profiler, whose trace must name the
kernels of row_ops.cu; and data parallelism as two ranks that share the one
card and exchange over gloo (each a process of this script with its own
cache replica, prefetcher and masters): (k) 30 counted steps on the dedup
wire with the touched rows aggregated (mean) after every step and the
refill's evicted rows broadcast (``refill_broadcast='delta'``), then an eval
pass, a checkpoint that a fresh pair loads bit-equal, and one step of each
rank against the port on the CPU over the same group; (l) a few steps under
``strict``, whose refill broadcasts the whole cache; and multi-host mode as
two ranks that share the card and join through a coordinator on a local
port, each holding its row shard of the masters (phase 13): 20 counted steps
with the window-row exchange hoisted mid-window, the first window's exchanged
rows and the first eval batch's fetched rows held to the masters' values
computed from the seed, the written-back rows to the evicted ones, then an
eval pass, per-rank checkpoint files that a fresh pair loads bit-equal, and
one step of each rank against the CPU; and (phase 14) (n) run (d) with the
hot tier (``hot_tier_rows`` 4096), a block of it against the CPU and one
step with the hot tier against one without from the same state, after a
small call whose hot list holds one row twice, held bit-equal to the CPU,
and (o) run (c) on the sorted unpacked dedup wire, a block against the CPU
and one step against the default layout from the same state; and (phase 15)
the port's three harnesses at their headline defaults, in this process:
bench_torch.py (training examples/s, the device step and scan block by CUDA
events, serving, the steady-state regime with refills), the step breakdown
and the serving A/B, each record printed after the card line and its
contract checked; and (phase 16) the port's other four harnesses at their
defaults: the block A/B of the row kernels on both streams (both arms held
to each other and to their plain versions' chains), convergence under cache
pressure (a full-table oracle and cached runs at 30%, 10% and 3% of a
table, the last with real misses and writebacks), the collective bytes of
two ranks sharing the card over gloo (equal to two CPU ranks'), and the
multi-host scaling of two ranks sharing the card (a lower bound). Each run
resets every kernel's launch count just before it and reads them just after.
One serving batch, one train step of each cached run, one coalesced block,
one full-table step and one full-table AdaGrad step are checked against the
same inputs run through the port on the CPU. Last it runs the port's CLI:
serving, training, coalesced scan blocks, the full-table trainer, AdaGrad
training that saves a checkpoint, then serving from it and training resumed
from it, and the variants (the byte-lean wires under the profiler, cached
MD, full-table QR and MD). Any failed phase raises, and the script exits non-zero
without printing a result; with no CUDA device it exits 1 at once. The last
line of standard output is a JSON object ``{"ok": true, "device": {...}}``;
the line before it is the card's name and power limit, and the line before
that the per-kernel JSON summary.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bench_torch
from bench_torch import KERNELS, card_line, read_launches, reset_launches

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
TABLES, ROWS, DIM = 26, 250_000, 128
BOT_MLP, TOP_MLP, CACHE_SETS, WAYS = "13-512-256-128", "512-256-1", 16_384, 8
BATCH, SERVE_BATCHES, WARM_BATCHES = 4096, 20, 10
TRAIN_STEPS, TRAIN_WARM_STEPS, LOOKAHEAD = 30, 4, 2
# bench.py's training flags (bench.py:111-137 with BENCH_PACK=0): scan blocks
# of 10 on the unpacked wires, lookahead 20; 10 steps of set-up, then 40
BLOCK_STEPS, BLOCK_WARM_STEPS, BLOCK_LOOKAHEAD, SCAN_STEPS = 40, 10, 20, 10
CHECK_BLOCK = 2  # steps in the coalesced block held against the CPU
FT_STEPS, FT_EVAL_BATCHES = 10, 2  # full-table training, then eval
# AdaGrad (phases 7 and 8): cdlrm_tpu warns above a learning rate of 0.2
# (config.py:517-535). Phase 7 cuts the cache to 2,048 sets x 8 ways (cache
# geometry, not model width), so that from about the third window on every
# refill evicts about 8k rows per table with their state; the loaded
# trainer of the checkpoint round trip trains AG_RESUME_STEPS more steps
AG_LR, AG_CACHE_SETS, AG_RESUME_STEPS, FT_AG_STEPS = 0.01, 2_048, 4, 5
# Mixed-dimension and QR runs (phases 9 and 10): md_solver gives tables of
# different sizes different widths, so these runs keep every width of the
# headline model and take 26 tables on a geometric ladder of row counts over
# two decades, 2,500 to 250,000 rows (1,473,648 rows in all). With
# md_temperature 0.3 and widths rounded to powers of two the ladder yields
# 7 tables of width 128, 12 of 64 and 7 of 32. Full-table runs compress the
# tables above TRICK_THRESHOLD rows (18 of the 26) and keep the 8 smaller
# ones plain, so that both forms are on the path
LADDER = np.round(np.geomspace(2_500, ROWS, TABLES)).astype(np.int64)
TRICK_THRESHOLD, TRICK_STEPS, PROFILE_STEPS = 10_000, 10, 10
# The AdaGrad step held against the CPU computes in float32.
# AdaGrad divides each update by the root of its accumulated squares, so a
# bf16 rounding that differs between card and CPU in a small gradient moves
# the update by up to the learning rate (bf16 steps at lr 0.01 differed by up
# to 2.4e-3 of the 5e-3 tolerance on an H100). The bf16 forward and backward
# are held against the CPU in phases 4-6; the optimizer math is float32 in
# either dtype.
# Even in float32 the AdaGrad step is ill-conditioned where SGD's is not: its
# update lr * g / (sqrt(acc) + 1e-10), acc the sum of squared gradients with
# this step's, has the size of lr whatever the size of g. In about one run of
# three on an H100 one example's gradient differs between card and CPU by a
# fraction of itself: the cache rows apart are then 23 or 24, one per table,
# while two runs on the card agree within 1e-8 (the likeliest source, not
# isolated: a pre-activation within rounding of 0 whose ReLU is open on one
# side and shut on the other; a step has 3.7 million of them). That is a
# difference of 1e-7 after an SGD step, and a fraction of lr after an AdaGrad
# step on a row that only this example touched or a weight with next to no
# history: parameters 1.2e-2 and a cache element 5.1e-3 apart were seen where
# most runs read 4e-8. So of the
# elements that the step moved, all but AG_OUTLIERS must agree within
# AG_BULK_TOL (1% of one step), and every element within the most that two
# AdaGrad steps can lie apart: 2 * lr, times sqrt(D) under the row-wise rule.
# The accumulators, loss and SGD paths stay held to SCORE_TOL
AG_BULK_TOL, AG_OUTLIERS = 1e-4, 1e-2
# Phase 12: two ranks on the one card, a gloo group asked for by name (NCCL
# refuses two ranks on one device). The strict run is short: gloo stages a
# CUDA tensor through the host, and its refill broadcasts the whole cache
DP_WORLD, DP_STRICT_STEPS, DP_EVAL_BATCHES, DP_TIMEOUT_S = 2, 2 * LOOKAHEAD + 1, 2, 800
# Phase 13: multi-host mode as two ranks on the one card (a gloo group asked
# for by name, joined through the coordinator's tcp address), each holding
# its row shard of the masters: MH_WARM_STEPS steps of set-up, then MH_STEPS
# counted steps. The masters' procedural values (parallel/multihost.py): a
# block of MH_BLOCK_ROWS rows drawn from the seed, row i of table t at block
# row (i + t * MH_PHI) % MH_BLOCK_ROWS, scaled by sqrt(1 / rows)
MH_WORLD, MH_WARM_STEPS, MH_STEPS, MH_TIMEOUT_S = 2, TRAIN_WARM_STEPS, 20, 800
MH_BLOCK_ROWS, MH_PHI = 65536, 0x9E3779B1
TIMING_REPS = 25
# each kernel and its plain version are timed in interleaved rounds of
# TIMING_REPS launches, kernel first in even rounds and plain first in odd
TIMING_ROUNDS = 6
# the card spins this many clock cycles (about 10 ms) while the host enqueues
# the TIMING_REPS launches of one reading of time_launches_ms
SLEEP_CYCLES = 20_000_000
# serving scores (probabilities) and one train step's caches, parameters and
# loss on the card vs the CPU: both round the same operands to bf16 and
# accumulate in float32, so they differ by summation order (and, for the
# train step's duplicate slots, by the order of the atomics), and at worst by
# one bf16 rounding step (2^-8 relative) of a value of order 1 that lands on
# the other side of a rounding boundary
SCORE_TOL = 5e-3
# index_add_rows sums duplicate slots with float32 atomics in a run-dependent
# order: each output lies within 1e-5 of the float64 sum of the same float32
# terms at these shapes (values of order 1, at most a few dozen terms per
# row: a few dozen roundings of half an ulp of a value below 8), as
# index_add_'s do
ADD_TOL = 1e-5


def clocks_line() -> str:
    """The card's SM and memory clocks and its power draw as nvidia-smi reads
    them now: beside the kernel times, they tell a slower card from a slower
    kernel."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw", "--format=csv,noheader"],
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


def time_launches_ms(fn, reps: int = TIMING_REPS) -> float:
    """Device time of one call, from one pair of CUDA events around ``reps``
    calls that the host enqueues while the card still spins in a sleep kernel
    ahead of them: the launches then run back to back, and no host work (a
    wrapper's checks, an output's allocation, the enqueue itself) falls
    between the events, as it does with an event before and after each call
    (see the finding printed by check_kernels)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(name: str, card: str, kernel, plain, what: str = "kernel/plain",
              timer=time_ms) -> tuple:
    """A kernel and its plain version (or any two calls) in TIMING_ROUNDS
    interleaved rounds (kernel, plain; plain, kernel; ...), each one reading
    of ``timer``. Prints the per-round ratios; returns the medians of both
    over the rounds."""
    ks, ps = [], []
    for r in range(TIMING_ROUNDS):
        for fn, out in ((kernel, ks), (plain, ps))[:: 1 if r % 2 == 0 else -1]:
            out.append(timer(fn))
    ratios = [k / p for k, p in zip(ks, ps)]
    first, second = what.split("/")
    print(f"[{card}] {name} {what} per round: "
          + ", ".join(f"{r:.3f}" for r in ratios)
          + f"; median {statistics.median(ratios):.3f} (range {min(ratios):.3f}-"
          f"{max(ratios):.3f}); {first} ms {', '.join(f'{k:.4f}' for k in ks)}; {second} ms "
          f"{', '.join(f'{p:.4f}' for p in ps)}")
    return statistics.median(ks), statistics.median(ps)


def add_timer(obj, name: str) -> list:
    """Wrap the method ``obj.name`` so that every call adds its host wall
    time to the one-element list returned."""
    spent, fn = [0.0], getattr(obj, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[0] += time.perf_counter() - t0

    setattr(obj, name, timed)
    return spent


def headline_config(ln_emb=None, **kw):
    """The headline model at full width (bench.py:67-70), finalized; on 26
    tables of 250,000 rows unless ``ln_emb`` gives other row counts."""
    from cdlrm_tpu_torch.config import Config

    base = dict(
        arch_sparse_feature_size=DIM, arch_mlp_bot=BOT_MLP, arch_mlp_top=TOP_MLP,
        mini_batch_size=BATCH, world_size=1, cache_size=CACHE_SETS, num_ways=WAYS,
        loss_function="bce", round_targets=True, compute_dtype="bfloat16",
        master_init="virtual", numpy_rand_seed=SEED,
    )
    base.update(kw)
    if ln_emb is None:
        ln_emb = np.full(TABLES, ROWS, dtype=np.int64)
    return Config(**base).finalize(ln_emb=ln_emb)


HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's device-memory rate (NVIDIA's data sheet)


def bound_ms(nbytes: int) -> float:
    """The least time the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_report(card: str, title: str, err: float, ms: float, plain_ms: float, nbytes: int,
                  library: str, library_ms: float, extra: str = "") -> dict:
    bound = bound_ms(nbytes)
    print(f"[{card}] {title}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s effective, "
          f"{nbytes / 1e6:.1f} MB moved, bound {bound:.4f} ms at 3.35 TB/s: "
          f"{bound / ms:.3f} of it), plain version {plain_ms:.4f} ms, {library} "
          f"{library_ms:.4f} ms (kernel/library {ms / library_ms:.3f}){extra}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=library_ms)


def check_kernels(card: str, rows: int, dev: torch.device) -> dict:
    """Phase 2: every kernel against its plain version at the main path's
    shapes and at edge shapes (bit-exact, or within ADD_TOL of a float64
    reference for the duplicate-slot add); times at the main path's shapes,
    each beside its byte bound, its plain version, the one PyTorch call that
    computes the same, and (the two row copies) a device-to-device copy of
    the same bytes and the kernel launched without its wrapper."""
    from cdlrm_tpu_torch.ops import _build
    from cdlrm_tpu_torch.ops.lookup import (
        gather_rows, gather_rows_ref, index_add_rows, index_add_rows_ref,
    )
    from cdlrm_tpu_torch.ops.scatter import (
        scatter_add_rows, scatter_add_rows_ref, scatter_set_rows, scatter_set_rows_ref,
    )

    lib = _build.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(SEED)
    cache = torch.randn((rows, DIM), generator=g, device=dev)
    report = {}

    def bare_gather(src, slots, out):
        _build.check(lib, lib.cdlrm_gather_rows(src.data_ptr(), slots.data_ptr(), out.data_ptr(),
                                                slots.shape[0], src.shape[1], stream),
                     "gather_rows")

    def bare_set(dst, slots, src, nvalid):
        _build.check(lib, lib.cdlrm_scatter_set_rows(
            dst.data_ptr(), slots.data_ptr(), src.data_ptr(), nvalid.data_ptr(),
            slots.shape[0], dst.shape[1], stream), "scatter_set_rows")

    def others(calls: dict) -> str:
        """Time ``calls`` in TIMING_ROUNDS interleaved rounds; one phrase each."""
        times = {name: [] for name in calls}
        for r in range(TIMING_ROUNDS):
            for name in list(calls)[:: 1 if r % 2 == 0 else -1]:
                times[name].append(time_launches_ms(calls[name]))
        return "".join(f"; {name} {statistics.median(ts):.4f} ms ({min(ts):.4f}-{max(ts):.4f})"
                       for name, ts in times.items())

    # gather: one serving batch's lookups, duplicates included, from the
    # cache (a source far larger than L2) and from a unique-row bucket (the
    # dedup expand: a source that nearly fits L2)
    n = TABLES * BATCH
    slots = torch.randint(0, rows, (n,), generator=g, device=dev, dtype=torch.int32)
    assert int(torch.unique(slots).numel()) < n, "want duplicate slots"
    out, ref = gather_rows(cache, slots), gather_rows_ref(cache, slots)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    assert torch.equal(out, ref), f"gather_rows differs from index_select by {err}"
    rows_u = torch.randn((131_072, DIM), generator=g, device=dev)
    slots_u = torch.randint(0, rows_u.shape[0], (n,), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(gather_rows(rows_u, slots_u), gather_rows_ref(rows_u, slots_u))
    # other widths (float4 rows, the scalar path), row counts that are no
    # multiple of the 32-row tile or of the 8 rows unrolled, a source that is
    # not 16-byte aligned (the scalar path)
    # 32 and 64: the widths of mixed-dimension tables (phase 10)
    for d, count in ((16, 3001), (6, 3001), (DIM, 1), (DIM, 37), (64, 4099), (32, BATCH)):
        c = torch.randn((5000, d), generator=g, device=dev)
        s = torch.randint(0, 5000, (count,), generator=g, device=dev, dtype=torch.int32)
        assert torch.equal(gather_rows(c, s), gather_rows_ref(c, s)), f"gather_rows D={d}"
        off = torch.randn((5000 * d + 1,), generator=g, device=dev)[1:].view(5000, d)
        assert off.data_ptr() % 16 != 0
        assert torch.equal(gather_rows(off, s), gather_rows_ref(off, s)), f"unaligned D={d}"
    gbytes = 2 * n * DIM * 4 + n * 4  # rows read and written once, and the slots
    out = torch.empty((n, DIM), device=dev)
    for title, src, sl in ((f"gather_rows N={n} from [{rows}, {DIM}]", cache, slots),
                           (f"gather_rows N={n} from [{rows_u.shape[0]}, {DIM}] (rows_u)",
                            rows_u, slots_u)):
        ms, plain_ms = time_pair(title, card, lambda: gather_rows(src, sl),
                                 lambda: gather_rows_ref(src, sl), what="kernel/index_select",
                                 timer=time_launches_ms)
        extra = others({"a device-to-device copy_ of the same bytes": lambda: out.copy_(ref),
                        "the kernel without its wrapper": lambda: bare_gather(src, sl, out)})
        entry = kernel_report(card, title, err, ms, plain_ms, gbytes, "index_select", plain_ms,
                              extra)
        report.setdefault("gather_rows", entry)
    # the same launches timed one by one, an event before and after each call:
    # the host's work between the event and the launch (the autograd function,
    # the output's allocation) is inside such a reading
    each, each_plain = time_ms(lambda: gather_rows(cache, slots)), time_ms(
        lambda: gather_rows_ref(cache, slots))
    print(f"[{card}] gather_rows timed call by call: wrapper {each:.4f} ms, index_select "
          f"{each_plain:.4f} ms (ratio {each / each_plain:.3f}); in batches of {TIMING_REPS} "
          f"launches {report['gather_rows']['ms']:.4f} and {report['gather_rows']['plain_ms']:.4f}")

    # row set: a refill-sized bucket, valid prefix ~100k, trash-padded tail
    def set_case(c0, u, nv, distinct_all=False):
        r = c0.shape[0]
        s = torch.full((u,), r - 1, dtype=torch.int32, device=dev)
        k = u if distinct_all else nv
        s[:k] = torch.randperm(r - 1, generator=g, device=dev)[:k].to(torch.int32)
        rows_in = torch.randn((u, c0.shape[1]), generator=g, device=dev)
        nv_dev = torch.tensor(nv, dtype=torch.int64, device=dev)
        got = scatter_set_rows(c0.clone(), s, rows_in, nv_dev)
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
    for case in ((small, 4096, 3000), (small, 4096, 4096, True), (small, 999, 0),
                 (small, 999, 37), (small, 1, 1)):
        err_set = max(err_set, set_case(*case)[2])
    err_set = max(err_set, set_case(torch.randn((3000, 6), generator=g, device=dev), 512, 300)[2])
    # a destination that is not 16-byte aligned (the scalar path), in place
    unaligned = torch.randn((3000 * DIM + 1,), generator=g, device=dev)[1:].view(3000, DIM)
    assert unaligned.data_ptr() % 16 != 0
    s_un = torch.randperm(3000, generator=g, device=dev)[:512].to(torch.int32)
    r_un = torch.randn((512, DIM), generator=g, device=dev)
    want = scatter_set_rows_ref(unaligned.clone(), s_un, r_un, 300)
    got = scatter_set_rows(unaligned, s_un, r_un, torch.tensor(300, dtype=torch.int64, device=dev))
    assert torch.equal(got, want), "scatter_set_rows into an unaligned destination"
    nv_dev = torch.tensor(nv, dtype=torch.int64, device=dev)
    idx_main = s_main[:nv].long()
    title = f"scatter_set_rows U={u} nvalid={nv} into [{rows}, {DIM}]"
    ms, lib_ms = time_pair(
        title, card, lambda: scatter_set_rows(cache, s_main, rows_main, nv_dev),
        lambda: cache.index_copy_(0, idx_main, rows_main[:nv]), what="kernel/index_copy_",
        timer=time_launches_ms)
    plain_ms = time_launches_ms(lambda: scatter_set_rows_ref(cache, s_main, rows_main, nv))
    staged = torch.empty((nv, DIM), device=dev)
    extra = others({"a device-to-device copy_ of the same bytes":
                    lambda: staged.copy_(rows_main[:nv]),
                    "the kernel without its wrapper":
                    lambda: bare_set(cache, s_main, rows_main, nv_dev)})
    report["scatter_set_rows"] = kernel_report(
        card, title, err_set, ms, plain_ms, 2 * nv * DIM * 4 + nv * 4, "index_copy_", lib_ms,
        extra)
    del staged, rows_u, out

    # row add: the dedup wire's unique-row update, a distinct valid prefix
    # (position 0 included) and a trash-padded tail that must stay untouched
    def add_case(c0, u, nv, distinct_all=False):
        r = c0.shape[0]
        s = torch.full((u,), r - 1, dtype=torch.int32, device=dev)
        k = u if distinct_all else nv
        s[:k] = torch.randperm(r - 1, generator=g, device=dev)[:k].to(torch.int32)
        delta = torch.randn((u, c0.shape[1]), generator=g, device=dev)
        got = scatter_add_rows(c0.clone(), s, delta,
                               torch.tensor(nv, dtype=torch.int64, device=dev))
        want = scatter_add_rows_ref(c0.clone(), s, delta, nv)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        assert torch.equal(got, want), f"scatter_add_rows u={u} nv={nv} differs by {e}"
        assert torch.equal(got[r - 1], c0[r - 1]), "trash row written"
        if nv < u and not distinct_all:
            assert torch.equal(got[s[nv:].long()], c0[s[nv:].long()]), "row past nvalid written"
        return s, delta, e

    s_add, delta_add, err_add = add_case(cache, u, nv)
    for case in ((cache, u, 0), (cache, u, u, True), (cache, 100_003, 77_777)):
        err_add = max(err_add, add_case(*case)[2])
    for case in ((small, 4096, 3000), (small, 4096, 4096, True), (small, 999, 0)):
        err_add = max(err_add, add_case(*case)[2])
    err_add = max(err_add, add_case(torch.randn((3000, 6), generator=g, device=dev), 512, 300)[2])
    idx_add = s_add[:nv].long()
    title = f"scatter_add_rows U={u} nvalid={nv} into [{rows}, {DIM}]"
    ms, lib_ms = time_pair(
        title, card, lambda: scatter_add_rows(cache, s_add, delta_add, nv_dev),
        lambda: cache.index_add_(0, idx_add, delta_add[:nv]), what="kernel/index_add_",
        timer=time_launches_ms)
    plain_ms = time_launches_ms(lambda: scatter_add_rows_ref(cache, s_add, delta_add, nv))
    report["scatter_add_rows"] = kernel_report(
        card, title, err_add, ms, plain_ms, 3 * nv * DIM * 4 + nv * 4, "index_add_", lib_ms)
    print("kernels: gather_rows, scatter_set_rows, scatter_add_rows bit-exact against "
          "their plain versions")

    # duplicate-slot add: one train step's lookups (the plain wire's sparse
    # update, alpha = -lr_embeds; the gather backward, alpha = 1), slots drawn
    # from a 60,000-row range so that most rows repeat
    lr_emb = -float(np.float32(0.3))

    def dup_case(c0, nn, hi, alpha):
        s = torch.randint(0, hi, (nn,), generator=g, device=dev, dtype=torch.int32)
        src = torch.randn((nn, c0.shape[1]), generator=g, device=dev)
        got = index_add_rows(c0.clone(), s, src, alpha)
        plain = index_add_rows_ref(c0.clone(), s, src, alpha)
        want = c0.double().index_add_(0, s.long(), (src * alpha).double())
        torch.cuda.synchronize()
        e = float((got.double() - want).abs().max())
        e_plain = float((plain.double() - want).abs().max())
        assert e <= ADD_TOL, f"index_add_rows n={nn} D={c0.shape[1]} off by {e}"
        assert e_plain <= ADD_TOL, f"index_add_ itself off by {e_plain}"
        return s, src, e, e_plain

    # a fresh cache: the timings above have grown the rows they touched
    fresh = torch.randn((rows, DIM), generator=g, device=dev)
    s_dup, src_dup, err_dup, err_plain = dup_case(fresh, n, 60_000, lr_emb)
    del fresh
    for c0, nn, hi, alpha in ((torch.zeros((131_072, DIM), device=dev), n, 60_000, 1.0),
                              (small, 4096, 2000, lr_emb),
                              # a mixed-dimension table's gradient (phase 10)
                              (torch.zeros((ROWS, 32), device=dev), BATCH, ROWS, 1.0),
                              (torch.zeros((20_000, 64), device=dev), BATCH, 20_000, 1.0),
                              (torch.randn((3000, 6), generator=g, device=dev), 2048, 300, 1.0)):
        e, ep = dup_case(c0, nn, hi, alpha)[2:]
        err_dup, err_plain = max(err_dup, e), max(err_plain, ep)
    idx_dup = s_dup.long()
    distinct = int(torch.unique(s_dup).numel())
    title = f"index_add_rows N={n} (slots < 60,000, {distinct} distinct) into [{rows}, {DIM}]"
    ms, lib_ms = time_pair(
        title, card, lambda: index_add_rows(cache, s_dup, src_dup, lr_emb),
        lambda: cache.index_add_(0, idx_dup, src_dup, alpha=lr_emb),
        what="kernel/index_add_(alpha)", timer=time_launches_ms)
    plain_ms = time_launches_ms(lambda: index_add_rows_ref(cache, s_dup, src_dup, lr_emb))
    # every source row read once; each distinct row read and written once
    report["index_add_rows"] = kernel_report(
        card, title, err_dup, ms, plain_ms, n * DIM * 4 + n * 4 + 2 * distinct * DIM * 4,
        "index_add_ with alpha", lib_ms,
        f"; max |error| vs float64 {err_dup:.3e} (index_add_ {err_plain:.3e}, tolerance "
        f"{ADD_TOL})")
    print(f"[{card}] clocks right after the timed rounds (SM, memory, power draw): "
          f"{clocks_line()}")
    return report


def serve(card: str, dev: torch.device) -> dict:
    """Phase 3: the cached serving path at the headline model's full width."""
    from cdlrm_tpu_torch.data.synthetic import SyntheticDataset
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer, TrainMetrics

    cfg = headline_config(inference_only=True)
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
        reset_launches()
        t0 = time.perf_counter()
        evicted = tr.refill(plan)
        torch.cuda.synchronize()
        print(f"[{card}] warm-up refill: {plan.insert_slots.size} rows inserted, "
              f"{evicted.shape[0]} evicted, {time.perf_counter() - t0:.3f} s host wall; "
              f"kernel launches of one refill {read_launches()}")
        tr.evaluate(max_batches=2, log_fn=lambda *_: None)  # first-call set-up
        tr.metrics = TrainMetrics()

        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, auc = tr.evaluate(max_batches=SERVE_BATCHES)
        wall = time.perf_counter() - t0
        launches = read_launches()
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
        params_cpu = _cpu_copy(tr.params)
        reset_launches()
        _, s_dev = tr.eval_step(tr.params, tr.cache, *inputs)
        print(f"kernel launches of one eval step {read_launches()}")
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
    """Phase 4: the port's CLI at a small size on the card: serving; then
    training runs, each evaluating after it: the default flags, coalesced
    scan blocks on the unpacked dedup wire (forced on: the random stream is
    near-unique, so 'auto' would take the plain wire), and the full-table
    trainer; then AdaGrad on the dedup wire: a training run that saves a
    checkpoint, serving from it, and training resumed from it; then the
    variants: the bfloat16 row wire and the float8 dense wire under the
    profiler (the trace file must be there), cached mixed-dimension tables,
    and the full-table trainer with QR and with MD tables."""
    common = [
        sys.executable, "-m", "cdlrm_tpu_torch.cli", "--device", dev.type,
        "--data-generation", "random",
        "--arch-embedding-size", "1000-500-2000", "--arch-sparse-feature-size", "16",
        "--arch-mlp-bot", "13-32-16", "--arch-mlp-top", "16-8-1",
        "--mini-batch-size", "64", "--num-batches", "10", "--cache-size", "128",
        "--num-ways", "4", "--loss-function", "bce", "--round-targets",
    ]
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        adagrad = ["--optimizer", "adagrad", "--dedup-lookups", "on", "--learning-rate", "0.05",
                   "--lr-embeds", "0.05", "--lookahead", "2", "--print-freq", "5"]
        trace = os.path.join(tmp, "trace")
        cached = ["--lookahead", "2", "--print-freq", "5"]
        for extra, want in ((["--inference-only"], "Test accuracy"),
                            (["--lookahead", "2", "--print-freq", "5"], "Step 10:"),
                            (["--scan-steps", "4", "--no-pack-wire", "--dedup-lookups", "on",
                              "--lookahead", "8", "--print-freq", "5"], "Step 10:"),
                            (["--no-use-cache", "--print-freq", "5"], "Epoch 0: 5/"),
                            (adagrad + ["--save-model", ck], "Step 10:"),
                            (adagrad + ["--load-model", ck, "--inference-only"], "Test accuracy"),
                            (adagrad + ["--load-model", ck, "--num-batches", "20"], "Step 20:"),
                            (cached + ["--wire-rows-bf16", "--wire-x-fp8", "--dedup-lookups",
                                       "on", "--enable-profiling", "--profile-dir", trace],
                             "Step 10:"),
                            (cached + ["--md-flag", "--master-init", "virtual"], "Step 10:"),
                            (["--no-use-cache", "--qr-flag", "--qr-threshold", "600",
                              "--print-freq", "5"], "Epoch 0: 5/"),
                            (["--no-use-cache", "--md-flag", "--md-threshold", "600",
                              "--print-freq", "5"], "Epoch 0: 5/")):
            res = subprocess.run(common + extra, cwd=REPO, capture_output=True, text=True,
                                 timeout=300)
            if (res.returncode != 0 or want not in res.stdout
                    or "Test accuracy" not in res.stdout):
                raise RuntimeError(f"CLI failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
            if "--save-model" in extra:
                assert os.path.exists(os.path.join(ck, "embed_acc.npy")), "no checkpoint saved"
            if "--enable-profiling" in extra:
                assert os.path.getsize(os.path.join(trace, "trace.json")) > 0, "no trace"
            print("cli:", " | ".join(res.stdout.strip().splitlines()[-2:]))


def uniform_stream(cfg, num_batches: int, seed: int):
    """Uniform ids over every table's rows, single-index bags."""
    from cdlrm_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(
        m_den=13, ln_emb=cfg.ln_emb, data_size=BATCH * num_batches, mini_batch_size=BATCH,
        num_indices_per_lookup=1, num_indices_per_lookup_fixed=True, round_targets=True,
        seed=seed,
    )


def counted_train(tr, on_reset=None) -> dict:
    """TRAIN_WARM_STEPS steps of set-up, then TRAIN_STEPS counted steps of
    the main path, with every launch count reset just before them (and
    ``on_reset`` called there); the eviction writeback flushed after. Returns
    the counted steps' numbers, launch counts and the run's summary line."""
    t0 = time.perf_counter()
    m = tr.train(max_steps=TRAIN_WARM_STEPS)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counters = ("loss_sum", "correct", "examples", "hits", "lookups", "refills",
                "caching_overhead_s")
    before = [getattr(m, c) for c in counters]
    reset_launches()
    if on_reset is not None:
        on_reset()
    t0 = time.perf_counter()
    tr.train(max_steps=TRAIN_WARM_STEPS + TRAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    out = dict(zip(counters, (getattr(m, c) - was for c, was in zip(counters, before))))
    t0 = time.perf_counter()
    assert tr.eviction_manager.flush(timeout=120), "eviction writeback stalled"
    drain = time.perf_counter() - t0
    assert tr.global_step == TRAIN_WARM_STEPS + TRAIN_STEPS
    written = tr.eviction_manager.rows_written
    loss = out["loss_sum"] / out["examples"]
    line = (f"{TRAIN_STEPS} steps of {BATCH} in {wall:.3f} s host wall, "
            f"{TRAIN_STEPS * BATCH / wall:.1f} examples/s ({1000 * wall / TRAIN_STEPS:.2f} "
            f"ms/step incl. {out['refills']} refills that held the train thread "
            f"{out['caching_overhead_s']:.3f} s in all; set-up {warm:.2f} s for "
            f"{TRAIN_WARM_STEPS} steps); loss {loss:.6f}, acc "
            f"{out['correct'] / out['examples']:.6f}, train hit rate "
            f"{out['hits'] / out['lookups']:.6f}, dedup wire {tr._dedup}, eviction rows "
            f"written {written} (the backlog drained {drain:.3f} s after the counted steps), "
            f"kernel launches {launches}")
    assert np.isfinite(loss), loss
    assert out["refills"] > 0, "no refill in the counted steps"
    out.update(wall=wall, launches=launches, written=written, line=line)
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def count_link_bytes(tr) -> dict:
    """Count what ``tr`` puts on the host-device link, from the sizes of the
    tensors it stages: each batch's step inputs (the all-False mask of
    single-index batches is a device constant and crosses nothing), each
    window's refill operands, and the evicted rows and state that leave the
    device."""
    seen = {"step_bytes": 0, "steps": 0, "window_bytes": 0, "windows": 0, "evict_bytes": 0}
    stage, refill_inputs, deferred = tr._stage_batch, tr._refill_device_inputs, tr._deferred_host

    def stage_batch(batch, wire, aux, train):
        out = stage(batch, wire, aux, train)
        seen["step_bytes"] += _nbytes(t for i, t in enumerate(out)
                                      if i != 2 or batch.ls_mask is not None)
        seen["steps"] += 1
        return out

    def refill_device_inputs(plan, stage_acc=True):
        ops = refill_inputs(plan, stage_acc=stage_acc)
        seen["window_bytes"] += _nbytes(ops)
        seen["windows"] += 1
        return ops

    def deferred_host(rows):
        seen["evict_bytes"] += _nbytes([rows])
        return deferred(rows)

    tr._stage_batch, tr._refill_device_inputs, tr._deferred_host = (
        stage_batch, refill_device_inputs, deferred_host)
    return seen


def train_run(card: str, dev: torch.device, dedup_lookups: str, label: str = "",
              ln_emb=None, check=None, **cfg_kw) -> dict:
    """One training run of the headline model at full width: TRAIN_WARM_STEPS
    steps of set-up, then TRAIN_STEPS counted steps of the main path, with
    every launch count reset just before them. Then one train step on the
    card against the same inputs through the port on the CPU. ``cfg_kw``
    adds config fields (the wire and model variants), ``ln_emb`` other table
    sizes, and ``check(tr)`` runs on the trained trainer before it closes.
    Returns the run's numbers, launch counts and link bytes."""
    from cdlrm_tpu_torch.models.dlrm import param_leaves
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    cfg = headline_config(ln_emb, lookahead=LOOKAHEAD, print_freq=1 << 30,
                          dedup_lookups=dedup_lookups, **cfg_kw)
    train_ds = uniform_stream(cfg, TRAIN_WARM_STEPS + TRAIN_STEPS + 2, SEED + 2)
    tr = CachedDlrmTrainer(cfg, train_ds, train_ds, device=dev)
    link = count_link_bytes(tr)
    try:
        run = counted_train(tr)
        if check is not None:
            check(tr)
    finally:
        tr.close()
    launches = run["launches"]
    per_step = link["step_bytes"] / max(1, link["steps"])
    per_window = link["window_bytes"] / max(1, link["windows"])
    print(f"[{card}] train {label}dedup_lookups={dedup_lookups}: {run['line']}; host-to-device "
          f"bytes staged: {per_step:.0f} a step (mean of {link['steps']} batches), "
          f"{per_window:.0f} a window (mean of {link['windows']} refills; {LOOKAHEAD} steps a "
          f"window); device-to-host evicted rows and state {link['evict_bytes']} bytes in all")

    # the step alone, on the last trained batch (resident ids; the pipeline
    # threads are stopped): the card against the CPU from the same cache and
    # parameters, the device time by events over repeated steps, and the
    # host's probe and its probe + staging of the batch
    batch = list(itertools.islice(train_ds.batches(), TRAIN_WARM_STEPS + TRAIN_STEPS))[-1]
    probe = (functools.partial(tr.controller.probe_dedup, inv_bits=tr._inv_bits)
             if tr._dedup else tr._probe_fn)
    probe_ms, host_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        tr._probe(batch, probe)
        probe_ms.append(1000 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        inputs, _, dedup, _ = tr._assemble(batch, BATCH)
        host_ms.append(1000 * (time.perf_counter() - t0))
    step = tr._get_step(1, dedup)
    params_cpu = _cpu_copy(tr.params)
    cache_cpu = tr.cache.to("cpu", copy=True)
    reset_launches()
    p_dev, c_dev, l_dev, _ = step(tr.params, tr.cache, *inputs, tr._lr, tr._lr_emb)
    step_launches = read_launches()
    p_cpu, c_cpu, l_cpu, _ = step(params_cpu, cache_cpu, *[x.cpu() for x in inputs],
                                  tr._lr, tr._lr_emb)
    assert bool(torch.isfinite(c_dev).all()), "non-finite cache after the step"
    cache_err = float((c_dev.cpu() - c_cpu).abs().max())
    param_err = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(param_leaves(p_dev), param_leaves(p_cpu)))
    loss_err = abs(float(l_dev) - float(l_cpu)) / BATCH
    del c_cpu, cache_cpu
    assert max(cache_err, param_err, loss_err) <= SCORE_TOL, (cache_err, param_err, loss_err)
    step_ms = time_ms(lambda: step(tr.params, tr.cache, *inputs, tr._lr, tr._lr_emb), 10)
    print(f"  one step vs the CPU run ({'dedup' if dedup else 'plain'} wire): max |cache "
          f"difference| {cache_err:.3e}, |param difference| {param_err:.3e}, |loss "
          f"difference| {loss_err:.3e} (tolerance {SCORE_TOL}); device step {step_ms:.3f} ms "
          f"by events; host probe {statistics.median(probe_ms):.3f} ms, probe + staging "
          f"{statistics.median(host_ms):.3f} ms; kernel launches of the one step {step_launches}")
    return dict(launches=launches, examples_s=TRAIN_STEPS * BATCH / run["wall"],
                step_bytes=per_step, window_bytes=per_window, evict_bytes=link["evict_bytes"])


class LogUniformStream:
    """bench.py's default id stream (bench.py:180-199), rebuilt here with
    numpy because bench.py imports jax: per table ``idx = exp(u * ln ROWS) -
    1`` with u uniform in [0, 1), so head ids repeat (about 0.57 N distinct
    ids in a batch of N lookups at the headline width), a Criteo-like skew."""

    m_den = 13

    def __init__(self, num_batches: int, seed: int, ln_emb=None):
        self.ln_emb = np.full(TABLES, ROWS, dtype=np.int64) if ln_emb is None else ln_emb
        self.num_batches, self.seed = num_batches, seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        from cdlrm_tpu_torch.data.synthetic import Batch

        rng = np.random.Generator(np.random.SFC64(self.seed))
        for _ in range(self.num_batches):
            x = rng.random((BATCH, 13), dtype=np.float32)
            u = rng.random((TABLES, BATCH), dtype=np.float32)
            idx = np.exp(u * np.log(self.ln_emb)[:, None]).astype(np.int64) - 1
            np.minimum(idx, self.ln_emb[:, None] - 1, out=idx)
            y = np.round(rng.random((BATCH, 1), dtype=np.float32))
            yield Batch(x, idx, None, y)


def _cpu_copy(params) -> dict:
    from cdlrm_tpu_torch.models.dlrm import map_params

    return map_params(lambda t: t.to("cpu", copy=True), params)


def _max_param_err(p_dev, p_cpu) -> float:
    from cdlrm_tpu_torch.models.dlrm import param_leaves

    return max(float((a.cpu() - b).abs().max())
               for a, b in zip(param_leaves(p_dev), param_leaves(p_cpu)))


def _adagrad_errs(triples, step_bound: float) -> tuple:
    """``triples``: (card result, CPU result, CPU value before the step) of
    each tensor an AdaGrad step updated. Asserts the rule in the note at
    AG_LR; returns max |card - CPU|, the number of elements the step moved
    and how many of them lie more than AG_BULK_TOL apart."""
    worst, moved, off = 0.0, 0, 0
    chunk = 1 << 20  # rows at a time: the full tables are 3.33 GB
    for dev_t, cpu_t, old_t in triples:
        for i in range(0, cpu_t.shape[0], chunk):
            diff = (dev_t[i: i + chunk].cpu() - cpu_t[i: i + chunk]).abs()
            worst = max(worst, float(diff.max()))
            moved += int((cpu_t[i: i + chunk] != old_t[i: i + chunk]).sum())
            off += int((diff > AG_BULK_TOL).sum())
    assert worst <= step_bound, (worst, step_bound)
    assert moved > 0 and off <= AG_OUTLIERS * moved, (off, moved)
    return worst, moved, off


def _max_row_err(dev_rows: torch.Tensor, cpu_rows: torch.Tensor, chunk: int = 1 << 20) -> float:
    """max |dev - cpu| over two [R, D] tensors, a chunk of rows at a time
    (the full tables are 3.33 GB)."""
    return max(float((dev_rows[i: i + chunk].cpu() - cpu_rows[i: i + chunk]).abs().max())
               for i in range(0, cpu_rows.shape[0], chunk))


def check_block(card: str, tr, ds, total: int) -> dict:
    """One coalesced block of CHECK_BLOCK steps over the last trained
    batches (resident ids; the pipeline threads are stopped): the card
    against the port on the CPU from the same cache and parameters; then the
    block's device time by CUDA events, beside the same steps without
    coalescing."""
    batches = list(itertools.islice(ds.batches(), total))[-CHECK_BLOCK:]
    items = [tr._assemble(b, BATCH) for b in batches]
    assert all(dedup and binfo is not None for _, _, dedup, binfo in items), "not coalescable"
    ranks, blk_slots, blk_counts = tr._build_block_union([it[3] for it in items])
    args = tr.interleave_block_inputs([it[0] for it in items], ranks) + [blk_slots, blk_counts]
    step = tr._get_step(CHECK_BLOCK, True, True)
    params_cpu, cache_cpu = _cpu_copy(tr.params), tr.cache.to("cpu", copy=True)
    reset_launches()
    p_dev, c_dev, l_dev, _ = step(tr.params, tr.cache, *args, tr._lr, tr._lr_emb)
    block_launches = read_launches()
    p_cpu, c_cpu, l_cpu, _ = step(params_cpu, cache_cpu, *[a.cpu() for a in args],
                                  tr._lr, tr._lr_emb)
    assert l_dev.shape == (CHECK_BLOCK,) and bool(torch.isfinite(c_dev).all())
    cache_err = _max_row_err(c_dev, c_cpu)
    param_err = _max_param_err(p_dev, p_cpu)
    loss_err = float((l_dev.cpu() - l_cpu).abs().max()) / BATCH
    del c_cpu, cache_cpu
    assert max(cache_err, param_err, loss_err) <= SCORE_TOL, (cache_err, param_err, loss_err)
    block_ms = time_ms(lambda: step(tr.params, tr.cache, *args, tr._lr, tr._lr_emb), 10)
    plain_args = [a for it in items for a in it[0]]
    per_step = tr._get_step(CHECK_BLOCK, True, False)
    per_step_ms = time_ms(lambda: per_step(tr.params, tr.cache, *plain_args, tr._lr, tr._lr_emb), 10)
    union = int(blk_counts[0])
    print(f"  one coalesced block of {CHECK_BLOCK} steps ({union} union rows) vs the CPU run: "
          f"max |cache difference| {cache_err:.3e}, |param difference| {param_err:.3e}, "
          f"|loss difference| {loss_err:.3e} (tolerance {SCORE_TOL}); device time "
          f"{block_ms:.3f} ms by events, the same {CHECK_BLOCK} steps without coalescing "
          f"{per_step_ms:.3f} ms; kernel launches of the one block of {CHECK_BLOCK} steps "
          f"{block_launches}")
    return dict(block_ms=block_ms, per_step_ms=per_step_ms)


def block_run(card: str, dev: torch.device, coalesce: str, label: str = "", check=None,
              **cfg_kw) -> dict:
    """One training run with bench.py's flags (scan blocks, unpacked wires,
    auto-dedup, lookahead 20) on its loguniform stream: BLOCK_WARM_STEPS
    steps of set-up, then BLOCK_STEPS counted steps with every launch count
    reset just before them. The lookahead and the step counts are multiples
    of SCAN_STEPS and no cadence falls inside, so every counted block is a
    full one. With the block-coalesced update, check_block follows, then
    ``check(tr, ds, total)`` where given. ``cfg_kw`` adds config fields
    (phase 14's hot tier and sorted wire) and ``label`` names the run
    (by default (c) coalesced, (d) not). The counted run's windows are
    recorded: the hot rows selected, the worst cold count and the cold
    bucket adopted."""
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    cfg = headline_config(
        scan_steps=SCAN_STEPS, pack_wire=False, dedup_lookups="auto",
        block_coalesced_update=coalesce, lookahead=BLOCK_LOOKAHEAD, print_freq=1 << 30,
        **cfg_kw,
    )
    total = BLOCK_WARM_STEPS + BLOCK_STEPS
    ds = LogUniformStream(total + BLOCK_LOOKAHEAD, seed=SEED + 3)
    tr = CachedDlrmTrainer(cfg, ds, device=dev)
    blocks, windows = [], []
    get_step, apply_stats = tr._get_step, tr._apply_window_stats

    def recording_get_step(size, dedup, coalesced=False):
        blocks.append((size, dedup, coalesced))
        return get_step(size, dedup, coalesced)

    def recording_stats(window):
        apply_stats(window)
        windows.append((0 if window.hot_slots is None else int(window.hot_slots.size),
                        window.stats.worst_cold, tr._cold_bucket_window))

    tr._get_step, tr._apply_window_stats = recording_get_step, recording_stats
    try:
        t0 = time.perf_counter()
        m = tr.train(max_steps=BLOCK_WARM_STEPS)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        counters = ("loss_sum", "correct", "examples", "hits", "lookups", "refills",
                    "caching_overhead_s")
        before = [getattr(m, c) for c in counters]
        blocks.clear()
        windows.clear()
        reset_launches()
        t0 = time.perf_counter()
        tr.train(max_steps=total)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        counted = list(blocks)
        loss_sum, correct, examples, hits, lookups, refills, refill_s = (
            getattr(m, c) - was for c, was in zip(counters, before)
        )
        assert tr.global_step == total
        wire = tr._dedup
    finally:
        tr.close()
    coalesced = bool(cfg.block_coalesced_update)
    run = label or ("c" if coalesced else "d")
    loss, hit = loss_sum / examples, hits / lookups
    flags = "".join(f", {k}={v}" for k, v in cfg_kw.items())
    print(f"[{card}] train ({run}) scan_steps={SCAN_STEPS}, unpacked wires, "
          f"block_coalesced_update={coalesce}{flags}: {BLOCK_STEPS} steps of {BATCH} in "
          f"{wall:.3f} s "
          f"host wall, {BLOCK_STEPS * BATCH / wall:.1f} examples/s "
          f"({1000 * wall / BLOCK_STEPS:.2f} ms/step incl. {refills} refills that held the "
          f"train thread {refill_s:.3f} s in all; set-up {warm:.2f} s for {BLOCK_WARM_STEPS} "
          f"steps); loss {loss:.6f}, acc {correct / examples:.6f}, train hit rate {hit:.6f}, "
          f"dedup wire {wire}, blocks (size, dedup, coalesced) {counted}, kernel launches "
          f"{launches}")
    assert np.isfinite(loss), loss
    assert refills > 0, "no refill in the counted steps"
    assert wire, "the loguniform stream should take the dedup wire"
    n_blocks = BLOCK_STEPS // SCAN_STEPS
    assert counted == [(SCAN_STEPS, True, coalesced)] * n_blocks, counted
    out = dict(launches=launches, blocks=n_blocks, examples_s=BLOCK_STEPS * BATCH / wall,
               windows=windows)
    if coalesced:
        out.update(check_block(card, tr, ds, total))
    if check is not None:
        out.update(check(card, tr, ds, total))
    return out


def train(card: str, dev: torch.device) -> dict:
    """Phase 5: cached training at full width in four runs: (a) the default
    flags, where auto-dedup picks the plain wire (uniform ids: unique lookups
    are nearly all lookups), (b) the packed dedup wire, and with bench.py's
    flags on the loguniform stream (c) the block-coalesced update and (d)
    the per-step update."""
    runs = {"a": train_run(card, dev, "auto"), "b": train_run(card, dev, "on"),
            "c": block_run(card, dev, "auto"), "d": block_run(card, dev, "off")}
    la, lb, lc, ld = (runs[k]["launches"] for k in "abcd")
    assert la["index_add_rows"] > 0 and la["scatter_add_rows"] == 0, la
    assert lb["scatter_add_rows"] > 0 and lb["index_add_rows"] > 0, lb
    # (c): one flush per coalesced block, one pending add per step; (d): one
    # unique-row add per step
    assert lc["scatter_add_rows"] == runs["c"]["blocks"], lc
    assert lc["index_add_rows"] == BLOCK_STEPS, lc
    assert ld["scatter_add_rows"] == BLOCK_STEPS, ld
    for launches in (la, lb, lc, ld):
        assert launches["gather_rows"] > 0 and launches["scatter_set_rows"] > 0, launches
    return runs


def fulltable(card: str, dev: torch.device) -> dict:
    """Phase 6: full-table training at full width, the 26 tables (3.33 GB of
    float32) on the card: FT_STEPS steps on the loguniform stream, then
    FT_EVAL_BATCHES eval batches, with every launch count reset just before;
    then one step on the card against the port on the CPU, and its device
    time."""
    from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

    cfg = headline_config(use_cache=False, print_freq=1 << 30)
    ds = LogUniformStream(FT_STEPS + 1, seed=SEED + 5)
    test_ds = LogUniformStream(FT_EVAL_BATCHES, seed=SEED + 6)
    t0 = time.perf_counter()
    tr = FullTableDlrmTrainer(cfg, ds, test_ds, device=dev)
    torch.cuda.synchronize()
    print(f"[{card}] full-table trainer built in {time.perf_counter() - t0:.2f} s: tables "
          f"{tuple(tr.tables.shape)} float32 ({tr.tables.numel() * 4 / 1e9:.3f} GB) on {dev}")
    reset_launches()
    t0 = time.perf_counter()
    tr.train(max_steps=FT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc, auc = tr.evaluate(max_batches=FT_EVAL_BATCHES)
    launches = read_launches()
    print(f"[{card}] full-table train: {FT_STEPS} steps of {BATCH} in {wall:.3f} s host wall, "
          f"{FT_STEPS * BATCH / wall:.1f} examples/s ({1000 * wall / FT_STEPS:.2f} ms/step, "
          f"first step included); eval of {FT_EVAL_BATCHES} batches: accuracy {acc:.6f} AUC "
          f"{auc:.6f}; kernel launches {launches}")
    assert tr.global_step == FT_STEPS and np.isfinite(acc) and np.isfinite(auc), (acc, auc)
    assert launches == {"gather_rows": 2 * FT_STEPS + FT_EVAL_BATCHES, "scatter_set_rows": 0,
                        "scatter_add_rows": FT_STEPS, "index_add_rows": FT_STEPS}, launches

    batch = list(itertools.islice(ds.batches(), FT_STEPS + 1))[-1]
    x, ls_i, mask, tgt = tr._put(batch)
    params_cpu, tables_cpu = _cpu_copy(tr.params), tr.tables.to("cpu", copy=True)
    p_dev, t_dev, l_dev, _ = tr.train_step(tr.params, tr.tables, tr._offsets, x, ls_i, mask,
                                           tgt, tr._lr, tr._lr_emb)
    p_cpu, t_cpu, l_cpu, _ = tr.train_step(params_cpu, tables_cpu, tr._offsets.cpu(), x.cpu(),
                                           ls_i.cpu(), mask.cpu(), tgt.cpu(), tr._lr, tr._lr_emb)
    assert bool(torch.isfinite(l_dev)), "non-finite loss"
    table_err = _max_row_err(t_dev, t_cpu)
    param_err = _max_param_err(p_dev, p_cpu)
    loss_err = abs(float(l_dev) - float(l_cpu)) / BATCH
    del t_cpu, tables_cpu
    assert max(table_err, param_err, loss_err) <= SCORE_TOL, (table_err, param_err, loss_err)
    step_ms = time_ms(lambda: tr.train_step(tr.params, tr.tables, tr._offsets, x, ls_i, mask,
                                            tgt, tr._lr, tr._lr_emb), 10)
    print(f"  one full-table step vs the CPU run: max |table difference| {table_err:.3e}, "
          f"|param difference| {param_err:.3e}, |loss difference| {loss_err:.3e} (tolerance "
          f"{SCORE_TOL}); step {step_ms:.3f} ms by events (torch.unique waits for the "
          f"device inside it)")
    del tr, t_dev
    torch.cuda.empty_cache()
    return dict(launches=launches)


def _state_leaves(tree) -> list:
    from cdlrm_tpu_torch.models.dlrm import param_leaves

    return param_leaves(tree)


def _equal_leaves(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(_state_leaves(a), _state_leaves(b)))


def _equal_rows(a: torch.Tensor, b: torch.Tensor, chunk: int = 1 << 20) -> bool:
    """Bit-equality of two row tensors, a chunk of rows at a time."""
    return a.shape == b.shape and all(
        torch.equal(a[i: i + chunk].to(b.device), b[i: i + chunk])
        for i in range(0, b.shape[0], chunk))


def checkpoint_round_trip(card: str, tr, cfg, ds, dev: torch.device) -> dict:
    """Save ``tr`` (run (e)) with checkpoint_async into a temporary
    directory, timing how long the train thread is held and how long the
    writer takes; load it into a fresh trainer and hold the cache,
    ``embed_acc``, parameters, ``dense_acc``, the store's accumulators and
    the occupancy bit-equal; then train the loaded trainer on."""
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    assert cfg.checkpoint_async
    master_s = add_timer(tr.master, "save")
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        tr.save_checkpoint(ck)
        held = time.perf_counter() - t0
        writing = tr._ckpt_writer.thread is not None
        tr._ckpt_writer.join()
        write_s = tr._ckpt_writer.write_s
        size = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        master_gb = os.path.getsize(os.path.join(ck, "master.npz")) / 1e9
        ld = CachedDlrmTrainer(cfg, ds, device=dev)
        try:
            t0 = time.perf_counter()
            ld.load_checkpoint(ck)
            load_s = time.perf_counter() - t0
            equal = {
                "cache": _equal_rows(ld.cache, tr.cache),
                "embed_acc": torch.equal(ld.embed_acc, tr.embed_acc),
                "params": _equal_leaves(ld.params, tr.params),
                "dense_acc": _equal_leaves(ld.dense_acc, tr.dense_acc),
                "store": all(np.array_equal(a, b) for a, b in
                             zip(ld._acc_master.accs, tr._acc_master.accs)),
                "occupancy": all(np.array_equal(a, b) for a, b in
                                 zip(ld.controller.occupancy, tr.controller.occupancy)),
                "step": ld.global_step == tr.global_step,
            }
            assert all(equal.values()), equal
            step0 = ld.global_step
            ld.train(max_steps=step0 + AG_RESUME_STEPS, log_fn=lambda *_: None)
            torch.cuda.synchronize()
            assert ld.global_step == step0 + AG_RESUME_STEPS
            assert bool(torch.isfinite(ld.cache).all()), "non-finite cache after resuming"
        finally:
            ld.close()
    print(f"[{card}] checkpoint of (e), checkpoint_async: train thread held {held:.3f} s "
          f"(flush, D2H of cache and state, the store and occupancy copies, and the virtual "
          f"masters' save, which has no snapshot form: {master_s[0]:.3f} s for "
          f"{master_gb:.3f} GB), writer {write_s:.3f} s "
          f"{'on its thread' if writing else 'in place'}, {size / 1e9:.3f} GB on disk; "
          f"load {load_s:.3f} s; cache, embed_acc, params, dense_acc, store and occupancy "
          f"bit-equal; the loaded trainer trained {AG_RESUME_STEPS} more steps")
    return dict(held_s=held, write_s=write_s)


def adagrad_run(card: str, dev: torch.device, master: bool) -> dict:
    """Phase 7, run (e) with ``adagrad_master_state`` or (f) without: cached
    AdaGrad on the packed dedup wire at full width, uniform ids, lookahead
    2, the cache cut to AG_CACHE_SETS sets. Counted like train_run, with the
    train thread's time in the eviction fence beside it; (e) then saves and
    loads a checkpoint (checkpoint_round_trip). Then one AdaGrad step on the
    card against the port on the CPU, and the main path's (bf16) step's device
    time beside the SGD step's on the same inputs.

    The step held against the CPU computes in float32 (see the note at AG_LR)."""
    from cdlrm_tpu_torch.train import step as step_lib
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    run = "e" if master else "f"
    cfg = headline_config(
        lookahead=LOOKAHEAD, print_freq=1 << 30, dedup_lookups="on", cache_size=AG_CACHE_SETS,
        optimizer="adagrad", adagrad_master_state=master, learning_rate=AG_LR,
        lr_embeds=AG_LR, checkpoint_async=True,
    )
    total = TRAIN_WARM_STEPS + TRAIN_STEPS
    ds = uniform_stream(cfg, total + AG_RESUME_STEPS + 2 * LOOKAHEAD, SEED + 7)
    tr = CachedDlrmTrainer(cfg, ds, device=dev)
    # the boundary's eviction fence and store gather (a no-op in (f)); the
    # flush after the counted steps is not in it
    fence = add_timer(tr, "_complete_staged_acc")
    ckpt = {}
    try:
        out = counted_train(tr, on_reset=lambda: fence.__setitem__(0, 0.0))
        support = (sum(int(np.count_nonzero(a)) for a in tr._acc_master.accs)
                   if master else 0)
        print(f"[{card}] train ({run}) AdaGrad, adagrad_master_state={master}, cache "
              f"{AG_CACHE_SETS} sets x {WAYS} ways: {out['line']}; train thread in the "
              f"eviction fence and store gather {fence[0]:.3f} s; accumulator store support "
              f"{support} rows")
        launches = out["launches"]
        assert out["written"] > 0, "no eviction was written back"
        assert support > 0 or not master, "the accumulator store is empty"
        assert launches["scatter_add_rows"] == TRAIN_STEPS, launches
        assert launches["index_add_rows"] == TRAIN_STEPS, launches
        assert launches["gather_rows"] > 0 and launches["scatter_set_rows"] > 0, launches
        if master:
            ckpt = checkpoint_round_trip(card, tr, cfg, ds, dev)
    finally:
        tr.close()

    batch = list(itertools.islice(ds.batches(), total))[-1]
    inputs, _, dedup, _ = tr._assemble(batch, BATCH)
    assert dedup
    step = tr._get_step(1, True)
    step32 = step_lib.make_cached_train_step(
        tr.geo, tr.step_cfg._replace(dedup=True, compute_dtype="float32"), tr.pooled_width)
    state = (tr.dense_acc, tr.embed_acc)
    state_cpu = (_cpu_copy(tr.dense_acc), tr.embed_acc.to("cpu", copy=True))
    params_cpu, cache_cpu = _cpu_copy(tr.params), tr.cache.to("cpu", copy=True)
    cache_old = cache_cpu.clone()  # the step updates the cache in place
    # the wire's bf16 dense features, exactly widened
    inputs32 = (inputs[0].float(), *inputs[1:])
    p_dev, c_dev, da_dev, ea_dev, l_dev, _ = step32(tr.params, tr.cache, *inputs32, *state,
                                                    tr._lr, tr._lr_emb)
    p_cpu, c_cpu, da_cpu, ea_cpu, l_cpu, _ = step32(params_cpu, cache_cpu,
                                                    *[x.cpu() for x in inputs32], *state_cpu,
                                                    tr._lr, tr._lr_emb)
    assert bool(torch.isfinite(c_dev).all()) and bool(torch.isfinite(ea_dev).all())
    rows = _adagrad_errs([(c_dev, c_cpu, cache_old)], 2 * AG_LR * DIM ** 0.5)
    dense = _adagrad_errs([(a, b, old) for k in p_dev
                           for pa, pb, pold in zip(p_dev[k], p_cpu[k], params_cpu[k])
                           for a, b, old in zip(pa, pb, pold)], 2 * AG_LR)
    errs = dict(embed_acc=_max_row_err(ea_dev[:, None], ea_cpu[:, None]),
                dense_acc=_max_param_err(da_dev, da_cpu),
                loss=abs(float(l_dev) - float(l_cpu)) / BATCH)
    del c_cpu, cache_cpu, cache_old
    assert max(errs.values()) <= SCORE_TOL, errs
    sgd_step = step_lib.make_cached_train_step(
        tr.geo, tr.step_cfg._replace(dedup=True, optimizer="sgd"), tr.pooled_width)
    ag_ms, sgd_ms = time_pair(
        "AdaGrad step", card,
        lambda: step(tr.params, tr.cache, *inputs, *state, tr._lr, tr._lr_emb),
        lambda: sgd_step(tr.params, tr.cache, *inputs, tr._lr, tr._lr_emb), what="AdaGrad/SGD")
    print(f"  one AdaGrad step in float32 vs the CPU run: max |difference| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {SCORE_TOL}), cache {rows[0]:.3e} with {rows[2]} of the {rows[1]} "
          f"elements moved more than {AG_BULK_TOL} apart, params {dense[0]:.3e} with {dense[2]} "
          f"of {dense[1]} (at most {AG_OUTLIERS} of them may be); "
          f"device step {ag_ms:.3f} ms by events, the SGD "
          f"dedup step on the same inputs {sgd_ms:.3f} ms")
    return dict(launches=launches, examples_s=TRAIN_STEPS * BATCH / out["wall"], **ckpt)


def adagrad(card: str, dev: torch.device) -> dict:
    """Phase 7: cached AdaGrad at full width, (e) with the master state
    (and the checkpoint round trip), (f) without."""
    runs = {"e": adagrad_run(card, dev, True), "f": adagrad_run(card, dev, False)}
    print(f"[{card}] AdaGrad examples/s: (e) master state {runs['e']['examples_s']:.1f}, "
          f"(f) without {runs['f']['examples_s']:.1f}")
    return runs


def fulltable_adagrad(card: str, dev: torch.device) -> dict:
    """Phase 8: full-table AdaGrad at full width: FT_AG_STEPS steps on the
    loguniform stream with every launch count reset just before; one step
    on the card against the port on the CPU in float32 (see the note at AG_LR),
    accumulators included; then a save into a temporary directory and a load
    into a fresh trainer, bit-equal."""
    from cdlrm_tpu_torch.train import step as step_lib
    from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

    cfg = headline_config(use_cache=False, print_freq=1 << 30, optimizer="adagrad",
                          learning_rate=AG_LR, lr_embeds=AG_LR)
    ds = LogUniformStream(FT_AG_STEPS + 1, seed=SEED + 8)
    tr = FullTableDlrmTrainer(cfg, ds, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    tr.train(max_steps=FT_AG_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"[{card}] full-table AdaGrad train: {FT_AG_STEPS} steps of {BATCH} in {wall:.3f} s "
          f"host wall, {FT_AG_STEPS * BATCH / wall:.1f} examples/s (first step included); "
          f"kernel launches {launches}")
    assert tr.global_step == FT_AG_STEPS
    assert launches == {"gather_rows": 2 * FT_AG_STEPS, "scatter_set_rows": 0,
                        "scatter_add_rows": FT_AG_STEPS, "index_add_rows": FT_AG_STEPS}, launches

    batch = list(itertools.islice(ds.batches(), FT_AG_STEPS + 1))[-1]
    x, ls_i, mask, tgt = tr._put(batch)
    cpu = (_cpu_copy(tr.params), tr.tables.to("cpu", copy=True), tr._offsets.cpu(), x.cpu(),
           ls_i.cpu(), mask.cpu(), tgt.cpu(), _cpu_copy(tr.dense_acc),
           tr.emb_acc.to("cpu", copy=True))
    step32 = step_lib.make_fulltable_train_step(
        tr.step_cfg._replace(compute_dtype="float32"), pooled=tr._pooled)
    p_dev, t_dev, da_dev, ea_dev, l_dev, _ = step32(
        tr.params, tr.tables, tr._offsets, x, ls_i, mask, tgt, tr.dense_acc, tr.emb_acc,
        tr._lr, tr._lr_emb)
    tables_old = cpu[1].clone()  # the step updates the tables in place
    p_cpu, t_cpu, da_cpu, ea_cpu, l_cpu, _ = step32(*cpu, tr._lr, tr._lr_emb)
    assert bool(torch.isfinite(l_dev)), "non-finite loss"
    rows = _adagrad_errs([(t_dev, t_cpu, tables_old)], 2 * AG_LR * DIM ** 0.5)
    dense = _adagrad_errs([(a, b, old) for k in p_dev
                           for pa, pb, pold in zip(p_dev[k], p_cpu[k], cpu[0][k])
                           for a, b, old in zip(pa, pb, pold)], 2 * AG_LR)
    errs = dict(emb_acc=_max_row_err(ea_dev[:, None], ea_cpu[:, None]),
                dense_acc=_max_param_err(da_dev, da_cpu),
                loss=abs(float(l_dev) - float(l_cpu)) / BATCH)
    del cpu, t_cpu, tables_old
    assert max(errs.values()) <= SCORE_TOL, errs
    tr.params, tr.dense_acc = p_dev, da_dev
    with tempfile.TemporaryDirectory() as ck:
        t0 = time.perf_counter()
        tr.save_checkpoint(ck)
        save_s = time.perf_counter() - t0
        ld = FullTableDlrmTrainer(cfg, ds, device=dev)
        t0 = time.perf_counter()
        ld.load_checkpoint(ck)
        load_s = time.perf_counter() - t0
    equal = {"tables": _equal_rows(ld.tables, tr.tables),
             "emb_acc": torch.equal(ld.emb_acc, tr.emb_acc),
             "params": _equal_leaves(ld.params, tr.params),
             "dense_acc": _equal_leaves(ld.dense_acc, tr.dense_acc),
             "step": ld.global_step == tr.global_step}
    assert all(equal.values()), equal
    print(f"  one full-table AdaGrad step in float32 vs the CPU run: max |difference| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {SCORE_TOL}), tables {rows[0]:.3e} with {rows[2]} of the {rows[1]} "
          f"elements moved more than {AG_BULK_TOL} apart, params {dense[0]:.3e} with {dense[2]} "
          f"of {dense[1]} (at most {AG_OUTLIERS} of them may be); "
          f"checkpoint save {save_s:.3f} s, load {load_s:.3f} s, "
          f"tables, accumulators and parameters bit-equal")
    del tr, ld, t_dev
    torch.cuda.empty_cache()
    return dict(launches=launches)


def wire_and_md(card: str, dev: torch.device, run_b: dict) -> dict:
    """Phase 9: the cached wire and model variants at full width. (g): run
    (b)'s flags and stream with ``wire_rows_bf16`` and ``wire_x_fp8``; the
    bytes a step and a window stage for the host-to-device link stand beside
    run (b)'s (``run_b``), counted from the staged tensors' sizes. (h):
    cached mixed-dimension tables on LADDER, the packed dedup wire, virtual
    (row-sharded, compact) masters; after the run the padded columns of every
    cache row must read exactly zero, and an eval pass runs through the
    projection."""
    g = train_run(card, dev, "on", label="(g) wire_rows_bf16, wire_x_fp8, ",
                  wire_rows_bf16=True, wire_x_fp8=True)
    print(f"[{card}] link bytes, (b) float32 rows and bf16 features -> (g) bf16 rows and fp8 "
          f"features: a step {run_b['step_bytes']:.0f} -> {g['step_bytes']:.0f} "
          f"({g['step_bytes'] / run_b['step_bytes']:.3f}), a window "
          f"{run_b['window_bytes']:.0f} -> {g['window_bytes']:.0f} "
          f"({g['window_bytes'] / run_b['window_bytes']:.3f}), evicted rows in all "
          f"{run_b['evict_bytes']} -> {g['evict_bytes']}; examples/s "
          f"{run_b['examples_s']:.1f} -> {g['examples_s']:.1f} (the host sets the pace: no "
          f"claim)")
    assert g["window_bytes"] < 0.6 * run_b["window_bytes"], (g, run_b)
    assert g["step_bytes"] < run_b["step_bytes"], (g, run_b)

    def check_md(tr):
        dims = [int(d) for d in tr.cfg.m_spa_per_table]
        assert sorted(set(dims)) == [32, 64, 128], dims
        assert [t.shape[1] for t in tr.master.tables] == list(dims), "masters not compact"
        offs = list(tr.geo.table_offsets) + [tr.geo.trash_row]
        touched = 0
        for t, d_t in enumerate(dims):
            block = tr.cache[int(offs[t]): int(offs[t + 1])]
            assert not bool(block[:, d_t:].any()), f"table {t}: padded columns moved"
            touched += int(block[:, :d_t].any(dim=1).sum())
        proj = tr.params["md_proj"]
        eye = torch.eye(DIM, device=proj.device)
        for t, d_t in enumerate(dims):
            if d_t == DIM:
                assert torch.equal(proj[t], eye), f"table {t}: identity projection moved"
            else:
                assert not bool(proj[t, d_t:].any()), f"table {t}: projection pad rows moved"
        reset = read_launches()
        acc, auc = tr.evaluate(max_batches=4, log_fn=lambda *_: None)
        after = read_launches()
        assert np.isfinite(acc) and np.isfinite(auc), (acc, auc)
        assert after["gather_rows"] == reset["gather_rows"] + 4, (reset, after)
        print(f"[{card}] (h) cached MD: widths {sorted(set(dims))} over {len(dims)} tables "
              f"({[list(dims).count(d) for d in sorted(set(dims))]} of each), {touched} cache "
              f"rows hold a row, every padded column reads exactly zero, the full-width "
              f"tables' identity projections are untouched; eval of 4 batches: accuracy "
              f"{acc:.6f} AUC {auc:.6f}")

    h = train_run(card, dev, "on", label="(h) cached MD on the ladder, ", ln_emb=LADDER,
                  check=check_md, md_flag=True, md_round_dims=True)
    for run in (g, h):
        launches = run["launches"]
        assert launches["scatter_add_rows"] >= TRAIN_STEPS, launches
        assert launches["index_add_rows"] >= TRAIN_STEPS, launches
        assert launches["gather_rows"] > 0 and launches["scatter_set_rows"] > 0, launches
    return {"g": g, "h": h}


def _entries_to(entries, device, copy: bool = False) -> list:
    return [e if e is None else e.with_leaves([w.to(device, copy=copy) for w in e.leaves()])
            for e in entries]


def fulltable_tricks(card: str, dev: torch.device, kind: str) -> dict:
    """Phase 10, run (i) ``kind='qr'`` (operation mult) or (j) ``'md'``: the
    full-table trainer on LADDER, the tables above TRICK_THRESHOLD rows
    compressed and the rest plain: TRICK_STEPS steps on the loguniform
    stream and an eval, every launch count reset just before; one step on
    the card against the port on the CPU; then a save and a load into a
    fresh trainer, bit-equal."""
    from cdlrm_tpu_torch.models.embedding import emb_leaves
    from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

    flags = (dict(qr_flag=True, qr_operation="mult", qr_threshold=TRICK_THRESHOLD)
             if kind == "qr" else
             dict(md_flag=True, md_round_dims=True, md_threshold=TRICK_THRESHOLD))
    run = "i" if kind == "qr" else "j"
    cfg = headline_config(LADDER, use_cache=False, print_freq=1 << 30, **flags)
    ds = LogUniformStream(TRICK_STEPS + 1, seed=SEED + 9, ln_emb=LADDER)
    test_ds = LogUniformStream(FT_EVAL_BATCHES, seed=SEED + 10, ln_emb=LADDER)
    tr = FullTableDlrmTrainer(cfg, ds, test_ds, device=dev)
    n_comp = sum(e is not None for e in tr.emb_entries)
    assert 0 < n_comp < TABLES, n_comp
    shapes = sorted({tuple(w.shape[1:]) for e in tr.emb_entries if e is not None
                     for w in e.leaves()})
    reset_launches()
    t0 = time.perf_counter()
    tr.train(max_steps=TRICK_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc, auc = tr.evaluate(max_batches=FT_EVAL_BATCHES)
    launches = read_launches()
    print(f"[{card}] full-table ({run}) {kind.upper()} on the ladder: {n_comp} of {TABLES} "
          f"tables compressed (tensor widths {shapes}), plain tables "
          f"{tuple(tr.tables.shape)}; {TRICK_STEPS} steps of {BATCH} in {wall:.3f} s host "
          f"wall, {TRICK_STEPS * BATCH / wall:.1f} examples/s (first step included); eval of "
          f"{FT_EVAL_BATCHES} batches: accuracy {acc:.6f} AUC {auc:.6f}; kernel launches "
          f"{launches}")
    assert tr.global_step == TRICK_STEPS and np.isfinite(acc) and np.isfinite(auc), (acc, auc)
    # per step: the plain tables' gather and its expand, and one gather for
    # each tensor a compressed table reads (QR: two, MD: one); the backward
    # adds one index_add_rows for each but the plain tables' first
    per_table = 2 if kind == "qr" else 1
    assert launches["gather_rows"] == (TRICK_STEPS + FT_EVAL_BATCHES) * (
        1 + per_table * n_comp) + TRICK_STEPS, launches
    assert launches["index_add_rows"] == TRICK_STEPS * (1 + per_table * n_comp), launches
    assert launches["scatter_add_rows"] == TRICK_STEPS, launches

    batch = list(itertools.islice(ds.batches(), TRICK_STEPS + 1))[-1]
    x, ls_i, mask, tgt = tr._put(batch)
    params_cpu, tables_cpu = _cpu_copy(tr.params), tr.tables.to("cpu", copy=True)
    entries_cpu = _entries_to(tr.emb_entries, "cpu", copy=True)
    p_dev, t_dev, l_dev, _ = tr.train_step(tr.params, tr.tables, tr._offsets, x, ls_i, mask,
                                           tgt, tr._lr, tr._lr_emb, entries=tr.emb_entries)
    p_cpu, t_cpu, l_cpu, _ = tr.train_step(params_cpu, tables_cpu, tr._offsets.cpu(), x.cpu(),
                                           ls_i.cpu(), mask.cpu(), tgt.cpu(), tr._lr,
                                           tr._lr_emb, entries=entries_cpu)
    assert bool(torch.isfinite(l_dev)), "non-finite loss"
    errs = dict(tables=_max_row_err(t_dev, t_cpu), params=_max_param_err(p_dev, p_cpu),
                loss=abs(float(l_dev) - float(l_cpu)) / BATCH,
                compressed=max(_max_row_err(a, b) for a, b in zip(
                    emb_leaves([e for e in tr.emb_entries if e is not None]),
                    emb_leaves([e for e in entries_cpu if e is not None]))))
    assert max(errs.values()) <= SCORE_TOL, errs
    tr.params = p_dev
    with tempfile.TemporaryDirectory() as ck:
        tr.save_checkpoint(ck)
        size = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        ld = FullTableDlrmTrainer(cfg, ds, device=dev)
        ld.load_checkpoint(ck)
    equal = {"tables": _equal_rows(ld.tables, tr.tables),
             "compressed": all(torch.equal(a, b) for a, b in zip(
                 emb_leaves(ld.emb_tables()), emb_leaves(tr.emb_tables()))),
             "params": _equal_leaves(ld.params, tr.params),
             "step": ld.global_step == tr.global_step}
    assert all(equal.values()), equal
    print(f"  one full-table {kind.upper()} step vs the CPU run: max |difference| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tolerance {SCORE_TOL}); checkpoint {size / 1e9:.3f} GB saved and loaded, "
          f"tables, compressed tensors and parameters bit-equal")
    del tr, ld, t_dev
    torch.cuda.empty_cache()
    return dict(launches=launches)


def profiled_run(card: str, dev: torch.device) -> dict:
    """Phase 11: PROFILE_STEPS steps of cached training on the packed dedup
    wire at full width under ``profile_trace``, every launch count reset just
    before. The trace file must be there, and must name the kernels of
    csrc/row_ops.cu that the steps launched, from the train thread and from
    the host threads that stage for it."""
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
    from cdlrm_tpu_torch.utils.profiling import TRACE_FILE, profile_trace

    cfg = headline_config(lookahead=LOOKAHEAD, print_freq=1 << 30, dedup_lookups="on")
    ds = uniform_stream(cfg, PROFILE_STEPS + 2, SEED + 11)
    tr = CachedDlrmTrainer(cfg, ds, device=dev)
    with tempfile.TemporaryDirectory() as trace_dir:
        reset_launches()
        t0 = time.perf_counter()
        try:
            with profile_trace(trace_dir, dev):
                tr.train(max_steps=PROFILE_STEPS)
                torch.cuda.synchronize()
        finally:
            tr.close()
        wall = time.perf_counter() - t0
        launches = read_launches()
        path = os.path.join(trace_dir, TRACE_FILE)
        size = os.path.getsize(path)
        assert size > 0, "empty trace"
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    names = ("gather_rows_unrolled_kernel", "scatter_set_rows_unrolled_kernel",
             "scatter_add_rows_kernel", "index_add_rows_kernel")
    kernels = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
    found = {name: sum(name in k for k in kernels) for name in names}
    # the host threads whose CUDA calls the trace holds: the train thread
    # launches the kernels, the pipeline and stager threads copy to the device
    runtime_threads = {ev.get("tid") for ev in events if ev.get("cat") == "cuda_runtime"}
    copy_threads = {ev.get("tid") for ev in events if ev.get("cat") == "cuda_runtime"
                    and "Memcpy" in ev.get("name", "")}
    print(f"[{card}] profiled run: {PROFILE_STEPS} steps under torch.profiler in {wall:.3f} s "
          f"host wall (trace export included), trace {size / 1e6:.1f} MB, {len(events)} "
          f"events, {len(kernels)} kernels; CUDA runtime calls from {len(runtime_threads)} "
          f"host threads, copies from {len(copy_threads)}; kernels of row_ops.cu by name "
          f"{found}; kernel launches {launches}")
    assert tr.global_step == PROFILE_STEPS
    assert found["gather_rows_unrolled_kernel"] > 0, found
    assert found["scatter_add_rows_kernel"] > 0, found
    assert launches["gather_rows"] > 0 and launches["scatter_add_rows"] == PROFILE_STEPS, launches
    return dict(launches=launches)


def check_aggregate_kernels(card: str, rows: int, dev: torch.device) -> None:
    """The aggregate step's new kernel site, in phase 2's style: the union
    list built with a static shape (``union_slots``) against ``nonzero``,
    then ``gather_rows`` and ``scatter_set_rows`` at the bucket's ``[k]``
    with the union count as the valid prefix, bit-exact against their plain
    versions on the full-size cache."""
    from cdlrm_tpu_torch.ops.lookup import gather_rows, gather_rows_ref
    from cdlrm_tpu_torch.ops.scatter import scatter_set_rows, scatter_set_rows_ref
    from cdlrm_tpu_torch.train.step import union_slots
    from cdlrm_tpu_torch.utils.padding import pow2_bucket

    k = pow2_bucket(TABLES * BATCH)  # table_agg_freq 1: the lookups of one global batch
    trash = rows - 1
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    cache = torch.randn((rows, DIM), generator=g, device=dev)
    for marked in (100_000, 0, k):
        flags = torch.zeros(rows, dtype=torch.bool, device=dev)
        flags[torch.randperm(trash, generator=g, device=dev)[:marked]] = True
        idx, count = union_slots(flags, k, trash)
        want = torch.full((k,), trash, dtype=torch.int32, device=dev)
        want[:marked] = torch.nonzero(flags)[:, 0].to(torch.int32)
        assert int(count) == marked and torch.equal(idx, want), f"union_slots at {marked} rows"
        assert torch.equal(gather_rows(cache, idx), gather_rows_ref(cache, idx))
        agg_rows = torch.randn((k, DIM), generator=g, device=dev)
        got = scatter_set_rows(cache.clone(), idx, agg_rows, count)
        ref = scatter_set_rows_ref(cache.clone(), idx, agg_rows, marked)
        assert torch.equal(got, ref), f"scatter_set_rows at the union of {marked} rows"
        assert torch.equal(got[trash], cache[trash]), "trash row written"
    print(f"[{card}] aggregate step's site: union list [{k}] equal to nonzero's; gather_rows "
          f"and scatter_set_rows at [{k}] (valid prefix = union count, read on the device) "
          "bit-exact against their plain versions at 100,000, 0 and a full bucket of union rows")


def same_on_all_ranks(group, t: torch.Tensor) -> bool:
    """Whether ``t`` is the same bits on every rank; every rank learns it."""
    ref = t.clone()
    group.broadcast_from0(ref)
    differs = torch.tensor([0 if torch.equal(ref, t) else 1], device=t.device)
    return not bool(group.all_reduce_max(differs))


def dp_run(card: str, dev: torch.device, group, mode: str, tmp: str) -> dict:
    """One rank's part of a two-rank run at the headline geometry (global
    batch 4096, 2048 a rank), ``refill_broadcast=mode``. ``delta``: set-up
    steps, TRAIN_STEPS counted steps, one more step that holds both ranks'
    union rows against each other, an eval pass, the parameter and master
    checks, a checkpoint loaded into a fresh trainer pair, one step against
    the CPU. ``strict``: DP_STRICT_STEPS steps and the parameter check. Rank 0
    prints; every rank returns its launch counts."""
    import zlib

    from cdlrm_tpu_torch.models.dlrm import param_leaves
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    rank = group.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    delta = mode == "delta"
    warm, steps = (TRAIN_WARM_STEPS, TRAIN_STEPS) if delta else (0, DP_STRICT_STEPS)
    cfg = headline_config(world_size=DP_WORLD, lookahead=LOOKAHEAD, print_freq=1 << 30,
                          dedup_lookups="on", table_agg_freq=1, table_agg_op="mean",
                          refill_broadcast=mode)
    train_ds = uniform_stream(cfg, warm + steps + 3, SEED + 2)
    test_ds = uniform_stream(cfg, DP_EVAL_BATCHES, SEED + 3)
    tr = CachedDlrmTrainer(cfg, train_ds, test_ds, device=dev, group=group)
    b_loc, k = cfg.local_batch_size, tr._agg_bucket
    assert k is not None, "the sparse aggregate form was expected at this geometry"
    agg = {"s": 0.0, "calls": 0, "launches": None, "check": False, "union_rows": None}
    inner = tr._aggregate

    def aggregate():
        union = group.all_reduce_max(tr.touched.clone()).bool() if agg["check"] else None
        before = read_launches()
        t0 = time.perf_counter()
        inner()
        torch.cuda.synchronize()
        agg["s"] += time.perf_counter() - t0
        agg["calls"] += 1
        agg["launches"] = {n: c - before[n] for n, c in read_launches().items()}
        if union is not None:
            agg["union_rows"] = int(union.sum())
            assert same_on_all_ranks(group, tr.cache[union]), (
                "the ranks' caches differ on the union rows after an aggregate step")

    tr._aggregate = aggregate
    out = {}
    try:
        if warm:
            tr.train(max_steps=warm)
        torch.cuda.synchronize()
        m = tr.metrics
        base = (m.caching_overhead_s, m.refills, agg["s"], agg["calls"])
        reset_launches()
        t0 = time.perf_counter()
        tr.train(max_steps=warm + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] = read_launches()
        refill_s, refills = m.caching_overhead_s - base[0], m.refills - base[1]
        agg_s, agg_calls = agg["s"] - base[2], agg["calls"] - base[3]
        assert tr.global_step == warm + steps and refills > 0 and agg_calls == steps
        dense_bytes = 4 * (sum(p.numel() for p in param_leaves(tr.params)) + 2)
        rows = tr.geo.total_rows
        say(f"[{card}] two ranks sharing one card over gloo, refill_broadcast={mode}: {steps} "
            f"steps of {BATCH} ({b_loc} a rank) in {wall:.3f} s host wall, "
            f"{steps * BATCH / wall:.1f} examples/s global ({1000 * wall / steps:.2f} ms/step); "
            f"aggregate step {1000 * agg_s / agg_calls:.2f} ms on the train thread (mean of "
            f"{agg_calls}, device work included); refill {1000 * refill_s / refills:.1f} ms on "
            f"the train thread (mean of {refills}); bytes per collective, from tensor sizes: "
            f"touched mask {rows}, union rows [{k}, {DIM}] {k * DIM * 4}, flat dense gradient "
            f"and metrics {dense_bytes}"
            + (f", strict cache broadcast {rows * DIM * 4}" if not delta else "")
            + f"; loss {m.loss_sum / max(1, m.examples):.6f}, train hit rate {m.hit_rate:.6f}; "
            f"kernel launches of the {steps} steps {out['launches']}; of one aggregate step "
            f"{agg['launches']}")
        assert agg["launches"] == {"gather_rows": 1, "scatter_set_rows": 1,
                                   "scatter_add_rows": 0, "index_add_rows": 0}, agg["launches"]
        assert np.isfinite(m.loss_sum)
        flat = torch.cat([p.reshape(-1) for p in param_leaves(tr.params)])
        assert same_on_all_ranks(group, flat), "dense parameters differ between the ranks"
        say(f"  dense parameters ({flat.numel()} values) bit-equal on both ranks after the run")
        if not delta:
            return out
        # one more step: the union rows of its aggregate step, rank against rank
        agg["check"] = True
        tr.train(max_steps=warm + steps + 1)
        agg["check"] = False
        say(f"  after an aggregate step (table_agg_freq 1) the {agg['union_rows']} union rows "
            "are bit-equal on both ranks")
        acc, auc = tr.evaluate()
        assert np.isfinite(acc) and np.isfinite(auc), (acc, auc)
        assert tr.eviction_manager.flush(timeout=120), "eviction writeback stalled"
        # the masters: N full copies kept equal by the evicted rows' broadcast;
        # a checksum of the rows of the first batches' ids (the first inserted,
        # so the likeliest written back) and of a stride over every table
        first = list(itertools.islice(train_ds.batches(), 8))
        sums = []
        for t in range(TABLES):
            ids = np.unique(np.concatenate([b.ls_i[t] for b in first]
                                           + [np.arange(0, ROWS, 97)]))
            sums.append(zlib.crc32(np.ascontiguousarray(tr.master.gather(t, ids)).tobytes()))
        assert same_on_all_ranks(group, torch.tensor(sums, dtype=torch.int64, device=dev)), (
            "the ranks' masters differ after the writebacks")
        say(f"  masters equal on both ranks after {tr.eviction_manager.rows_written} rows "
            "written back (checksums of 26 tables' sampled rows)")

        # checkpoint: one file set written by rank 0, loaded by a fresh pair
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        tr.save_checkpoint(ck)
        save_s = time.perf_counter() - t0
        snap = [tr.cache.clone(), tr.touched.clone()] + [p.clone() for p in param_leaves(tr.params)]
        tr.close()
        batch = list(itertools.islice(train_ds.batches(), warm + steps + 1))[-1]
        inputs, _, dedup, _ = tr._assemble(batch, b_loc)
        step = tr._get_step(1, dedup)
        params_cpu, cache_cpu = _cpu_copy(tr.params), tr.cache.to("cpu", copy=True)
        touched_cpu = tr.touched.to("cpu", copy=True)
        # the card's step, then the same step on the CPU, each with its
        # collective over the same gloo group, in the same order on both ranks
        p_dev, c_dev, l_dev, _ = step(tr.params, tr.cache, *inputs, tr._lr, tr._lr_emb,
                                      touched=tr.touched)
        p_cpu, c_cpu, l_cpu, _ = step(params_cpu, cache_cpu, *[x.cpu() for x in inputs],
                                      tr._lr, tr._lr_emb, touched=touched_cpu)
        cache_err = _max_row_err(c_dev, c_cpu)
        param_err = _max_param_err(p_dev, p_cpu)
        loss_err = abs(float(l_dev) - float(l_cpu)) / BATCH
        assert torch.equal(tr.touched.cpu(), touched_cpu), "touched masks differ from the CPU's"
        assert max(cache_err, param_err, loss_err) <= SCORE_TOL, (cache_err, param_err, loss_err)
        print(f"  rank {rank}: one step vs the port on the CPU over the same group: max |cache "
              f"difference| {cache_err:.3e}, |param difference| {param_err:.3e}, |loss "
              f"difference| {loss_err:.3e} (tolerance {SCORE_TOL}), touched masks equal")
        del c_cpu, cache_cpu, params_cpu, p_dev, c_dev
        tr.cache = tr.touched = None
        torch.cuda.empty_cache()
        tr = CachedDlrmTrainer(cfg, train_ds, test_ds, device=dev, group=group)
        t0 = time.perf_counter()
        tr.load_checkpoint(ck)
        load_s = time.perf_counter() - t0
        got = [tr.cache, tr.touched] + param_leaves(tr.params)
        assert all(torch.equal(a, b) for a, b in zip(snap, got)), (
            "the loaded checkpoint differs from the saved state")
        assert tr.global_step == warm + steps + 1 and bool(tr.touched.any()) is False
        size = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        say(f"  checkpoint of the pair: {size / 1e9:.3f} GB in one file set (cache.npy "
            f"[{DP_WORLD}*{rows}, {DIM}]), saved in {save_s:.2f} s (the ranks' blocks gathered "
            f"over the host), loaded into a fresh pair in {load_s:.2f} s, bit-equal on rank "
            f"{rank} and its peer")
        return out
    finally:
        tr.close()


def dp_rank_main(rank: int, rdzv: str, tmp: str) -> int:
    """One of phase 12's two ranks: a process of its own that makes cuda:0
    current, joins a gloo group asked for by name, runs (k) and (l), writes
    its launch counts to ``tmp/rank<r>.json`` and leaves with its threads
    joined. Any failure exits non-zero, and the parent reads the code."""
    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    group = make_dp_mesh(DP_WORLD, rank, init_method="file://" + rdzv, backend="gloo",
                         device=dev, timeout_s=DP_TIMEOUT_S)
    assert group.backend == "gloo" and group.world_size == DP_WORLD
    try:
        result = {"k": dp_run(card, dev, group, "delta", tmp),
                  "l": dp_run(card, dev, group, "strict", tmp)}
    except BaseException:
        report_failure(rank)  # before the peer fails on the closed connections
        raise
    finally:
        destroy_dp_mesh(group)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def two_ranks(card: str, rows: int, dev: torch.device) -> dict:
    """Phase 12: data parallelism as two ranks on the one card. Checks the
    aggregate step's kernel site here, then starts the two rank processes,
    waits for both, fails on any exit code but 0 and returns the kernel
    launches of their counted steps, added over the ranks and the runs."""
    check_aggregate_kernels(card, rows, dev)
    torch.cuda.empty_cache()
    print(f"[{card}] phase 12 cannot show a trainer on cuda:1 in a process whose current "
          "device is 0 (the kernel wrappers' current-device fault repaired unseen in an "
          "earlier change): this machine has one card, and both ranks use cuda:0")
    with tempfile.TemporaryDirectory(prefix="cdlrm_dp_") as tmp:
        rdzv = os.path.join(tmp, "rdzv")
        run_rank_processes(lambda r: ("--dp-rank", str(r), rdzv, tmp), DP_WORLD,
                           DP_TIMEOUT_S, tmp)
        results = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                results.append(json.load(f))
    launches = {name: sum(res[run]["launches"][name] for res in results for run in ("k", "l"))
                for name in KERNELS}
    print(f"[{card}] phase 12: both ranks exited 0; kernel launches of their counted steps, "
          f"both ranks and both runs: {launches}")
    assert all(launches[name] > 0 for name in KERNELS), launches
    return {"launches": launches}


@functools.lru_cache(maxsize=1)
def _procedural_block() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    fast = np.random.Generator(np.random.SFC64(int(rng.integers(2**31))))
    return fast.random((MH_BLOCK_ROWS, DIM), dtype=np.float32) * 2.0 - 1.0


def procedural_rows(t: int, ids: np.ndarray) -> np.ndarray:
    """The masters' initial rows of table ``t`` at ``ids``, computed here from
    the seed without any table: the first draw of the trainer's generator
    seeds the block, and a row is its hashed block row scaled by
    sqrt(1 / rows)."""
    pos = (np.asarray(ids, np.int64) + t * MH_PHI) % MH_BLOCK_ROWS
    return _procedural_block()[pos] * np.float32(np.sqrt(1.0 / ROWS))


def instrument_exchanges(tr, group) -> dict:
    """Count, time and size every exchange of ``tr``: each window exchange
    and each eval exchange (its two all-gathers), host clock around the call
    on the train thread, bytes received from the all-gathers' outputs. Keeps
    the first window's rows and the first eval batch's requests and rows for
    the checks."""
    seen = {"window": [0, 0.0, 0], "eval": [0, 0.0, 0], "first": {}, "kind": "window"}
    gather, exchange, fetch = group.all_gather_host, tr._exchange_window, tr._row_exchange.fetch

    def all_gather_host(block):
        out = gather(block)
        seen[seen["kind"]][2] += out.nbytes
        return out

    def exchange_window(uniques, rows):
        t0 = time.perf_counter()
        out = exchange(uniques, rows)
        seen["window"][0] += 1
        seen["window"][1] += time.perf_counter() - t0
        seen["first"].setdefault("window", (uniques, out))
        return out

    def fetch_rows(requests):
        seen["kind"] = "eval"
        t0 = time.perf_counter()
        try:
            out = fetch(requests)
        finally:
            seen["kind"] = "window"
        seen["eval"][0] += 1
        seen["eval"][1] += time.perf_counter() - t0
        seen["first"].setdefault("eval", ([(t, ids.copy()) for t, ids in requests], out))
        return out

    group.all_gather_host = all_gather_host
    tr._exchange_window, tr._row_exchange.fetch = exchange_window, fetch_rows
    return seen


def mh_run(card: str, dev: torch.device, group, coordinator: str, tmp: str) -> dict:
    """One rank's part of phase 13 (multi-host mode at the headline
    geometry, run (b)'s stream and wire, ``refill_broadcast=delta``, the
    refill prestage on): set-up steps, MH_STEPS counted steps, one more step
    whose aggregate holds the union rows against the other rank's, an eval
    pass, a synchronous checkpoint loaded bit-equal into a fresh pair, one
    step against the CPU. Checks the first window's exchanged rows and the
    first eval batch's fetched rows against the masters' procedural values,
    the dense parameters across the ranks, and that the rows the ranks wrote
    back partition the evicted rows. Rank 0 prints; every rank returns its
    launch counts."""
    import zlib

    from cdlrm_tpu_torch.models.dlrm import param_leaves
    from cdlrm_tpu_torch.parallel.multihost import ShardedMasterTables
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    rank = group.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    warm, steps = MH_WARM_STEPS, MH_STEPS
    cfg = headline_config(world_size=MH_WORLD, lookahead=LOOKAHEAD, print_freq=1 << 30,
                          dedup_lookups="on", table_agg_freq=1, table_agg_op="mean",
                          refill_broadcast="delta", coordinator_address=coordinator)
    train_ds = uniform_stream(cfg, warm + steps + 4, SEED + 2)
    test_ds = uniform_stream(cfg, DP_EVAL_BATCHES, SEED + 3)
    t0 = time.perf_counter()
    tr = CachedDlrmTrainer(cfg, train_ds, test_ds, device=dev, group=group)
    build_s = time.perf_counter() - t0
    assert tr.multihost and isinstance(tr.master, ShardedMasterTables), "not multi-host mode"
    lo, hi = tr.master.ranges[0]
    master_bytes = sum(t.nbytes for t in tr.master.tables)
    ex = instrument_exchanges(tr, group)
    evicted = [[] for _ in range(TABLES)]
    put = tr.eviction_fifo.put

    def record_evictions(item, *args, **kwargs):
        if isinstance(item, tuple):  # not a flush barrier or the closing None
            tables, idxs = item[0], item[1]
            for t in np.unique(tables):
                evicted[int(t)].append(np.asarray(idxs[tables == t], np.int64))
        return put(item, *args, **kwargs)

    tr.eviction_fifo.put = record_evictions
    agg = {"check": False, "union_rows": None}
    inner = tr._aggregate

    def aggregate():
        union = group.all_reduce_max(tr.touched.clone()).bool() if agg["check"] else None
        inner()
        if union is not None:
            agg["union_rows"] = int(union.sum())
            assert same_on_all_ranks(group, tr.cache[union]), (
                "the ranks' caches differ on the union rows after an aggregate step")

    tr._aggregate = aggregate
    out = {}
    try:
        # the first window's exchanged rows: nothing is written back yet
        tr.train(max_steps=warm)
        uniques, rows = ex["first"]["window"]
        n_rows = sum(u.size for u in uniques)
        for t in range(TABLES):
            assert np.array_equal(rows[t], procedural_rows(t, uniques[t])), (
                f"table {t}: the first window's exchanged rows are not the masters' values")
        say(f"  first window: the {n_rows} exchanged rows of {TABLES} tables equal the masters' "
            "procedural values (computed from the seed's block, no table built)")
        torch.cuda.synchronize()
        m = tr.metrics
        base = (m.refills, tr.mh_prefetches, ex["window"][:])
        reset_launches()
        t0 = time.perf_counter()
        tr.train(max_steps=warm + steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] = read_launches()
        refills, hoists = m.refills - base[0], tr.mh_prefetches - base[1]
        n_ex = ex["window"][0] - base[2][0]
        ex_s, ex_bytes = ex["window"][1] - base[2][1], ex["window"][2] - base[2][2]
        assert tr.global_step == warm + steps and refills > 0 and hoists > 0, (refills, hoists)
        say(f"[{card}] two ranks sharing one card over gloo, multi-host mode (row-sharded "
            f"masters, refill_broadcast=delta, refill prestage): {steps} steps of {BATCH} "
            f"({cfg.local_batch_size} a rank) in {wall:.3f} s host wall, "
            f"{steps * BATCH / wall:.1f} examples/s global ({1000 * wall / steps:.2f} ms/step); "
            f"{refills} refills, {hoists} prestage hoists; window exchange "
            f"{1000 * ex_s / n_ex:.1f} ms on the train thread and {ex_bytes / n_ex / 1e6:.1f} MB "
            f"received a rank (mean of {n_ex}); loss {m.loss_sum / max(1, m.examples):.6f}, "
            f"train hit rate {m.hit_rate:.6f}; kernel launches of the {steps} steps "
            f"{out['launches']}")
        say(f"  host RAM of the masters: {master_bytes / 1e9:.3f} GB a rank (its row shard, "
            f"rows [{lo}, {hi}) of every table) against {TABLES * ROWS * DIM * 4 / 1e9:.3f} GB "
            "for the whole masters that each rank would hold as full tables; phase 12's ranks "
            "hold virtual masters (a block and the rows written back)")
        flat = torch.cat([p.reshape(-1) for p in param_leaves(tr.params)])
        assert same_on_all_ranks(group, flat), "dense parameters differ between the ranks"
        say(f"  dense parameters ({flat.numel()} values) bit-equal on both ranks after the run")
        agg["check"] = True
        tr.train(max_steps=warm + steps + 1)
        agg["check"] = False
        say(f"  after an aggregate step (table_agg_freq 1) the {agg['union_rows']} union rows "
            "are bit-equal on both ranks")

        acc, auc = tr.evaluate()
        assert np.isfinite(acc) and np.isfinite(auc), (acc, auc)
        assert tr.eviction_manager.flush(timeout=120), "eviction writeback stalled"
        # the written-back rows partition the evicted ones: this rank wrote
        # exactly the evicted ids it owns, and the counts add up over the ranks
        mine_total, all_total = 0, 0
        for t in range(TABLES):
            ev = np.unique(np.concatenate(evicted[t])) if evicted[t] else np.zeros(0, np.int64)
            t_lo, t_hi = tr.master.ranges[t]
            want = ev[(ev >= t_lo) & (ev < t_hi)]
            assert np.array_equal(tr.master._dirty.ids(t), want), f"table {t}: written != owned"
            mine_total += want.size
            all_total += ev.size
        totals = group.all_reduce_sum(torch.tensor([mine_total], dtype=torch.int64))
        assert int(totals[0]) == all_total > 0, (int(totals[0]), all_total)
        say(f"  the {all_total} evicted (table, id) pairs are written back exactly once over "
            f"the ranks (rank 0 {mine_total}), each by its owner")
        # the first eval batch's fetched rows: the procedural values, or for
        # an evicted row this rank owns, its own master's
        requests, fetched = ex["first"]["eval"]
        n_proc = n_own = 0
        for (t, ids), got in zip(requests, fetched):
            ev = np.unique(np.concatenate(evicted[t])) if evicted[t] else np.zeros(0, np.int64)
            written = np.isin(ids, ev)
            assert np.array_equal(got[~written], procedural_rows(t, ids[~written])), (
                f"table {t}: fetched eval rows are not the masters' values")
            own = written & tr.master.owned_mask(t, ids)
            assert np.array_equal(got[own], tr.master.gather_owned_of(t, ids[own])), t
            n_proc += int((~written).sum())
            n_own += int(own.sum())
        n_eval, eval_s, eval_bytes = ex["eval"]
        print(f"  rank {rank}: eval exchange {1000 * eval_s / n_eval:.1f} ms on the train "
              f"thread and {eval_bytes / n_eval / 1e6:.2f} MB received (mean of {n_eval} "
              f"batches, two all-gathers each); the first batch's {n_proc} fetched rows never "
              f"written back equal the procedural values, and its {n_own} written back rows "
              "that this rank owns equal its master's")

        # checkpoint: each rank's files in one directory, loaded by a fresh pair
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        tr.save_checkpoint(ck)
        save_s = time.perf_counter() - t0
        tag = f".h{rank}"
        assert os.path.exists(os.path.join(ck, f"master{tag}.npz"))
        sums = [zlib.crc32(t) for t in tr.master.tables]
        snap = [tr.cache.clone(), tr.touched.clone()] + [p.clone() for p in param_leaves(tr.params)]
        tr.close()
        batch = list(itertools.islice(train_ds.batches(), warm + steps + 1))[-1]
        inputs, _, dedup, _ = tr._assemble(batch, cfg.local_batch_size)
        step = tr._get_step(1, dedup)
        params_cpu, cache_cpu = _cpu_copy(tr.params), tr.cache.to("cpu", copy=True)
        touched_cpu = tr.touched.to("cpu", copy=True)
        p_dev, c_dev, l_dev, _ = step(tr.params, tr.cache, *inputs, tr._lr, tr._lr_emb,
                                      touched=tr.touched)
        p_cpu, c_cpu, l_cpu, _ = step(params_cpu, cache_cpu, *[x.cpu() for x in inputs],
                                      tr._lr, tr._lr_emb, touched=touched_cpu)
        cache_err = _max_row_err(c_dev, c_cpu)
        param_err = _max_param_err(p_dev, p_cpu)
        loss_err = abs(float(l_dev) - float(l_cpu)) / BATCH
        assert torch.equal(tr.touched.cpu(), touched_cpu), "touched masks differ from the CPU's"
        assert max(cache_err, param_err, loss_err) <= SCORE_TOL, (cache_err, param_err, loss_err)
        print(f"  rank {rank}: one step vs the port on the CPU over the same group: max |cache "
              f"difference| {cache_err:.3e}, |param difference| {param_err:.3e}, |loss "
              f"difference| {loss_err:.3e} (tolerance {SCORE_TOL}), touched masks equal")
        del c_cpu, cache_cpu, params_cpu, p_dev, c_dev
        tr.cache = tr.touched = tr.master = None
        torch.cuda.empty_cache()
        tr = CachedDlrmTrainer(cfg, train_ds, test_ds, device=dev, group=group)
        t0 = time.perf_counter()
        tr.load_checkpoint(ck)
        load_s = time.perf_counter() - t0
        got = [tr.cache, tr.touched] + param_leaves(tr.params)
        assert all(torch.equal(a, b) for a, b in zip(snap, got)), (
            "the loaded checkpoint differs from the saved state")
        assert [zlib.crc32(t) for t in tr.master.tables] == sums, "loaded master shard differs"
        assert tr.global_step == warm + steps + 1
        size = sum(os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        say(f"  checkpoint of the pair: {size / 1e9:.3f} GB in one directory (each rank's "
            f"cache{tag}.npy [{tr.geo.total_rows}, {DIM}], touched and master shard, rank 0's "
            f"shared files), saved in {save_s:.2f} s (synchronous, ending in the barrier), "
            f"loaded into a fresh pair in {load_s:.2f} s, cache, touched mask, parameters and "
            f"master shard bit-equal on rank {rank} and its peer; trainer build (masters "
            f"included) {build_s:.2f} s")
        return out
    finally:
        tr.close()


def mh_rank_main(rank: int, port: str, tmp: str) -> int:
    """One of phase 13's two ranks: a process of its own that makes cuda:0
    current, joins the coordinator ``127.0.0.1:port`` through
    ``initialize_distributed`` in a gloo group asked for by name, runs
    :func:`mh_run`, writes its launch counts to ``tmp/mh_rank<r>.json`` and
    leaves. Any failure exits non-zero, and the parent reads the code."""
    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure
    from cdlrm_tpu_torch.parallel.multihost import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    coordinator = f"127.0.0.1:{port}"
    pid, nproc = initialize_distributed(coordinator, MH_WORLD, rank, backend="gloo", device=dev,
                                        timeout_s=MH_TIMEOUT_S)
    assert (pid, nproc) == (rank, MH_WORLD), (pid, nproc)
    group = make_dp_mesh(MH_WORLD)
    assert group.backend == "gloo" and group.rank == rank
    try:
        result = mh_run(card, dev, group, coordinator, tmp)
    except BaseException:
        report_failure(rank)  # before the peer fails on the closed connections
        raise
    finally:
        destroy_dp_mesh(group)
    with open(os.path.join(tmp, f"mh_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def run_rank_processes(argv_of, world: int, timeout_s: float, tmp: str) -> None:
    """Start ``world`` processes of this script (``argv_of(rank)``), wait
    for all of them (``bench_torch.launch_ranks``: a failed rank ends the
    others after a short grace, a late one at once, and any exit code but 0
    raises with every rank's log), and print rank 0's log and the other
    ranks' lines that start with "  rank"."""
    texts = bench_torch.launch_ranks(
        [[os.path.abspath(__file__), *argv_of(r)] for r in range(world)], tmp, timeout_s)
    for r, text in enumerate(texts):
        sys.stdout.write(text if r == 0 else "".join(
            line for line in text.splitlines(True) if line.startswith("  rank")))


def multi_host(card: str) -> dict:
    """Phase 13: multi-host mode as two ranks on the one card, joined through
    a coordinator on a free local port. Returns the kernel launches of their
    counted steps, added over the ranks."""
    import socket

    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    with tempfile.TemporaryDirectory(prefix="cdlrm_mh_") as tmp:
        run_rank_processes(lambda r: ("--mh-rank", str(r), port, tmp), MH_WORLD,
                           MH_TIMEOUT_S, tmp)
        results = []
        for r in range(MH_WORLD):
            with open(os.path.join(tmp, f"mh_rank{r}.json")) as f:
                results.append(json.load(f))
    launches = {name: sum(res["launches"][name] for res in results) for name in KERNELS}
    print(f"[{card}] phase 13: both ranks exited 0; kernel launches of their counted steps, "
          f"both ranks: {launches}")
    assert all(launches[name] > 0 for name in KERNELS), launches
    return {"launches": launches}


# Phase 14: the hot tier (n) on (d)'s flags and the sorted wire (o) on (c)'s.
# At H = HOT_ROWS the hot list's pads stay inside the last table's aux rows
# (BATCH of them), so the duplicated pad that a short list can put on a way
# row is checked at a small shape of its own (check_hot_pad)
HOT_ROWS = 4096
# a step with and without the hot tier, or on the sorted and the default
# unique layout, from the same state on the card: the same sums in another
# order (the hot and cold adds against the unique-row add; the atomics of the
# gather backward), so the caches lie within HOT_TOL of each other relative
# to the cache's largest value, the parameters within HOT_TOL relative and
# 1e-6 absolute (tests/test_torch_hot_tier.py's tolerance for the dense
# parameters), the sorted and unsorted caches within ADD_TOL absolute
HOT_TOL = 1e-5


def _clone_state(tr) -> tuple:
    from cdlrm_tpu_torch.models.dlrm import map_params

    return map_params(lambda t: t.clone(), tr.params), tr.cache.clone()


def _params_close(a, b, rtol: float, atol: float) -> float:
    """max |a - b| over the parameters, asserting |a - b| <= atol + rtol |b|."""
    from cdlrm_tpu_torch.models.dlrm import param_leaves

    worst = 0.0
    for x, y in zip(param_leaves(a), param_leaves(b)):
        diff = (x - y).abs()
        assert bool((diff <= atol + rtol * y.abs()).all()), float(diff.max())
        worst = max(worst, float(diff.max()))
    return worst


def check_hot_pad(card: str, dev: torch.device) -> None:
    """_hot_cold_update on the card against the CPU at a small shape whose
    hot list holds one row twice: tests/test_torch_hot_tier.py's geometry (3
    tables, 37 sets, 4 ways, 8 aux rows), 4 selected rows padded as the
    trainer pads a short list, so that pads run past the last table's aux
    rows onto its way rows, one of which is selected. Integer gradients and
    cache values and lr 0.5 make every sum exact in any order, so the card's
    atomics must give the CPU's bits: a repeated row that lost its update
    in a race would not."""
    from cdlrm_tpu_torch.cache.geometry import CacheGeometry
    from cdlrm_tpu_torch.train import step as step_lib

    geo = CacheGeometry.build([60, 30, 80], DIM, 32, 4, 8)
    rng = np.random.default_rng(SEED + 14)
    trash, h, n_sel = geo.trash_row, 16, 4
    pads = (trash - 1 - np.arange(h - 1 - n_sel)) % trash
    ways = np.concatenate([np.arange(geo.table_offsets[t], geo.aux_base(t)) for t in range(3)])
    twice = np.intersect1d(pads, ways)[:1]
    sel = np.concatenate([twice, rng.choice(np.setdiff1d(ways, pads), n_sel - 1, replace=False)])
    hot = np.sort(np.concatenate([sel, pads, [trash]])).astype(np.int32)
    assert np.unique(hot).size == h - 1, hot
    n = 4096
    kind = rng.random(n)
    flat = np.where(kind < 0.5, rng.choice(sel, n),
                    np.where(kind < 0.85, rng.integers(0, trash, n), trash)).astype(np.int32)
    drows = rng.integers(-8, 9, (n, DIM)).astype(np.float32)
    drows[flat == trash] = 0.0
    cache = rng.integers(-100, 101, (geo.total_rows, DIM)).astype(np.float32)
    touched = (rng.random(geo.total_rows) < 0.1).astype(np.uint8)
    touched[trash] = 0
    cold = int((~np.isin(flat, hot)).sum())
    cfg = step_lib.StepConfig(hot_rows=h, cold_bucket=1 << int(np.ceil(np.log2(cold))))
    out = {}
    for where in (dev, torch.device("cpu")):
        c = torch.from_numpy(cache.copy()).to(where)
        t = torch.from_numpy(touched.copy()).to(where)
        step_lib._hot_cold_update(c, t, torch.from_numpy(flat).to(where),
                                  torch.from_numpy(drows).to(where),
                                  torch.from_numpy(hot).to(where), 0.5, cfg, trash)
        out[where.type] = (c.cpu(), t.cpu())
    (c_dev, t_dev), (c_cpu, t_cpu) = out[dev.type], out["cpu"]
    row = int(twice[0])
    moved = float((c_cpu[row] - torch.from_numpy(cache[row])).abs().max())
    assert moved > 0, "the repeated hot row took no update"
    assert torch.equal(c_dev, c_cpu), float((c_dev - c_cpu).abs().max())
    assert torch.equal(t_dev, t_cpu), "touched masks differ"
    print(f"[{card}] _hot_cold_update with hot row {row} twice in a list of {h} "
          f"({int((flat == row).sum())} of {n} lanes on it, {cold} cold lanes, bucket "
          f"{cfg.cold_bucket}), D={DIM}: cache and touched mask bit-equal to the CPU's "
          f"(integer data: exact sums in any order)")


def _cold_lanes(inputs, hot_slots: torch.Tensor, sorted_wire: bool) -> int:
    """The cold lookups of one staged dedup batch: lanes whose row is not in
    the hot list."""
    from cdlrm_tpu_torch.train import step as step_lib

    uniq, ginv = step_lib._decode_dedup_raw(inputs[1], inputs[3], inputs[4], sorted_wire)
    flat = uniq[ginv.long()].contiguous()
    pos = torch.searchsorted(hot_slots, flat).clamp_(max=hot_slots.shape[0] - 1)
    return int((hot_slots[pos] != flat).sum())


def check_hot(card: str, tr, ds, total: int) -> dict:
    """Run (n)'s checks over its last trained batches (resident ids; the
    pipeline threads are stopped): one step with and without the hot tier
    from the same state on the card; one block of CHECK_BLOCK hot steps on
    the card against the port on the CPU; the block's device time beside
    the same steps without the hot tier."""
    from cdlrm_tpu_torch.train import step as step_lib

    batches = list(itertools.islice(ds.batches(), total))[-CHECK_BLOCK:]
    items = [tr._assemble(b, BATCH) for b in batches]
    assert all(dedup for _, _, dedup, _ in items), "the hot run left the dedup wire"
    hot_slots = tr._hot_slots_dev
    colds = [_cold_lanes(it[0], hot_slots, False) for it in items]
    assert max(colds) <= tr._cold_bucket_window, (colds, tr._cold_bucket_window)
    off_cfg = tr.step_cfg._replace(dedup=True)
    # one step, hot and not, from the same state
    p_hot, c_hot = _clone_state(tr)
    p_off, c_off = _clone_state(tr)
    reset_launches()
    p_hot, c_hot, l_hot, _ = tr._get_step(1, True)(p_hot, c_hot, *items[0][0], hot_slots,
                                                   tr._lr, tr._lr_emb)
    torch.cuda.synchronize()
    hot_launches = read_launches()
    p_off, c_off, l_off, _ = step_lib.make_cached_train_step(tr.geo, off_cfg, tr.pooled_width)(
        p_off, c_off, *items[0][0], tr._lr, tr._lr_emb)
    cache_rel = float((c_hot - c_off).abs().max()) / float(c_off.abs().max())
    param_err = _params_close(p_hot, p_off, HOT_TOL, 1e-6)
    loss_err = abs(float(l_hot) - float(l_off)) / BATCH
    assert cache_rel <= HOT_TOL and loss_err <= HOT_TOL, (cache_rel, loss_err)
    del p_hot, c_hot, p_off, c_off
    # one block against the CPU
    args = [a for it in items for a in it[0]]
    step = tr._get_step(CHECK_BLOCK, True)
    params_cpu, cache_cpu = _cpu_copy(tr.params), tr.cache.to("cpu", copy=True)
    p_dev, c_dev, l_dev, _ = step(tr.params, tr.cache, *args, hot_slots, tr._lr, tr._lr_emb)
    p_cpu, c_cpu, l_cpu, _ = step(params_cpu, cache_cpu, *[a.cpu() for a in args],
                                  hot_slots.cpu(), tr._lr, tr._lr_emb)
    assert l_dev.shape == (CHECK_BLOCK,) and bool(torch.isfinite(c_dev).all())
    cache_err = _max_row_err(c_dev, c_cpu)
    block_param_err = _max_param_err(p_dev, p_cpu)
    block_loss_err = float((l_dev.cpu() - l_cpu).abs().max()) / BATCH
    del c_cpu, cache_cpu
    assert max(cache_err, block_param_err, block_loss_err) <= SCORE_TOL, (
        cache_err, block_param_err, block_loss_err)
    block_ms = time_ms(lambda: step(tr.params, tr.cache, *args, hot_slots, tr._lr, tr._lr_emb),
                       10)
    off_block = step_lib.make_cached_train_step(tr.geo, off_cfg, tr.pooled_width,
                                                block=CHECK_BLOCK)
    off_ms = time_ms(lambda: off_block(tr.params, tr.cache, *args, tr._lr, tr._lr_emb), 10)
    print(f"  hot list: {int((hot_slots != tr.geo.trash_row).sum())} rows of H={tr._hot} "
          f"(the last the trash row), cold bucket {tr._cold_bucket_window}; cold lookups in "
          f"the {CHECK_BLOCK} checked steps {colds} of {items[0][0][1].numel()}; one step "
          f"with and without the hot tier from the same state: max |cache difference| / "
          f"max |cache| {cache_rel:.3e}, |param difference| {param_err:.3e}, |loss "
          f"difference| {loss_err:.3e} (tolerance {HOT_TOL}); kernel launches of the one hot "
          f"step {hot_launches}")
    print(f"  one block of {CHECK_BLOCK} hot steps vs the CPU run: max |cache difference| "
          f"{cache_err:.3e}, |param difference| {block_param_err:.3e}, |loss difference| "
          f"{block_loss_err:.3e} (tolerance {SCORE_TOL}); device time {block_ms:.3f} ms by "
          f"events, the same {CHECK_BLOCK} steps without the hot tier {off_ms:.3f} ms")
    return dict(step_launches=hot_launches, block_ms=block_ms, per_step_ms=off_ms)


def check_sorted(card: str, tr, ds, total: int) -> dict:
    """Run (o)'s check after check_block: the last trained batch staged on
    the sorted and on the default layout, one step of each from the same
    state on the card."""
    from cdlrm_tpu_torch.train import step as step_lib

    batch = list(itertools.islice(ds.batches(), total))[-1]
    staged = {}
    for srt in (True, False):
        tr._sorted_wire = srt
        inputs, _, dedup, _ = tr._assemble(batch, BATCH)
        assert dedup
        staged[srt] = inputs
    tr._sorted_wire = True
    assert not torch.equal(staged[True][3], staged[False][3]), "the layouts should differ"
    res, steps = {}, {}
    for srt in (True, False):
        steps[srt] = step = step_lib.make_cached_train_step(
            tr.geo, tr.step_cfg._replace(dedup=True, sorted_wire=srt), tr.pooled_width)
        params, cache = _clone_state(tr)
        reset_launches()
        params, cache, loss, _ = step(params, cache, *staged[srt], tr._lr, tr._lr_emb)
        torch.cuda.synchronize()
        res[srt] = (params, cache, float(loss), read_launches())
    (p_s, c_s, l_s, launches), (p_u, c_u, l_u, _) = res[True], res[False]
    cache_err = float((c_s - c_u).abs().max())
    param_err = _params_close(p_s, p_u, HOT_TOL, 1e-6)
    loss_err = abs(l_s - l_u) / BATCH
    assert cache_err <= ADD_TOL and loss_err <= HOT_TOL, (cache_err, loss_err)
    del res, p_s, c_s, p_u, c_u
    # the two steps' device times, interleaved, each on a state of its own
    # that its repeated steps move on
    states = {srt: _clone_state(tr) for srt in (True, False)}
    ms_s, ms_u = time_pair("one step, sorted/default layout", card,
                           lambda: steps[True](*states[True], *staged[True], tr._lr, tr._lr_emb),
                           lambda: steps[False](*states[False], *staged[False], tr._lr,
                                                tr._lr_emb), what="sorted/default")
    del states
    print(f"  one step on the sorted and on the default layout from the same state: max "
          f"|cache difference| {cache_err:.3e} (tolerance {ADD_TOL}), |param difference| "
          f"{param_err:.3e}, |loss difference| {loss_err:.3e}; device step {ms_s:.3f} and "
          f"{ms_u:.3f} ms by events (medians of {TIMING_ROUNDS} interleaved rounds); kernel "
          f"launches of the one sorted step {launches}")
    return dict(step_launches=launches)


def hot_and_sorted(card: str, dev: torch.device, runs: dict) -> dict:
    """Phase 14: (n) the hot tier (``hot_tier_rows`` HOT_ROWS) on (d)'s flags,
    which the hot tier matches (it turns the coalesced update off under
    'auto'), and (o) the sorted unpacked dedup wire on (c)'s flags, coalesced;
    40 counted steps each, examples/s beside (d)'s and (c)'s of this call."""
    t0 = time.perf_counter()
    check_hot_pad(card, dev)
    torch.cuda.empty_cache()
    n = block_run(card, dev, "auto", label="n", check=check_hot, hot_tier_rows=HOT_ROWS)
    torch.cuda.empty_cache()
    o = block_run(card, dev, "auto", label="o", check=check_sorted, sorted_dedup_wire=True)
    hot_rows, worst_cold, buckets = zip(*n["windows"])
    print(f"[{card}] phase 14, examples/s of this call: (n) hot tier {n['examples_s']:.1f} "
          f"against (d) {runs['d']['examples_s']:.1f}; (o) sorted wire {o['examples_s']:.1f} "
          f"against (c) {runs['c']['examples_s']:.1f}; (n)'s counted windows: hot rows "
          f"{list(hot_rows)}, worst cold lookups of a step {list(worst_cold)}, cold buckets "
          f"{list(buckets)}; kernel launches of one step: hot tier {n['step_launches']}, "
          f"sorted wire {o['step_launches']}; phase 14 took {time.perf_counter() - t0:.1f} s")
    ln, lo = n["launches"], o["launches"]
    # (n): three atomic adds a step (hot segment sum, H-row apply, cold add)
    # and no unique-row add; (o): as (c)
    assert ln["index_add_rows"] == 3 * BLOCK_STEPS and ln["scatter_add_rows"] == 0, ln
    assert lo["scatter_add_rows"] == o["blocks"] and lo["index_add_rows"] == BLOCK_STEPS, lo
    for launches in (ln, lo):
        assert launches["gather_rows"] > 0 and launches["scatter_set_rows"] > 0, launches
    assert n["step_launches"] == {"gather_rows": 3, "scatter_set_rows": 1, "scatter_add_rows": 0,
                                  "index_add_rows": 3}, n["step_launches"]
    return {"n": n, "o": o}


# Phase 15: the port's harnesses at their headline defaults, in this process
BENCH_POSITIVE = ("value", "device_step_ms", "block_step_ms_per_iter", "eval_examples_per_sec",
                  "steady_state_examples_per_sec", "ms_per_iter", "h2d_bytes_per_step")
BENCH_KEYS = BENCH_POSITIVE + (
    "metric", "unit", "hit_rate", "caching_overhead_ms_per_iter", "block_coalesced",
    "block_union_host_ms", "eval_hit_rate", "steady_state_ms_per_iter",
    "steady_state_caching_overhead_ms_per_iter", "steady_lookahead", "steady_refills",
    "timed_steps", "backend", "config", "device", "window_examples_per_sec", "launches")
BREAKDOWN_COMPONENTS = ("gather_uniq", "expand_take", "pend_scatter", "cache_scatter",
                        "flush_scatter", "dense_fwdbwd")


def harnesses(card: str) -> dict:
    """Phase 15: ``run({})`` of bench_torch.py (the headline, the device step
    and block, serving and the steady-state regime), of
    bench_step_breakdown_torch.py and of bench_serving_ab_torch.py, on the
    card in this process. Prints each record after the card line, checks its
    contract, and counts each run's kernel launches from 0."""
    import bench_serving_ab_torch
    import bench_step_breakdown_torch

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    recs = {}
    for mod in (bench_torch, bench_step_breakdown_torch, bench_serving_ab_torch):
        t0 = time.perf_counter()
        reset_launches()
        rec = mod.run({})
        launches = read_launches()
        torch.cuda.empty_cache()
        print(f"{card} {json.dumps(rec)}")
        print(f"[{card}] phase 15: {mod.__name__}.run({{}}) took {time.perf_counter() - t0:.1f} s")
        assert rec["backend"] == "cuda" and rec["device"] == card, (rec["backend"], rec["device"])
        assert rec["launches"] == launches, (rec["launches"], launches)
        for name in KERNELS:
            total[name] += launches[name]
        recs[mod.__name__] = rec
    b = recs["bench_torch"]
    missing = [k for k in BENCH_KEYS if k not in b]
    assert not missing and "vs_baseline" not in b, missing
    assert b["metric"] == "cached_dlrm_train_examples_per_sec_per_chip", b["metric"]
    assert all(b[k] > 0 for k in BENCH_POSITIVE), {k: b[k] for k in BENCH_POSITIVE}
    assert b["steady_refills"] >= 3 and b["timed_steps"] == 40, b
    assert min(b["window_examples_per_sec"][k] for k in ("min", "median", "max")) > 0, b
    br = recs["bench_step_breakdown_torch"]
    assert br["metric"] == "step_breakdown", br["metric"]
    assert all(br["components"][c] > 0 for c in BREAKDOWN_COMPONENTS), br["components"]
    assert br["block_step_ms_per_iter"] > 0 and br["block_coalesced"] is True, br
    sv = recs["bench_serving_ab_torch"]
    assert sv["metric"] == "serving_pipeline_ab", sv["metric"]
    assert sv["serial_examples_per_sec"] > 0 and sv["pipelined_examples_per_sec"] > 0, sv
    assert all(total[name] > 0 for name in KERNELS), total
    print(f"[{card}] phase 15: the three harnesses' contracts hold; kernel launches {total}; "
          f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total, "records": recs}


def more_harnesses(card: str) -> dict:
    """Phase 16: bench_block_ab_torch.py (both streams), bench_pressure_torch.py
    (the oracle and the three capacity points), bench_collectives_torch.py (two
    ranks sharing cuda:0 over gloo, whose byte counts must equal two CPU
    ranks') and bench_scaling_torch.py (``--hosts 2`` on the card). Prints each
    record after the card line, checks its contract, and counts each run's
    kernel launches from 0: in this process for the first two, in the ranks'
    processes (summed by the harness) for the last two."""
    import bench_block_ab_torch
    import bench_collectives_torch
    import bench_pressure_torch
    import bench_scaling_torch

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    recs = {}

    def counted(name, fn, in_process):
        t0 = time.perf_counter()
        reset_launches()
        rec = fn()
        launches = read_launches()
        torch.cuda.empty_cache()
        if in_process:
            assert rec["launches"] == launches, (name, rec["launches"], launches)
        else:
            assert launches == dict.fromkeys(KERNELS, 0), (name, launches)
        for kernel in KERNELS:
            total[kernel] += rec["launches"][kernel]
        recs[name] = rec
        print(f"[{card}] phase 16: {name} took {time.perf_counter() - t0:.1f} s; kernel launches "
              f"{rec['launches']}")
        return rec

    ab = counted("block_ab", lambda: bench_block_ab_torch.run({}), True)
    for line in ab["streams"]:
        print(f"{card} {json.dumps(line)}")
        assert line["backend"] == "cuda" and line["device"] == card, line
        assert line["per_step_ms_A_dedup"] > 0 and line["per_step_ms_B_coalesced"] > 0, line
        assert line["N"] == 26 * 4096, line
        errs = line["check_max_err"]
        assert {"A_vs_B", "A_vs_A_plain", "B_vs_B_plain"} <= set(errs), errs
        assert max(errs.values()) <= bench_block_ab_torch.CHECK_TOL, errs
    assert [ln["stream"] for ln in ab["streams"]] == list(bench_block_ab_torch.STREAMS)
    # neither arm sets rows (the reference's neither): the row set is the
    # pressure runs' (aux staging, refill insert)
    assert all(ab["launches"][k] > 0 for k in ("gather_rows", "scatter_add_rows",
                                               "index_add_rows")), ab["launches"]

    pr = counted("pressure", lambda: bench_pressure_torch.run({}), True)
    print(f"{card} {json.dumps(pr)}")
    assert pr["metric"] == "pressure_auc_gap" and pr["backend"] == "cuda", pr
    assert pr["steps"] == 240 and pr["device"] == card, pr
    assert [c["capacity_frac"] for c in pr["cached"]] == [0.3, 0.1, 0.03], pr["cached"]
    aucs = [pr["oracle"]["auc"]] + [c["auc"] for c in pr["cached"]]
    assert all(np.isfinite(aucs)), aucs
    hardest = pr["cached"][-1]
    assert pr["pressure_real"] is True, hardest
    assert hardest["hit_rate"] < 0.99 and hardest["rows_written"] > 0, hardest
    assert all(pr["launches"][k] > 0 for k in KERNELS), pr["launches"]

    co = counted("collectives", lambda: bench_collectives_torch.run(
        {}, backend="cuda", worlds=(2,)), False)
    co_cpu = bench_collectives_torch.run({}, backend="cpu", worlds=(2,))
    for line in co["lines"]:
        print(f"{card} {json.dumps(line)}")
    print(f"{card} {json.dumps({'ratios': co['ratios'], 'launches': co['launches']})}")
    assert co["lines"] == co_cpu["lines"], (co["lines"], co_cpu["lines"])
    assert co["device"] == card and co["ratios"]["refill_strict_over_delta"] == 210.0, co

    sc = counted("scaling", lambda: bench_scaling_torch.run({}, hosts=2, backend="cuda"), False)
    for line in sc["lines"]:
        print(f"{card} {json.dumps(line)}")
    single, multi, eff = sc["lines"]
    assert single["examples_per_sec"] > 0 and multi["examples_per_sec"] > 0, sc["lines"]
    assert eff["value"] > 0 and "lower bound" in eff["note"] and eff["device"] == card, eff
    assert sc["launches"]["gather_rows"] > 0 and sc["launches"]["scatter_set_rows"] > 0, sc

    assert all(total[k] > 0 for k in KERNELS), total
    print(f"[{card}] phase 16: the four harnesses' contracts hold; kernel launches {total}; "
          f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total, "records": recs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1 and sys.argv[1] == "--dp-rank":
        return dp_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if len(sys.argv) > 1 and sys.argv[1] == "--mh-rank":
        return mh_rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    from cdlrm_tpu_torch.cache.geometry import CacheGeometry
    from cdlrm_tpu_torch.ops import _build, native

    t_main = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 matmuls in float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    print(f"[{card}] kernel library (csrc/row_ops.cu, nvcc) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    assert native.available(), "the host library (csrc/host_ops.cpp) did not build"
    print(f"host library (csrc/host_ops.cpp, g++) built and loaded in "
          f"{time.perf_counter() - t0:.2f} s, {native.num_threads()} threads")

    rows = CacheGeometry.build(
        [ROWS] * TABLES, DIM, CACHE_SETS, WAYS, BATCH
    ).total_rows  # the serving cache's row count
    kernels = check_kernels(card, rows, dev)
    torch.cuda.empty_cache()
    served = serve(card, dev)
    run_cli(dev)
    runs = train(card, dev)
    torch.cuda.empty_cache()
    full = fulltable(card, dev)
    runs.update(adagrad(card, dev))
    torch.cuda.empty_cache()
    full_ag = fulltable_adagrad(card, dev)
    runs.update(wire_and_md(card, dev, runs["b"]))
    torch.cuda.empty_cache()
    runs["i"] = fulltable_tricks(card, dev, "qr")
    runs["j"] = fulltable_tricks(card, dev, "md")
    runs["profiled"] = profiled_run(card, dev)
    torch.cuda.empty_cache()
    runs["two_ranks"] = two_ranks(card, rows, dev)
    runs["multi_host"] = multi_host(card)
    torch.cuda.empty_cache()
    runs.update(hot_and_sorted(card, dev, runs))
    torch.cuda.empty_cache()
    runs["harnesses"] = harnesses(card)
    torch.cuda.empty_cache()
    runs["more_harnesses"] = more_harnesses(card)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "cdlrm_tpu")]
    assert not loaded, f"the port imported {loaded}"
    print(f"[{card}] every phase passed in {time.perf_counter() - t_main:.1f} s, the builds "
          f"included")

    sources = {"gather_rows": "cdlrm_tpu/ops/lookup.py:70",
               "scatter_set_rows": "cdlrm_tpu/ops/scatter.py:257",
               "scatter_add_rows": "cdlrm_tpu/ops/scatter.py:211",
               "index_add_rows": "cdlrm_tpu/ops/lookup.py:99"}
    # launches: the sum over the main-path runs (serving, training a to h,
    # full-table training with SGD, AdaGrad, QR and MD, the profiled run, the
    # two ranks' runs k and l and the multi-host run m as their processes
    # counted them, the hot-tier run n and the sorted-wire run o, phase 15's
    # three harnesses and phase 16's four), each counted from 0
    launches = {name: served[name] + full["launches"][name] + full_ag["launches"][name]
                + sum(run["launches"][name] for run in runs.values())
                for name in KERNELS}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "cdlrm_tpu_torch/csrc/row_ops.cu",
         "replaces": sources[name], "launches": launches[name], **kernels[name]}
        for name in KERNELS
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
