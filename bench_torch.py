#!/usr/bin/env python3
"""Headline benchmark of cdlrm_tpu_torch: cached-DLRM training throughput on
one CUDA card.

The port's counterpart of bench.py, on the same geometry, flags, id streams
and measured regions: 26 tables of 250,000 rows, dim 128, bottom MLP
13-512-256-128, top MLP 512-256-1, batch 4096, a cache of 16,384 sets x 8
ways, bfloat16 compute, procedural (virtual) masters, scan blocks of 10, 10
warm-up and 40 timed steps in one lookahead window that covers the whole
stream (so the timed region holds no refill; the refill time of a window is
reported apart, as the reference's printout does).

The line holds:

- ``value``: examples/s of ``trainer.train`` over the timed print windows
  (the trainer's own host clock; a window ends in a copy of its losses, so
  the device has finished its steps); beside it the minimum, median and
  maximum over those windows;
- ``device_step_ms``: one train step called 30 times back to back on reused
  inputs, ``block_step_ms_per_iter``: a scan block of 10 called 6 times (the
  coalesced block where the wire allows it), both per step, from one pair of
  CUDA events around the calls and one synchronize;
- ``eval_examples_per_sec``: the pipelined ``evaluate`` over 10 held-out
  batches (host clock; its last batch's scores are on the host when it
  returns);
- ``steady_state_*``: a second trainer at lookahead 5 on the bfloat16 row
  wire, 40 steps in print windows of 10, so that refills fall inside the
  timed region: examples / (step + amortised refill);
- ``launches``: each hand-written kernel's launches over the whole run, from
  the wrappers' ``.launches`` counters.

Run from the repository root:

    python3 bench_torch.py                 # on cuda:0
    BENCH_CPU=1 python3 bench_torch.py     # bench.py's scaled-down geometry
                                           # on the CPU: a smoke of the flow,
                                           # never a number to report

Without a card and without ``BENCH_CPU`` it exits 1. The knobs are bench.py's,
with its meaning and polarity: ``BENCH_DEDUP`` (auto|on|off, 1|0),
``BENCH_SCAN`` (scan steps, default 10), ``BENCH_FP8=1`` (float8 dense
wire), ``BENCH_HOT=<rows>`` (hot tier), ``BENCH_PACK=0`` (unpacked wires),
``BENCH_BLOCK`` (auto|1|0: the block-coalesced update), ``BENCH_OPT``
(sgd|adagrad), ``BENCH_SORTED=1`` (sorted unpacked dedup wire),
``BENCH_PRESTAGE=0`` (refill prestage off), ``BENCH_BATCH`` (the card's
batch), ``BENCH_STREAM`` (loguniform|uniform|zipfNN), ``BENCH_SKIP_EXTRAS=1``
(headline and device step only). The last line of standard output is one
JSON object.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

METRIC = "cached_dlrm_train_examples_per_sec_per_chip"
KERNELS = ("gather_rows", "scatter_set_rows", "scatter_add_rows", "index_add_rows")


def log(msg: str) -> None:
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _wrappers() -> dict:
    from cdlrm_tpu_torch.ops import lookup, scatter

    return {name: getattr(lookup, name, None) or getattr(scatter, name) for name in KERNELS}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def device_for(cpu: bool, what: str, cpu_var: str):
    """cuda:0, or the CPU when ``cpu_var`` asked for it; no card and no such
    request is an error (nothing falls back)."""
    import torch

    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; set {cpu_var}=1 for the scaled-down "
                           "geometry on the CPU")
    return torch.device("cuda", 0)


def launch_ranks(argvs: list, log_dir: str, timeout_s: float, grace_s: float = 2.0) -> list:
    """Start one Python process per argument list (one rank each), its
    output to ``log_dir/rank<r>.log``, and wait for all of them. A rank that
    exits with a non-zero code ends the others after ``grace_s`` (a peer that
    failed on its closed connections writes its own error meanwhile); the
    time limit ends them at once. Returns each rank's log; raises with the
    logs when any rank did not exit 0. No process is left running."""
    paths = [os.path.join(log_dir, f"rank{r}.log") for r in range(len(argvs))]
    logs = [open(path, "w") for path in paths]
    procs = []
    try:
        for argv, out in zip(argvs, logs):
            procs.append(subprocess.Popen([sys.executable, *argv], stdout=out,
                                          stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + grace_s)
            if time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
        for out in logs:
            out.close()
    texts = []
    for path in paths:
        with open(path) as f:
            texts.append(f.read())
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}\n" + "\n".join(
            f"--- rank {r} ---\n{t[-3000:]}" for r, t in enumerate(texts)))
    return texts


class DeviceClock:
    """Milliseconds of the work enqueued inside the ``with`` block: one pair
    of CUDA events around it and one synchronize at its end, on the card;
    the host clock on the CPU."""

    def __init__(self, dev):
        self.dev = dev
        self.ms = 0.0

    def __enter__(self):
        import torch

        if self.dev.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self._end.record()
            self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = 1e3 * (time.perf_counter() - self._t0)
        return False


def synchronize(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class ZipfDataset:
    """bench.py's skewed single-index stream (bench.py:160-199), the same
    draws from the same generator: ``loguniform`` (``exp(u ln rows) - 1``,
    moderate Criteo-like head concentration), ``uniform`` (near-unique ids)
    or ``zipfNN`` (zipf with exponent NN / 10, wrapped into the table)."""

    m_den = 13

    def __init__(self, ln_emb, batch: int, num_batches: int, stream: str = "loguniform",
                 seed: int = 0):
        self.ln_emb = np.asarray(ln_emb)
        self.batch, self.num_batches = batch, num_batches
        self.stream, self.seed = stream, seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        from cdlrm_tpu_torch.data.synthetic import Batch

        num_tables, batch, stream = len(self.ln_emb), self.batch, self.stream
        table_rows = int(self.ln_emb[0])  # every table has bench.py's one size
        rng = np.random.Generator(np.random.SFC64(self.seed))
        for _ in range(self.num_batches):
            x = rng.random((batch, 13), dtype=np.float32)
            if stream.startswith("zipf"):
                a = float(stream[4:]) / 10.0
                idx = (rng.zipf(a, size=(num_tables, batch)) - 1) % table_rows
            elif stream == "uniform":
                idx = rng.integers(0, table_rows, size=(num_tables, batch))
            else:
                u = rng.random((num_tables, batch), dtype=np.float32)
                idx = np.exp(u * np.log(table_rows)).astype(np.int64) - 1
                np.minimum(idx, table_rows - 1, out=idx)
            y = np.round(rng.random((batch, 1), dtype=np.float32))
            yield Batch(x, idx, None, y)


def geometry(env: dict) -> dict:
    """bench.py's headline geometry on the card (bench.py:65-73), or its
    scaled-down one on the CPU (:74-79)."""
    if env.get("BENCH_CPU"):
        return dict(cpu=True, tables=8, dim=32, batch=512, rows=20_000, cache_size=2_048,
                    ways=4, bot="13-64-32", top="64-32-1", steps=20, warmup=5,
                    ss_lookahead=4, ss_print=8, ss_steps=32)
    return dict(cpu=False, tables=26, dim=128, batch=int(env.get("BENCH_BATCH", 4096)),
                rows=250_000, cache_size=16_384, ways=8, bot="13-512-256-128",
                top="512-256-1", steps=40, warmup=10, ss_lookahead=5, ss_print=10,
                ss_steps=40)


def _mode(env: dict, key: str) -> str:
    """An auto|on|off knob; '1' and '0' name on and off."""
    v = env.get(key, "auto")
    return {"1": "on", "0": "off"}.get(v, v)


def config_kwargs(env: dict, geo: dict) -> dict:
    """The headline trainer's Config keyword arguments (bench.py:81-157),
    the same for either package's Config."""
    return dict(
        arch_sparse_feature_size=geo["dim"], arch_mlp_bot=geo["bot"], arch_mlp_top=geo["top"],
        mini_batch_size=geo["batch"], world_size=1, cache_size=geo["cache_size"],
        num_ways=geo["ways"], loss_function="bce",
        lookahead=geo["steps"] + geo["warmup"] + 4,  # one window covers the run
        table_agg_freq=1_000_000, print_freq=1_000_000, round_targets=True,
        compute_dtype="bfloat16", batch_fifo_size=4, master_init="virtual",
        dedup_lookups=_mode(env, "BENCH_DEDUP"),
        scan_steps=int(env.get("BENCH_SCAN", "10")),
        wire_x_fp8=env.get("BENCH_FP8", "0") == "1",
        hot_tier_rows=int(env.get("BENCH_HOT", "0")),
        pack_wire=env.get("BENCH_PACK", "1") == "1",
        block_coalesced_update=_mode(env, "BENCH_BLOCK"),
        optimizer=env.get("BENCH_OPT", "sgd"),
        sorted_dedup_wire=env.get("BENCH_SORTED", "0") == "1",
        refill_prestage=env.get("BENCH_PRESTAGE", "1") == "1",
    )


def steady_config_kwargs(cfg, geo: dict) -> dict:
    """The steady-state regime's Config keyword arguments (bench.py:372-405),
    from the finalized headline config: lookahead 5 (4 on the CPU), the
    bfloat16 row wire, the headline's wire knobs."""
    return dict(
        arch_sparse_feature_size=geo["dim"], arch_mlp_bot=geo["bot"], arch_mlp_top=geo["top"],
        mini_batch_size=geo["batch"], world_size=1, cache_size=geo["cache_size"],
        num_ways=geo["ways"], loss_function="bce", lookahead=geo["ss_lookahead"],
        table_agg_freq=1_000_000, print_freq=geo["ss_print"], round_targets=True,
        compute_dtype="bfloat16", batch_fifo_size=4, master_init="virtual",
        dedup_lookups=cfg.dedup_lookups, scan_steps=min(cfg.scan_steps, geo["ss_lookahead"]),
        wire_x_fp8=cfg.wire_x_fp8, wire_rows_bf16=True, pack_wire=cfg.pack_wire,
        refill_prestage=cfg.refill_prestage, block_coalesced_update=cfg.block_coalesced_update,
    )


def device_step_ms(trainer, ds, dev, iters: int = 30):
    """One train step on reused inputs (bench.py:229-262), called ``iters``
    times back to back after a warm call: (ms per step, bytes of the staged
    inputs)."""
    b0 = next(iter(ds.batches()))
    inputs, _, dedup, _ = trainer._assemble(b0, trainer.cfg.local_batch_size)
    h2d = int(sum(a.nbytes for a in inputs))
    fn = trainer._get_step(1, dedup)
    lr, lr_emb, touched = trainer._lr, trainer._lr_emb, trainer.touched
    hot_extra = (trainer._hot_slots_dev,) if trainer._hot else ()
    state = [trainer.params, trainer.cache, trainer.dense_acc, trainer.embed_acc]

    def call():
        p, c, da, ea = state
        if trainer._adagrad:
            p, c, da, ea, loss, _ = fn(p, c, *inputs, da, ea, lr, lr_emb, touched=touched)
        else:
            p, c, loss, _ = fn(p, c, *inputs, *hot_extra, lr, lr_emb, touched=touched)
        state[:] = [p, c, da, ea]
        return loss

    float(call())  # warm, and the first call's work done
    with DeviceClock(dev) as clock:
        for _ in range(iters):
            call()
    trainer.params, trainer.cache, trainer.dense_acc, trainer.embed_acc = state
    return clock.ms / iters, h2d


def device_block_ms(trainer, ds, dev, iters: int = 6):
    """A scan block on reused inputs (bench.py:264-320), the coalesced one
    where the wire allows it, called ``iters`` times back to back: (ms per
    step, coalesced, host ms of the block union), or None when blocks are off,
    the optimizer is AdaGrad, or the dedup choice changed within the probe."""
    k = trainer._scan_block
    if k <= 1 or trainer._adagrad:
        return None
    gen = iter(ds.batches())
    items = [trainer._assemble(next(gen), trainer.cfg.local_batch_size) for _ in range(k)]
    dedup = items[0][2]
    if not all(it[2] == dedup for it in items):
        return None
    coalesce = bool(dedup and trainer._block_coalesce and all(it[3] is not None for it in items))
    fn = trainer._get_step(k, dedup, coalesce)
    hot_extra = (trainer._hot_slots_dev,) if trainer._hot else ()
    union_ms = 0.0
    if coalesce:
        t0 = time.perf_counter()
        ranks, blk_slots, blk_counts = trainer._build_block_union([it[3] for it in items])
        union_ms = 1e3 * (time.perf_counter() - t0)
        args = trainer.interleave_block_inputs([it[0] for it in items], ranks)
        args += [blk_slots, blk_counts]
    else:
        args = [a for it in items for a in it[0]]
    lr, lr_emb, touched = trainer._lr, trainer._lr_emb, trainer.touched
    state = [trainer.params, trainer.cache]

    def call():
        p, c, loss, _ = fn(*state, *args, *hot_extra, lr, lr_emb, touched=touched)
        state[:] = [p, c]
        return loss

    float(call().sum())
    with DeviceClock(dev) as clock:
        for _ in range(iters):
            call()
    trainer.params, trainer.cache = state
    return clock.ms / (iters * k), coalesce, union_ms


def _window_rates(timed: list, batch: int) -> dict:
    rates = [1000.0 * batch / w["ms_per_iter"] for w in timed]
    return {"min": round(min(rates), 1), "median": round(statistics.median(rates), 1),
            "max": round(max(rates), 1), "windows": len(rates)}


def _per_step(timed: list, key: str) -> float:
    return sum(w[key] * w["steps"] for w in timed) / max(1, sum(w["steps"] for w in timed))


def run(env: dict) -> dict:
    """The whole measurement at the knobs in ``env``; returns the line."""
    import torch

    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    geo = geometry(env)
    dev = device_for(geo["cpu"], "bench_torch", "BENCH_CPU")
    device = None if geo["cpu"] else card_line()
    batch, steps, warmup = geo["batch"], geo["steps"], geo["warmup"]
    stream = env.get("BENCH_STREAM", "loguniform")
    ln_emb = np.full(geo["tables"], geo["rows"], dtype=np.int64)
    cfg = Config(**config_kwargs(env, geo)).finalize(ln_emb=ln_emb)

    reset_launches()
    ds = ZipfDataset(ln_emb, batch, steps + warmup, stream)
    eval_ds = ZipfDataset(ln_emb, batch, 12, stream, seed=1)
    log(f"building trainer on {dev} (tables={geo['tables']}x{geo['rows']}, dim={geo['dim']}, "
        f"batch={batch}, stream={stream})")
    t0 = time.perf_counter()
    trainer = CachedDlrmTrainer(cfg, ds, eval_ds, device=dev)
    log(f"trainer ready in {time.perf_counter() - t0:.1f} s")
    # the first print window (compiles nothing here, but holds the window's
    # refill and the pipeline's start) is the warm-up; the rest are timed
    cfg.print_freq = warmup
    windows = []

    def capture(line):
        if trainer.last_window is not None:
            windows.append(dict(trainer.last_window))
        log(line)

    try:
        trainer.train(max_steps=warmup + steps, log_fn=capture)
        synchronize(dev)
        dstep_ms, h2d = device_step_ms(trainer, ds, dev)
        blk = device_block_ms(trainer, ds, dev)
        timed = windows[1:] if len(windows) > 1 else windows
        n_steps = sum(w["steps"] for w in timed)
        ms_per_iter = _per_step(timed, "ms_per_iter")
        w = windows[-1]
        head = {
            "metric": METRIC,
            "value": round(1000.0 * batch / ms_per_iter, 1),
            "unit": "examples/s",
            "window_examples_per_sec": _window_rates(timed, batch),
            "hit_rate": round(w["hit_rate"], 4),
            "ms_per_iter": round(ms_per_iter, 2),
            "caching_overhead_ms_per_iter": round(_per_step(timed, "caching_overhead_ms"), 2),
            "device_step_ms": round(dstep_ms, 2),
            "block_step_ms_per_iter": None if blk is None else round(blk[0], 2),
            "block_coalesced": None if blk is None else blk[1],
            "block_union_host_ms": None if blk is None else round(blk[2], 2),
        }
        if env.get("BENCH_SKIP_EXTRAS", "0") == "1":
            return dict(head, dedup_active=bool(w.get("dedup", False)), batch=batch,
                        stream=stream, hot_tier_rows=cfg.hot_tier_rows,
                        h2d_bytes_per_step=h2d, timed_steps=n_steps,
                        backend=dev.type, device=device, launches=read_launches())
        # serving: the pipelined evaluate over the held-out stream
        trainer.evaluate(max_batches=2, log_fn=lambda s: None)
        eval_batches = 10
        t0 = time.perf_counter()
        trainer.evaluate(max_batches=eval_batches, log_fn=lambda s: None)
        eval_eps = eval_batches * batch / (time.perf_counter() - t0)
        eval_hit = trainer.metrics.eval_hit_rate
    finally:
        trainer.close()

    # steady state: refills inside the timed region
    cfg_ss = Config(**steady_config_kwargs(cfg, geo)).finalize(ln_emb=ln_emb)
    log(f"steady-state regime: lookahead={geo['ss_lookahead']}, {geo['ss_steps']} steps")
    tr_ss = CachedDlrmTrainer(cfg_ss, ZipfDataset(ln_emb, batch, geo["ss_steps"] + 4, stream,
                                                  seed=2), device=dev)
    ss_windows = []

    def cap_ss(line):
        if tr_ss.last_window is not None:
            ss_windows.append(dict(tr_ss.last_window))
        log(f"[steady] {line}")

    try:
        tr_ss.train(max_steps=geo["ss_steps"], log_fn=cap_ss)
        synchronize(dev)
        ss_refills = tr_ss.metrics.refills
    finally:
        tr_ss.close()
    ss_timed = ss_windows[1:] if len(ss_windows) > 1 else ss_windows
    ss_ms = _per_step(ss_timed, "ms_per_iter")
    ss_overhead = _per_step(ss_timed, "caching_overhead_ms")
    return dict(
        head,
        eval_examples_per_sec=round(eval_eps, 1),
        eval_hit_rate=round(eval_hit, 4),
        steady_state_examples_per_sec=round(1000.0 * batch / max(1e-9, ss_ms + ss_overhead), 1),
        steady_state_ms_per_iter=round(ss_ms, 2),
        steady_state_caching_overhead_ms_per_iter=round(ss_overhead, 2),
        steady_lookahead=geo["ss_lookahead"],
        steady_refills=int(ss_refills),
        dedup_active=bool(w.get("dedup", False)),
        h2d_bytes_per_step=h2d,
        timed_steps=n_steps,
        backend=dev.type,
        device=device,
        launches=read_launches(),
        config={
            "tables": geo["tables"], "dim": geo["dim"], "batch": batch,
            "cache_sets": int(cfg.cache_sets), "ways": geo["ways"],
            "lookahead": cfg.lookahead, "compute_dtype": "bfloat16",
            "scan_steps": cfg.scan_steps, "x_wire": "fp8" if cfg.wire_x_fp8 else "bf16",
            "dedup": cfg.dedup_lookups, "dedup_active": bool(w.get("dedup", False)),
            "stream": stream, "hot_tier_rows": cfg.hot_tier_rows, "pack_wire": cfg.pack_wire,
            "block_coalesced": bool(cfg.block_coalesced_update),
            "torch": torch.__version__,
        },
    )


def main(run_fn=run, lines=None) -> int:
    """Print ``run_fn``'s line for the environment's knobs (this harness's
    ``run`` or a sibling's), or each of the lines ``lines`` takes from its
    record; without a card and without the CPU request, the message and exit
    code 1."""
    try:
        rec = run_fn(dict(os.environ))
    except RuntimeError as e:
        if "no CUDA device" not in str(e):
            raise
        print(e, file=sys.stderr)
        return 1
    for line in lines(rec) if lines else [rec]:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
