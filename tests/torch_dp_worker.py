"""Data-parallel and multi-host test worker: one rank of an N-process gloo
group of cdlrm_tpu_torch on the CPU.

Launched by tests/test_torch_dp.py, tests/test_torch_dp_trainer.py and
tests/test_torch_mh_trainer.py::

    python tests/torch_dp_worker.py RANK WORLD RENDEZVOUS_FILE SPEC.json OUT_DIR

The ranks meet through the rendezvous file (never a fixed port: several test
processes share one machine). ``SPEC.json`` holds a list of cases, each a
dict with a ``name``, a ``kind`` (a function of :data:`KINDS`) and its
arguments; every rank runs all of them in order on the one group and writes
``OUT_DIR/<name>.r<RANK>.npz``. The inputs of every case are made here from
numpy seeds, so the launching test makes the same ones for cdlrm_tpu by
importing this module, which imports neither jax nor cdlrm_tpu.
"""

import json
import os
import re
import sys
import threading
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from cdlrm_tpu_torch.data.synthetic import Batch  # noqa: E402

T, D, DEN = 3, 8, 13
STEP_LN_EMB = [64, 32, 128]


# --------------------------------------------------------------------------
# seeded inputs, shared with the launching tests
# --------------------------------------------------------------------------


class Stream:
    """A seeded synthetic stream with a learnable target (y depends on the
    first dense feature). ``skew`` draws ids from ``[0, skew)`` so lookups
    repeat; ``pooled`` > 0 gives multi-hot bags of that width with random
    masks (position 0 always valid).

    ``cycle`` > 0 (single-index only; tests/test_adagrad_master_state.py's
    _CycleStream for every table): window w of ``window`` batches draws, in
    every table, all the ``cycle`` ids of the range ``(w % 4) * cycle`` and
    no other. With ``cycle`` equal to the cache's sets times its ways, each
    refill claims every way of every set (the whole previous window evicts,
    nothing misses), and an id comes back four windows after its last use,
    after its writeback whenever the prefetcher runs at most a window ahead
    (``batch_fifo_size=1``)."""

    m_den = DEN

    def __init__(self, ln_emb, num_batches, batch, seed=0, pooled=0, skew=0, cycle=0,
                 window=0):
        self.ln_emb = np.asarray(ln_emb)
        self.num_batches, self.batch, self.seed = num_batches, batch, seed
        self.pooled, self.skew = pooled, skew
        self.cycle, self.window = cycle, window

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        t_count = len(self.ln_emb)
        for j in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            y = (x[:, :1] > 0.5).astype(np.float32)
            shape = (self.batch, self.pooled) if self.pooled else (self.batch,)
            if self.cycle:
                ls = np.stack([self._cycle_ids(j, t) for t in range(t_count)])
                yield Batch(x, ls, None, y)
                continue
            ls = np.stack([rng.integers(0, min(n, self.skew) if self.skew else n, shape)
                           for n in self.ln_emb])
            if not self.pooled:
                yield Batch(x, ls, None, y)
                continue
            mask = rng.random((t_count,) + shape) < 0.7
            mask[:, :, 0] = True
            yield Batch(x, ls, mask, y)


    def _cycle_ids(self, j, t):
        w, c = j // self.window, self.cycle
        wrng = np.random.default_rng([13, w, t])
        seq = np.concatenate([wrng.permutation(c),
                              wrng.integers(0, c, self.window * self.batch - c)])
        seq += (w % 4) * c
        return seq[(j % self.window) * self.batch: (j % self.window + 1) * self.batch]


def step_geometry(b_loc):
    from cdlrm_tpu_torch.cache.geometry import CacheGeometry

    return CacheGeometry.build(STEP_LN_EMB, D, 8, 2, aux_capacity=b_loc)


def step_inputs(ndev, b_glob, seed=0):
    """The inputs of one plain-wire train step, as tests/test_step.py makes
    them: the dense parameters' generator state is the seed's, a random
    cache (the same on every replica), a batch whose slots point at real
    rows only, and an empty aux bucket of 8 rows per replica."""
    geo = step_geometry(b_glob // ndev)
    rng = np.random.default_rng(seed + 1000)
    cache = rng.normal(size=(geo.total_rows, D)).astype(np.float32)
    x = rng.random((b_glob, DEN)).astype(np.float32)
    tgt = np.round(rng.random((b_glob, 1))).astype(np.float32)
    slots = np.stack([
        rng.integers(0, geo.ways * geo.sets[t], b_glob).astype(np.int32)
        + geo.table_offsets[t].astype(np.int32) for t in range(T)
    ])
    return dict(cache=cache, x=x, tgt=tgt, slots=slots,
                aux_slots=np.full(8, geo.trash_row, np.int32),
                aux_rows=np.zeros((8, D), np.float32))


def refill_inputs(ndev, seed=0):
    """Replicas that differ (replica r holds base + r, its state base + r),
    two inserts and two evictions, one slot in both lists."""
    geo = step_geometry(2)
    rng = np.random.default_rng(seed + 2000)
    base = rng.normal(size=(geo.total_rows, D)).astype(np.float32)
    acc = rng.random(geo.total_rows).astype(np.float32)
    return dict(
        caches=np.stack([base + r for r in range(ndev)]),
        accs=np.stack([acc + r for r in range(ndev)]),
        insert_slots=np.array([5, 6], np.int32),
        insert_rows=np.full((2, D), 42.0, np.float32),
        insert_acc=np.array([0.25, 0.5], np.float32),
        evict_slots=np.array([5, 7], np.int32),
    )


def aggregate_inputs(ndev, seed=7, density=0.15):
    """Random replicas, row-wise states and touched masks: rows touched by
    no, one, several and all replicas; the trash row is never marked."""
    geo = step_geometry(2)
    rng = np.random.default_rng(seed)
    caches = rng.normal(size=(ndev, geo.total_rows, D)).astype(np.float32)
    accs = rng.random((ndev, geo.total_rows)).astype(np.float32)
    tmask = rng.random((ndev, geo.total_rows)) < density
    tmask[:, 3] = True    # by every replica
    tmask[:, 4] = False   # by none
    tmask[:, 9] = False
    tmask[0, 9] = True    # by replica 0 alone
    tmask[-1, 11] = True  # by the last one at least
    tmask[:, geo.trash_row] = False
    return dict(caches=caches, accs=accs, touched=tmask)


def step_params():
    """(ln_bot, ln_top) of the step tests' small model."""
    return [DEN, 16, D], [T * (T + 1) // 2 + D, 8, 1]


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------


def _flat_params(params):
    from cdlrm_tpu_torch.models.dlrm import param_leaves

    return {f"param_{i}": p.detach().cpu().numpy() for i, p in enumerate(param_leaves(params))}


def case_train_step(group, ndev, b_glob, seed=0, strict_bias=False, **_):
    import torch

    from cdlrm_tpu_torch.models.dlrm import init_dlrm
    from cdlrm_tpu_torch.train import step as step_lib

    geo = step_geometry(b_glob // ndev)
    ln_bot, ln_top = step_params()
    params = init_dlrm(np.random.default_rng(seed), ln_bot, ln_top, device=torch.device("cpu"))
    inp = step_inputs(ndev, b_glob, seed)
    b_loc, r = b_glob // ndev, group.rank
    sl = slice(r * b_loc, (r + 1) * b_loc)
    scfg = step_lib.StepConfig(loss_function="bce", strict_bias_divergence=strict_bias)
    step = step_lib.make_cached_train_step(geo, scfg, group=group)
    cache = torch.from_numpy(inp["cache"].copy())
    touched = torch.zeros(geo.total_rows, dtype=torch.uint8)
    slots = torch.from_numpy(np.ascontiguousarray(inp["slots"][:, sl]))
    params, cache, loss, corr = step(
        params, cache, torch.from_numpy(inp["x"][sl]), slots,
        torch.zeros(slots.shape, dtype=torch.bool), torch.from_numpy(inp["aux_slots"]),
        torch.from_numpy(inp["aux_rows"]), torch.from_numpy(inp["tgt"][sl]),
        float(np.float32(0.1)), float(np.float32(0.3)), touched=touched,
    )
    return dict(cache=cache.numpy(), touched=touched.numpy(), loss=loss.numpy(),
                correct=corr.numpy(), **_flat_params(params))


def case_refill(group, ndev, mode, optimizer="sgd", master_state=False, bf16=False, **_):
    import torch

    from cdlrm_tpu_torch.train import step as step_lib

    inp = refill_inputs(ndev)
    geo = step_geometry(2)
    scfg = step_lib.StepConfig(refill_broadcast=mode, optimizer=optimizer, dedup=True,
                               adagrad_master_state=master_state, wire_rows_bf16=bf16)
    refill = step_lib.make_refill_step(scfg, geo.trash_row, group=group)
    cache = torch.from_numpy(inp["caches"][group.rank].copy())
    rows = torch.from_numpy(inp["insert_rows"])
    args = [torch.from_numpy(inp["insert_slots"]), rows.to(torch.bfloat16) if bf16 else rows,
            torch.from_numpy(inp["evict_slots"])]
    out = {}
    if optimizer == "adagrad":
        args.append(torch.from_numpy(inp["accs"][group.rank].copy()))
        if master_state:
            args.append(torch.from_numpy(inp["insert_acc"]))
    res = refill(cache, *args)
    out["cache"], out["evicted"] = res[0].numpy(), res[-2 if master_state else -1].float().numpy()
    if optimizer == "adagrad":
        out["accum"] = res[1].numpy()
    if master_state:
        out["ev_acc"] = res[-1].numpy()
    return out


def case_aggregate(group, ndev, op, bucket=None, optimizer="sgd", seed=7, density=0.15, **_):
    import torch

    from cdlrm_tpu_torch.train import step as step_lib

    inp = aggregate_inputs(ndev, seed, density)
    geo = step_geometry(2)
    scfg = step_lib.StepConfig(table_agg_op=op, optimizer=optimizer, dedup=True)
    if bucket == "union":  # an exactly full bucket
        bucket = int(inp["touched"].any(axis=0).sum())
    agg = step_lib.make_aggregate_step(scfg, group, union_bucket=bucket, trash_row=geo.trash_row)
    cache = torch.from_numpy(inp["caches"][group.rank].copy())
    touched = torch.from_numpy(inp["touched"][group.rank].astype(np.uint8))
    args = [torch.from_numpy(inp["accs"][group.rank].copy())] if optimizer == "adagrad" else []
    res = agg(cache, touched, *args)
    out = dict(cache=res[0].numpy(), touched=res[1].numpy())
    if args:
        out["accum"] = res[2].numpy()
    return out


def make_cfg(config_cls, ln_emb, **kw):
    """The trainer cases' config, for either package's ``Config`` class."""
    base = dict(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=32, world_size=2, cache_size=32, num_ways=4, loss_function="bce",
        lookahead=4, table_agg_freq=2, print_freq=4, learning_rate=0.2, lr_embeds=0.2,
        eviction_fifo_size=64, round_targets=True,
    )
    base.update(kw)
    return config_cls(**base).finalize(ln_emb=np.asarray(ln_emb))


def inline_writeback(tr):
    """Apply each writeback where it is queued, so that a run whose refills
    read back evicted rows or state is the same on every run."""
    tr.eviction_manager.start = lambda: None
    # close() queues a None to end the (never started) eviction thread
    tr.eviction_fifo.put = lambda item: item is None or tr.eviction_manager._apply(item)


def train_and_collect(tr, steps, evaluate=False, more_steps=0, save=None, to_numpy=np.asarray):
    """Drive a cached trainer of either package: ``steps`` steps, an optional
    save, ``more_steps`` further steps, an optional eval pass; returns what
    the tests compare, as numpy arrays and plain values; with the hot tier
    also each window's hot list and cold bucket as the trainer adopted them.
    The caller closes the trainer."""
    windows, hot = [], []
    tr._log_metrics = lambda kind, payload: windows.append((kind, dict(payload)))
    if tr._hot:
        apply_stats = tr._apply_window_stats

        def recording(window):
            apply_stats(window)
            hot.append((to_numpy(tr._hot_slots_dev).copy(), tr._cold_bucket_window))

        tr._apply_window_stats = recording
    tr.train(max_steps=steps, log_fn=lambda *_: None)
    if save:
        tr.save_checkpoint(save)
    if more_steps:
        tr.train(max_steps=steps + more_steps, log_fn=lambda *_: None)
    out = {}
    if evaluate:
        acc, auc = tr.evaluate(log_fn=lambda *_: None)
        out.update(eval_acc=acc, eval_auc=auc, eval_hits=tr.metrics.eval_hits,
                   eval_lookups=tr.metrics.eval_lookups)
    wins = [w for kind, w in windows if kind == "train_window"]
    m = tr.metrics
    out.update(
        global_step=tr.global_step, refills=m.refills, hits=m.hits, lookups=m.lookups,
        table_hits=np.asarray(m.table_hits), table_lookups=m.table_lookups,
        win_loss=np.array([w["loss"] for w in wins]),
        win_acc=np.array([w["accuracy"] for w in wins]),
        win_hit_rate=np.array([w["hit_rate"] for w in wins]),
        win_dedup=np.array([w["dedup"] for w in wins]),
        step_keys=np.array(sorted(str(tuple(k)) for k in tr._step_cache)),
        cursor=np.array(tr._cursor),
    )
    if hot:
        out["hot_lists"] = np.stack([h for h, _ in hot])
        out["cold_buckets"] = np.array([c for _, c in hot])
    out["cache"] = to_numpy(tr.cache)
    if tr.touched is not None:
        out["touched"] = to_numpy(tr.touched).astype(bool)
    if tr.embed_acc is not None:
        out["embed_acc"] = to_numpy(tr.embed_acc)
    return out


def record_exchange_threads(group) -> list:
    """Wrap ``group.all_gather_host`` so that every call records whether the
    main thread made it; returns the list of records."""
    calls, inner = [], group.all_gather_host

    def recorded(block):
        calls.append(threading.current_thread() is threading.main_thread())
        return inner(block)

    group.all_gather_host = recorded
    return calls


def case_trainer(group, ln_emb, cfg, stream, steps, out_dir, test_stream=None, load=None,
                 save=None, more_steps=0, inline=False, **_):
    import torch

    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    cfg = make_cfg(Config, ln_emb, **cfg)
    ds = Stream(ln_emb, **stream)
    test_ds = Stream(ln_emb, **test_stream) if test_stream else None
    calls = record_exchange_threads(group)
    tr = CachedDlrmTrainer(cfg, ds, test_ds, device="cpu", group=group)
    try:
        if inline:
            inline_writeback(tr)
        else:
            tr.eviction_manager.start = lambda: None  # hold the writebacks
        if load:
            tr.load_checkpoint(os.path.join(out_dir, load))
        out = train_and_collect(
            tr, steps, evaluate=test_ds is not None, more_steps=more_steps,
            save=os.path.join(out_dir, save) if save else None,
            to_numpy=lambda t: t.detach().cpu().numpy(),
        )
        out.update(_flat_params(tr.params))
        out["agg_bucket"] = -1 if tr._agg_bucket is None else tr._agg_bucket
        if tr.dense_acc is not None:
            out.update({"acc_" + k: v for k, v in _flat_params(tr.dense_acc).items()})
        # the held writebacks, applied in order: the masters' final rows
        assert tr.eviction_manager.flush()
        if hasattr(tr.master, "tables"):
            for t, table in enumerate(tr.master.tables):
                out[f"master_{t}"] = np.asarray(table)
        if tr.multihost:
            # the row shard's written-back ids, the exchanges and the threads
            # that made them, the prestage hoists
            for t in range(len(ln_emb)):
                out[f"dirty_{t}"] = tr.master._dirty.ids(t)
            out["rows_written"] = tr.eviction_manager.rows_written
            out["mh_prefetches"] = tr.mh_prefetches
            out["exchanges"] = np.array(calls, dtype=bool)
            if tr._acc_master is not None:
                out["acc_store_nonzero"] = sum(int(np.count_nonzero(a))
                                               for a in tr._acc_master.accs)
        assert torch.distributed.get_world_size() == group.world_size
        return out
    finally:
        tr.close()


def case_fulltable(group, ln_emb, cfg, stream, steps, out_dir, test_stream=None, save=None,
                   load=None, **_):
    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.models.embedding import emb_leaves
    from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

    cfg = make_cfg(Config, ln_emb, use_cache=False, **cfg)
    ds = Stream(ln_emb, **stream)
    test_ds = Stream(ln_emb, **test_stream) if test_stream else None
    tr = FullTableDlrmTrainer(cfg, ds, test_ds, device="cpu", group=group)
    try:
        if load:
            tr.load_checkpoint(os.path.join(out_dir, load))
        lines = []
        tr.train(max_steps=steps, log_fn=lines.append)
        out = dict(global_step=tr.global_step, lines=np.array(lines, dtype=str))
        if save:
            tr.save_checkpoint(os.path.join(out_dir, save))
        if test_ds is not None:
            out["eval_acc"], out["eval_auc"] = tr.evaluate(log_fn=lambda *_: None)
        out.update(_flat_params(tr.params))
        for i, leaf in enumerate(emb_leaves(tr.emb_tables())):
            out[f"emb_{i}"] = leaf.detach().numpy()
        if tr.emb_acc is not None:
            for i, a in enumerate(tr.emb_tables(tr.emb_acc)):
                out[f"embacc_{i}"] = a.numpy()
        return out
    finally:
        tr.close()


def case_cycle(group, **_):
    """A closed trainer's shape: an object in a reference cycle that holds
    the group's process group, left for the collector after one
    collective. destroy_dp_mesh must still stop the group's threads."""
    import torch

    holder = {"pg": group.group}
    holder["self"] = holder
    group.all_reduce_sum(torch.ones(4))
    return {}


def gloo_threads() -> list:
    """The names of this process's native threads that belong to a gloo
    process group (Linux names them; elsewhere the list is empty)."""
    import glob

    names = []
    for path in glob.glob("/proc/self/task/*/comm"):
        try:
            with open(path) as f:
                names.append(f.read().strip())
        except OSError:  # the thread ended while the list was read
            continue
    return sorted(n for n in names if "gloo" in n)


def case_fail(group, rank=1, linger_s=0.0, **_):
    """A rank that raises: the launcher must see its exit code. With
    ``linger_s`` the failing rank stays that long after it has left the
    group (a slow teardown): its peers fail on the closed connections in
    the meantime, and the launcher ends it."""
    if group.rank == rank:
        err = RuntimeError("this rank fails on purpose")
        err.linger_s = linger_s
        raise err
    return {}


# a rank's exit code when joining the group failed: no case has run on any
# rank (a case ends only when every rank has joined), so the launch may start again
RENDEZVOUS_FAILED = 3
# how long the other ranks may go on after one exits with a non-zero code: a
# peer that failed on the closed connections writes its error in this time,
# a peer that hangs in a collective is ended after it
GRACE_S = 2.0
FAILED_AT = re.compile(r"^rank \d+ failed at (\d+\.\d+)$", re.M)


def failed_at(text):
    """When a rank's output says it caught its error (parallel/mesh.py
    ``report_failure``), or None."""
    m = FAILED_AT.search(text)
    return float(m.group(1)) if m else None


def report_order(codes, texts):
    """The ranks in the order a failure report lists them: first by the
    time each caught its error (the rank whose error came first leads: the
    others' errors are most often its consequence), then those that exited
    with a code of their own, then those ended by the launcher."""
    def key(r):
        at = failed_at(texts[r])
        return (at is None, at or 0.0, codes[r] in (0, -9), r)

    return sorted(range(len(codes)), key=key)


def _launch(world, spec, rdzv, out_dir, timeout):
    """Start ``world`` ranks and wait for them; returns (exit codes, the end
    of each rank's output). A rank that exits with a non-zero code ends the
    others after :data:`GRACE_S` (at once if they have all exited); the
    time limit ends them at once."""
    import subprocess

    logs = [open(os.path.join(out_dir, f"log_w{world}_r{r}.txt"), "w+") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world), rdzv, spec, out_dir],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, now + GRACE_S)
            if now > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read()[-4000:])
            log.close()
    return codes, texts


def run_ranks(world, cases, out_dir, timeout=240.0, attempts=3):
    """Launch ``world`` ranks of this script over ``cases`` and wait for
    them. Returns ``load(name, rank)``, which reads a case's saved arrays.
    A rank that exits with a non-zero code, or the time limit, ends the
    others at once and raises with the ranks' output: no process stays
    behind. Only a failure to join the group (gloo's connection of the ranks
    under load, before any case ran) starts the launch again, on a fresh
    rendezvous file, up to ``attempts`` launches in all."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, f"spec_w{world}.json")
    with open(spec, "w") as f:
        json.dump(cases, f)
    for attempt in range(attempts):
        rdzv = os.path.join(out_dir, f"rdzv_w{world}" + (f".{attempt}" if attempt else ""))
        codes, texts = _launch(world, spec, rdzv, out_dir, timeout)
        joined_none = RENDEZVOUS_FAILED in codes and all(
            c in (RENDEZVOUS_FAILED, -9) for c in codes)
        if not joined_none:
            break
        print(f"run_ranks: the {world} ranks failed to join (codes {codes}); launch "
              f"{attempt + 2} of at most {attempts}", file=sys.stderr)
    if any(codes):
        raise RuntimeError(
            f"ranks exited with {codes} (a negative code: killed after another "
            f"rank failed or at the time limit; {RENDEZVOUS_FAILED}: joining the group "
            f"failed, in all of {attempt + 1} launches); the rank that failed first "
            "comes first\n" + "\n".join(
                f"--- rank {r}, exit {codes[r]} ---\n{texts[r]}"
                for r in report_order(codes, texts))
        )

    def load(name, rank):
        with np.load(os.path.join(out_dir, f"{name}.r{rank}.npz")) as data:
            return {k: data[k] for k in data.files}

    return load


KINDS = {
    "train_step": case_train_step, "refill": case_refill, "aggregate": case_aggregate,
    "trainer": case_trainer, "fulltable": case_fulltable, "fail": case_fail,
    "cycle": case_cycle,
}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    rdzv, spec_path, out_dir = sys.argv[3:6]
    import torch

    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure

    torch.set_num_threads(1)
    with open(spec_path) as f:
        cases = json.load(f)
    once = os.environ.get("DP_WORKER_FAIL_JOIN_ONCE")
    if once and rank == 1 and not os.path.exists(once):
        # a test's stand-in for gloo failing to connect the ranks
        open(once, "w").close()
        os._exit(RENDEZVOUS_FAILED)
    try:
        group = make_dp_mesh(world, rank, init_method="file://" + rdzv, device="cpu",
                             timeout_s=120)
    except RuntimeError:  # gloo's rendezvous or connection: no case ran
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(RENDEZVOUS_FAILED)
    assert group.backend == "gloo" and group.rank == rank
    linger_s = 0.0
    try:
        for case in cases:
            out = KINDS[case["kind"]](group, out_dir=out_dir, **case.get("args", {}))
            np.savez(os.path.join(out_dir, f"{case['name']}.r{rank}.npz"), **out)
    except BaseException as e:
        report_failure(rank)  # before the peers can hear of it
        e.reported = True
        linger_s = getattr(e, "linger_s", 0.0)
        raise
    finally:
        destroy_dp_mesh(group)
        time.sleep(linger_s)
    # a group's threads still running at the interpreter's teardown can abort
    # the process after its results are written (mesh.py destroy_dp_mesh)
    left = gloo_threads()
    if left:
        raise RuntimeError(f"rank {rank}: gloo threads {left} outlived destroy_dp_mesh")
    print(f"rank {rank}: {len(cases)} cases done")


if __name__ == "__main__":
    try:
        main()
    except BaseException as e:
        if not getattr(e, "reported", False):
            traceback.print_exc()
            sys.stderr.flush()
        # leave at once: another rank may be waiting in a collective, and a
        # normal exit would wait for this process's threads
        os._exit(1)
