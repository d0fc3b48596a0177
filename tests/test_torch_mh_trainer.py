"""cdlrm_tpu_torch's multi-host mode against cdlrm_tpu, on the CPU: N gloo
ranks of the port (tests/torch_dp_worker.py), each holding its row shard of
the masters (``coordinator_address`` set, more than one rank), beside
cdlrm_tpu's one process over N virtual CPU devices with
``master_init='virtual'``, whose masters hold the same values as any row
sharding of them (cdlrm_tpu/parallel/multihost.py:127-130).

The counterparts of tests/test_multihost.py:125-473 at N = 2 and 4: one
window, several windows with evictions, the refill prestage on and off,
pooled multi-hot bags, cached MD, AdaGrad with and without its master state,
the coalesced block, eval. Rank r's cache, touched mask and row-wise state
are held against block r of cdlrm_tpu's flat arrays, and the dense
parameters, per-window losses and AUC against cdlrm_tpu's, within 1e-5;
hits, prestage hoists and written-back rows exactly. The ranks' owned shards
put together equal cdlrm_tpu's masters, and the rows they wrote back
partition cdlrm_tpu's written-back set. Every all-gather is called by the
main thread. Both packages hold their eviction threads, as
tests/test_torch_dp_trainer.py does.

Then checkpoints (per-rank files in one shared directory, a mid-window resume
bit-equal to the uninterrupted run, a master shard that loads into
cdlrm_tpu's ShardedMasterTables and is refused by another rank's) and the
CLI (two processes joining a coordinator, the host-field refusal, the bin
loader's --data-host-slice against the unsliced run).
"""

import os
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest

import jax

import torch_dp_worker as W
from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.parallel.multihost import RowShard as JaxRowShard
from cdlrm_tpu.parallel.multihost import ShardedMasterTables as JaxSharded
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch import cli
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.parallel.mesh import DpGroup
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from test_torch_dp_trainer import _assert_dense_bit_equal, _assert_ranks_match_jax, _hold

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = W.REPO
BIG = [300, 400, 500]
SMALL = [60, 30, 90]
TEST = dict(num_batches=2, batch=32, seed=9)
# the trainer reads only whether an address is set: the worker's ranks have
# joined their group through a rendezvous file already
MH = dict(coordinator_address="127.0.0.1:1", master_init="virtual")


def _case(ln_emb=BIG, steps=12, world=2, batch=32, seed=6, pooled=0, skew=0, test=False,
          stream=None, **kw):
    extra = {k: kw.pop(k) for k in ("load", "save", "more_steps", "inline") if k in kw}
    cfg = dict(world_size=world, mini_batch_size=batch, **MH, **kw)
    args = dict(ln_emb=ln_emb, cfg=cfg, steps=steps,
                stream=dict(num_batches=steps + extra.get("more_steps", 0) + 2, batch=batch,
                            seed=seed, pooled=pooled, skew=skew, **(stream or {})), **extra)
    if test:
        args["test_stream"] = dict(TEST, pooled=pooled)
    return args


ADA = dict(optimizer="adagrad", dedup_lookups="on", learning_rate=0.05, lr_embeds=0.05)
WINDOWS = dict(scan_steps=3, lookahead=4, test=True)
CASES = {
    # test_multihost.py:125 (one window) and :452 (four hosts)
    "one_window": _case(steps=10, lookahead=14, test=True),
    "one_window4": _case(world=4, batch=64, steps=10, lookahead=14, test=True),
    # :149 several windows, evictions written back; :166 prestage on and off
    "windows": _case(save="mh_windows", **WINDOWS),
    "windows_noprestage": _case(refill_prestage=False, save="mh_windows_off", **WINDOWS),
    "windows4": _case(world=4, batch=64, refill_broadcast="delta", table_agg_freq=2, **WINDOWS),
    # :215 pooled multi-hot on the unpacked wire
    "pooled": _case(pooled=3, skew=40, pack_wire=False, test=True),
    # :285 cached MD on compact sharded masters
    "md": _case(ln_emb=[50, 400, 3000], md_flag=True, test=True),
    # :300 and :315 AdaGrad, and its master state. The master state's
    # trajectory is exact only where no evicted row can be read before its
    # writeback lands (in either package): writebacks applied where they are
    # queued, on tests/test_adagrad_master_state.py's cycle of windows over a
    # cache of 17 sets x 4 ways, the prefetcher at most a window ahead
    "adagrad": _case(**ADA),
    "adagrad_master": _case(adagrad_master_state=True, inline=True, cache_size=17,
                            num_ways=4, lookahead=3, batch_fifo_size=1, steps=15,
                            stream=dict(cycle=68, window=3), **ADA),
    # :339 the coalesced block on the unpacked dedup wire, two and four ranks
    "coalesce": _case(dedup_lookups="on", pack_wire=False, scan_steps=3, lookahead=6,
                      table_agg_freq=3, skew=40, steps=14),
    "coalesce4": _case(world=4, batch=64, dedup_lookups="on", pack_wire=False, scan_steps=3,
                       lookahead=6, table_agg_freq=3, skew=40, steps=14),
    # :187 a mid-window resume over a shared directory, nothing evicted
    "ck_save": _case(ln_emb=SMALL, cache_size=128, table_agg_freq=4, steps=6, seed=8,
                     save="mh_ck", more_steps=6),
    "ck_resume": _case(ln_emb=SMALL, cache_size=128, table_agg_freq=4, steps=12, seed=8,
                       load="mh_ck"),
}
# the prestage changes nothing the trajectory reads: it is held to the
# prestaged run's cdlrm_tpu counterpart
JAX_OF = {"windows_noprestage": "windows"}
# cdlrm_tpu's one-process run of the master-state case refills at the
# boundary: its threaded stager pops the next window as the boundary begins,
# so the prefetcher's gather of the window after it races the boundary's
# writebacks of the same ids. The port's multi-host prestage pops mid-window,
# after the boundary, and reads what the boundary path reads
JAX_CFG = {"adagrad_master": dict(refill_prestage=False)}
NO_JAX = {"ck_save", "ck_resume"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through the port's ranks: one launch of two ranks, one of
    four. Returns (ranks(name), out_dir)."""
    out = str(tmp_path_factory.mktemp("mh_trainer"))
    loaders = {}
    for world in (2, 4):
        cases = [dict(name=k, kind="trainer", args=a) for k, a in CASES.items()
                 if a["cfg"]["world_size"] == world]
        loaders[world] = W.run_ranks(world, cases, out, timeout=400)

    def ranks(name):
        world = CASES[name]["cfg"]["world_size"]
        return [loaders[world](name, r) for r in range(world)]

    return ranks, out


_JAX_CACHE = {}


def _jax(name, out_dir):
    """The case through cdlrm_tpu at world_size N in one process; its
    masters as whole tables, and the ids written back to them. A case that
    saves saves here too: the save's flush applies the held writebacks
    before the eval pass reads the masters."""
    name = JAX_OF.get(name, name)
    if name in _JAX_CACHE:
        return _JAX_CACHE[name]
    args = CASES[name]
    cfg = W.make_cfg(JaxConfig, args["ln_emb"], **{**args["cfg"], **JAX_CFG.get(name, {})})
    ds = W.Stream(args["ln_emb"], **args["stream"])
    test_ds = W.Stream(args["ln_emb"], **args["test_stream"]) if "test_stream" in args else None
    tr = JaxTrainer(cfg, ds, test_ds)
    try:
        _hold(tr, args.get("inline", False))
        save = os.path.join(out_dir, args["save"] + "_by_jax") if args.get("save") else None
        out = W.train_and_collect(tr, args["steps"], evaluate=test_ds is not None, save=save)
        out["params"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.params)]
        if tr.dense_acc is not None:
            out["dense_acc"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.dense_acc)]
        assert tr.eviction_manager.flush()
        out["rows_written"] = tr.eviction_manager.rows_written
        m = tr.master
        if hasattr(m, "tables"):  # cached MD: one whole procedural shard
            out["whole"] = [np.asarray(t) for t in m.tables]
            out["written"] = [m._dirty.ids(t) for t in range(len(args["ln_emb"]))]
        else:  # VirtualMasterTables: the block hash and an overlay of writes
            out["whole"] = [m.gather(t, np.arange(n)) for t, n in enumerate(args["ln_emb"])]
            out["written"] = [m._overlay[t][0] for t in range(len(args["ln_emb"]))]
        if tr._acc_master is not None:
            out["acc_store_nonzero"] = sum(int(np.count_nonzero(a)) for a in tr._acc_master.accs)
    finally:
        tr.close()
    _JAX_CACHE[name] = out
    return out


def _assert_masters_partition(ranks, want, ln_emb):
    """The ranks' owned shards, in rank order, are cdlrm_tpu's whole
    masters; their written-back ids lie in their own ranges and together are
    cdlrm_tpu's written-back ids, and so are their counts."""
    n = len(ranks)
    for t, rows in enumerate(ln_emb):
        whole = np.concatenate([got[f"master_{t}"] for got in ranks])
        np.testing.assert_allclose(whole, want["whole"][t], **TOL)
        per = -(-rows // n)
        for r, got in enumerate(ranks):
            ids = got[f"dirty_{t}"]
            assert ((ids >= r * per) & (ids < (r + 1) * per)).all(), (t, r)
        union = np.concatenate([got[f"dirty_{t}"] for got in ranks])
        np.testing.assert_array_equal(np.sort(union), np.sort(want["written"][t]))
    assert sum(int(got["rows_written"]) for got in ranks) == want["rows_written"]


@pytest.mark.parametrize("name", [k for k in CASES if k not in NO_JAX])
def test_multihost_ranks_match_cdlrm_tpu(runs, name):
    ranks, out_dir = runs
    got = ranks(name)
    want = _jax(name, out_dir)
    _assert_ranks_match_jax(got, want)
    _assert_dense_bit_equal(got)
    _assert_masters_partition(got, want, CASES[name]["ln_emb"])
    for g in got:
        # every all-gather, window or eval exchange, from the main thread
        assert g["exchanges"].size > 0 and g["exchanges"].all(), name
    hoists = [int(g["mh_prefetches"]) for g in got]
    if CASES[name]["cfg"].get("refill_prestage", True) and int(got[0]["refills"]) > 1:
        assert hoists[0] > 0 and len(set(hoists)) == 1, hoists
    else:
        assert hoists == [0] * len(got), hoists


def test_the_runs_took_the_paths_they_name(runs):
    """Windows evicted and wrote back, the master state round-tripped, the
    coalesced block and the hoist ran, and the prestage off ran none."""
    ranks, out_dir = runs
    for name in ("windows", "windows4", "adagrad_master", "md"):
        assert sum(int(g["rows_written"]) for g in ranks(name)) > 0, name
        assert int(ranks(name)[0]["refills"]) >= 3, name
    assert sum(int(g["acc_store_nonzero"]) for g in ranks("adagrad_master")) > 0
    assert int(_jax("adagrad_master", out_dir)["acc_store_nonzero"]) > 0
    for name in ("coalesce", "coalesce4"):
        assert "(3, True, True)" in list(ranks(name)[0]["step_keys"]), name
    on, off = ranks("windows"), ranks("windows_noprestage")
    # one hoist in every window, the last one for the window after the run
    assert int(on[0]["mh_prefetches"]) == int(on[0]["refills"])
    assert int(off[0]["mh_prefetches"]) == 0
    for a, b in zip(on, off):
        for k in ("win_loss", "cache", "touched", "hits", "rows_written"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------- checkpoints
def test_checkpoint_files_per_rank(runs):
    """One shared directory: each rank's own tagged files, rank 0's shared
    ones once, and no single-host file."""
    ranks, out_dir = runs
    ck = os.path.join(out_dir, "mh_ck")
    names = set(os.listdir(ck))
    for r in range(2):
        for stem in ("cache", "touched"):
            assert f"{stem}.h{r}.npy" in names
        assert f"master.h{r}.npz" in names
    assert {"meta.pkl", "dense_params.npz", "occupancy.npz"} <= names
    assert not names & {"cache.npy", "touched.npy", "master.npz"}
    saved = ranks("ck_save")
    rows = saved[0]["cache"].shape[0]
    for r in range(2):
        assert np.load(os.path.join(ck, f"cache.h{r}.npy")).shape == (rows, 8)


def test_mid_window_resume_is_bit_equal(runs):
    """Saved at step 6 of windows of 4, resumed by a fresh pair to step 12:
    the same bits as the pair that went on (nothing is evicted)."""
    ranks, _ = runs
    for a, b in zip(ranks("ck_save"), ranks("ck_resume")):
        assert int(a["global_step"]) == int(b["global_step"]) == 12
        for k in ("cache", "touched", "cursor") + tuple(
                k for k in a if k.startswith("param_")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        # the print window of steps 9-12, the one both runs measured whole
        assert a["win_loss"][-1] == b["win_loss"][-1]
        assert int(a["rows_written"]) == int(b["rows_written"]) == 0


def test_master_shard_loads_into_cdlrm_tpu(runs):
    """Each rank's master.h{r}.npz of an evicting run loads bit-equal into
    cdlrm_tpu's ShardedMasterTables(RowShard(r, 2)); another rank's shard
    is refused."""
    ranks, out_dir = runs
    got = ranks("windows")
    seed = Config().numpy_rand_seed
    token = zlib.crc32(f"{seed}:virtual".encode())
    for r in range(2):
        m = JaxSharded(BIG, 8, JaxRowShard(r, 2), np.random.default_rng(seed))
        m.load(os.path.join(out_dir, "mh_windows", f"master.h{r}.npz"), init_token=token)
        for t in range(len(BIG)):
            np.testing.assert_array_equal(m.tables[t], got[r][f"master_{t}"])
        assert any(m._dirty.ids(t).size for t in range(len(BIG)))
    other = JaxSharded(BIG, 8, JaxRowShard(0, 2), np.random.default_rng(seed))
    with pytest.raises(ValueError, match="belongs to host 1, this is host 0"):
        other.load(os.path.join(out_dir, "mh_windows", "master.h1.npz"), init_token=token)


# ------------------------------------------------------ one rank, refusals
def _ds():
    return W.Stream(SMALL, num_batches=3, batch=32)


def test_coordinator_with_one_rank_trains_on_one_device():
    """A coordinator and one rank: the trainer runs on one device, as
    cdlrm_tpu does in one process (no row sharding, no exchange)."""
    cfg = W.make_cfg(Config, SMALL, world_size=1, coordinator_address="127.0.0.1:1")
    tr = CachedDlrmTrainer(cfg, _ds(), _ds(), device="cpu")
    try:
        assert not tr.multihost and tr._row_exchange is None
        tr.train(max_steps=2, log_fn=lambda *_: None)
        tr.evaluate(log_fn=lambda *_: None)
        assert tr.global_step == 2 and tr.mh_prefetches == 0
    finally:
        tr.close()


def test_trainer_refuses_host_fields_that_are_not_the_group():
    cfg = W.make_cfg(Config, SMALL, coordinator_address="127.0.0.1:1", num_hosts=3)
    with pytest.raises(ValueError, match="one process per card"):
        CachedDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(0, 2))
    cfg = W.make_cfg(Config, SMALL, coordinator_address="127.0.0.1:1", host_id=1)
    with pytest.raises(ValueError, match="the host id is the rank"):
        CachedDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(0, 2))


def test_fulltable_refuses_a_multihost_group():
    """cdlrm_tpu's rule (fulltable.py:33-36), in its words."""
    cfg = W.make_cfg(Config, SMALL, use_cache=False, coordinator_address="127.0.0.1:1")
    with pytest.raises(ValueError, match="FullTableDlrmTrainer is single-process; multi-host "
                                         "runs use the cached trainer"):
        FullTableDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(0, 2))


# ----------------------------------------------------------------------- CLI
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CLI = ("--device", "cpu", "--arch-sparse-feature-size", "8", "--arch-mlp-bot", "13-16-8",
        "--arch-mlp-top", "8-1", "--mini-batch-size", "32", "--num-batches", "8",
        "--cache-size", "16", "--num-ways", "2", "--loss-function", "bce", "--round-targets",
        "--lookahead", "4", "--print-freq", "4", "--world-size", "2", "--num-hosts", "2")


def _cli_pair(*extra, timeout=180):
    """Two CLI processes of one multi-host run; returns their results."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cdlrm_tpu_torch.cli", *_CLI, *extra,
         "--coordinator-address", f"127.0.0.1:{port}", "--host-id", str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _bin_dataset(d):
    """A bin dataset in the bin loader's layout: 10 batches of 32 rows to
    train on, 2 to test, 26 tables of 50 ids."""
    from cdlrm_tpu_torch.data.criteo import DEN_FEA, SPA_FEA

    rng = np.random.default_rng(3)
    for name, rows in (("train_data.bin", 320), ("test_data.bin", 64)):
        x_int = rng.integers(0, 100, (rows, DEN_FEA))
        y = (x_int[:, :1] > 50).astype(np.int64)
        x_cat = rng.integers(0, 50, (rows, SPA_FEA))
        with open(os.path.join(d, name), "wb") as f:
            f.write(np.concatenate([y, x_int, x_cat], axis=1).astype(np.int32).tobytes())
    np.savez(os.path.join(d, "day_fea_count.npz"), counts=np.full(SPA_FEA, 50, np.int64))
    return ("--data-generation", "dataset", "--mlperf-bin-loader", "--processed-data-file",
            os.path.join(d, "processed.npz"), "--raw-data-file", os.path.join(d, "day"))


def test_cli_two_hosts_train_evaluate_save_and_slice(tmp_path):
    """Two processes join the coordinator and train, evaluate and save the
    tagged files; with --data-host-slice each reads only its rows of every
    train batch, and the run is the unsliced one's, bit for bit."""
    data = _bin_dataset(str(tmp_path))
    runs = {}
    for name, extra in (("full", ()), ("sliced", ("--data-host-slice",))):
        ck = str(tmp_path / name)
        res = _cli_pair(*data, *extra, "--save-model", ck)
        for r, (code, out, err) in enumerate(res):
            assert code == 0, err[-3000:]
            assert f"[multihost] process {r}/2 initialized" in out
        out0 = res[0][1]
        assert out0.count("Step 8:") == 1 and out0.count("Test accuracy") == 1
        assert "Step 8:" not in res[1][1]  # rank 0 alone prints
        runs[name] = (ck, [line.split("loss")[1] for line in out0.splitlines()
                           if line.startswith("Step ")])
    (full, full_lines), (sliced, sliced_lines) = runs["full"], runs["sliced"]
    assert full_lines == sliced_lines
    for r in range(2):
        for f in (f"cache.h{r}.npy", f"touched.h{r}.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(full, f)),
                                          np.load(os.path.join(sliced, f)))
    with np.load(os.path.join(full, "dense_params.npz")) as a, \
            np.load(os.path.join(sliced, "dense_params.npz")) as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_cli_refuses_num_hosts_other_than_world_size():
    with pytest.raises(ValueError, match="must equal --world-size"):
        cli.main(["--device", "cpu", "--arch-embedding-size", "100-200",
                  "--arch-sparse-feature-size", "2", "--coordinator-address", "127.0.0.1:1",
                  "--num-hosts", "3", "--world-size", "2"])
