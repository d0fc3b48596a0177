"""Checkpoints of cdlrm_tpu_torch: save, load, and the crossing between
the two packages, which share cdlrm_tpu's single-host format v3.

- A mid-stream resume (save at step 18, mid-window, into a fresh trainer)
  trains what the uninterrupted run trains (test_trainer_e2e.py:192 at
  world_size=1).
- A save of either package loads into the other's cached trainer, and both
  train on alike, within 1e-5 (SGD, AdaGrad, AdaGrad with the master
  state), under whole-window evictions with writebacks inline at each
  boundary (test_adagrad_master_state.py's stream), so every run is
  deterministic.
- An async save writes the files of a sync save (test_trainer_e2e.py:1324);
  a dirty-master re-save stays cumulative (:113); ``checkpoint_freq`` fires
  at its steps, with scan blocks capped at it.
- The full-table trainer's checkpoints cross both ways.
- A checkpoint's optimizer state must fit the run that loads it
  (cdlrm_tpu trainer.py:2425-2469): an SGD training run refuses AdaGrad
  state, which ``--inference-only`` serves."""

import os
import pickle

import numpy as np
import pytest
import torch

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer as JaxFullTable
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config, finalize
from cdlrm_tpu_torch.models.dlrm import params_to_jax
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from test_adagrad_master_state import WINDOW as CYC_WINDOW, _CycleStream
from test_torch_adagrad import (
    TOL, _Learnable, _assert_runs_close, _cycle_cfg, _jax_leaves, _run,
)

OPTS = {"sgd": dict(optimizer="sgd", adagrad_master_state=False),
        "adagrad": dict(adagrad_master_state=False),
        "master": dict(adagrad_master_state=True)}


def _quiet(tr, steps):
    tr.train(max_steps=steps, log_fn=lambda *_: None)


@pytest.mark.parametrize("scan,opt", [(1, "sgd"), (3, "sgd"), (3, "adagrad")])
def test_midstream_resume_equals_uninterrupted(tmp_path, scan, opt):
    """Train 18, save, resume in a fresh trainer to 38: step for step the
    uninterrupted train-38, fully resident so no miss row races a writeback;
    scan 3 resumes mid-block."""
    ln_emb = np.array([40, 25, 60])
    b = 16

    def trainer():
        cfg = finalize(Config(
            arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
            mini_batch_size=b, world_size=1, cache_size=64, num_ways=2, lookahead=4,
            loss_function="bce", print_freq=1000, learning_rate=0.2, lr_embeds=0.2,
            scan_steps=scan, optimizer=opt, dedup_lookups="on" if opt == "adagrad" else "off",
        ), ln_emb=ln_emb)
        ds = SyntheticDataset(m_den=13, ln_emb=ln_emb, data_size=b * 50, mini_batch_size=b,
                              round_targets=True, seed=11)
        return CachedDlrmTrainer(cfg, ds, device="cpu")

    def state(tr):
        out = dict(cache=tr.cache.numpy().copy(), params=params_to_jax(tr.params),
                   occupancy=[o.copy() for o in tr.controller.occupancy])
        if opt == "adagrad":
            out.update(embed_acc=tr.embed_acc.numpy().copy(), dense_acc=params_to_jax(tr.dense_acc))
        return out

    tr = trainer()
    try:
        _quiet(tr, 38)
        ref = state(tr)
    finally:
        tr.close()
    tr1 = trainer()
    try:
        _quiet(tr1, 18)
        assert tr1._cursor == (0, 18)
        tr1.save_checkpoint(str(tmp_path / "mid"))
    finally:
        tr1.close()
    tr2 = trainer()
    try:
        tr2.load_checkpoint(str(tmp_path / "mid"))
        assert tr2._cursor == (0, 18) and tr2.global_step == 18
        _quiet(tr2, 38)
        assert tr2.global_step == 38
        got = state(tr2)
    finally:
        tr2.close()
    for a, b_ in zip(got.pop("occupancy"), ref.pop("occupancy")):
        np.testing.assert_array_equal(a, b_)
    for key, want in ref.items():
        for a, b_ in zip(got[key] if isinstance(want, list) else [got[key]],
                         want if isinstance(want, list) else [want]):
            np.testing.assert_allclose(a, b_, rtol=1e-6, atol=1e-7, err_msg=key)


def _train_and_save(tr, steps, path, sync_writeback=True):
    """Train with writebacks inline at each boundary, save, close."""
    tr.eviction_manager.start = lambda: None
    real_put = tr.eviction_fifo.put
    if sync_writeback:
        tr.eviction_fifo.put = lambda item: tr.eviction_manager._apply(item)
    try:
        _quiet(tr, steps)
        tr.save_checkpoint(path)
    finally:
        tr.eviction_fifo.put = real_put
        tr.close()


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "master"])
@pytest.mark.parametrize("writer", ["port", "cdlrm_tpu"])
def test_checkpoints_cross_packages(tmp_path, writer, opt):
    """One package trains 13 steps (mid-window) and saves; each package
    loads the checkpoint into a fresh trainer and trains on to step 24 from
    its data cursor; the two resumed runs agree (windows, cache, state,
    parameters, masters, the accumulator store)."""
    steps, save_at = 24, 13
    ck = str(tmp_path / "ck")

    def trainer(port):
        cfg = _cycle_cfg(port, False, **OPTS[opt])
        ds = _CycleStream(steps + CYC_WINDOW)
        return CachedDlrmTrainer(cfg, ds, device="cpu") if port else JaxTrainer(cfg, ds)

    _train_and_save(trainer(writer == "port"), save_at, ck)
    with open(os.path.join(ck, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    assert meta["format_version"] == 3 and meta["global_step"] == save_at
    assert tuple(meta["cursor"]) == (0, save_at)
    assert os.path.exists(os.path.join(ck, "embed_acc.npy")) == (opt != "sgd")
    assert os.path.exists(os.path.join(ck, "acc_store.npz")) == (opt == "master")
    runs = []
    for port in (True, False):
        tr = trainer(port)
        tr.load_checkpoint(ck)
        assert tr.global_step == save_at
        runs.append(_run(tr, steps, sync_writeback=True))
    _assert_runs_close(*runs)
    if opt == "master":
        assert sum(int(np.count_nonzero(a)) for a in runs[0]["store"]) > 0


def _files_equal(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names == sorted(os.listdir(dir_b))
    for name in names:
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name == "meta.pkl":
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read()
            continue
        a, b = np.load(pa, allow_pickle=False), np.load(pb, allow_pickle=False)
        if name.endswith(".npz"):
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")
            a.close()
            b.close()
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    return names


def test_async_save_equals_sync(tmp_path):
    """checkpoint_async: the write phase runs on its own thread over the
    snapshot while training goes on; the files equal a sync save taken at
    the same step of an identical run, and the async checkpoint resumes."""
    def run(async_mode):
        ck = str(tmp_path / ("async" if async_mode else "sync"))
        tr = CachedDlrmTrainer(_cycle_cfg(True, True, checkpoint_async=async_mode),
                               _CycleStream(30), device="cpu")
        tr.eviction_manager.start = lambda: None
        real_put = tr.eviction_fifo.put
        tr.eviction_fifo.put = lambda item: tr.eviction_manager._apply(item)
        try:
            _quiet(tr, 13)
            tr.save_checkpoint(ck)
            assert (tr._ckpt_writer.thread is not None) == async_mode
            if async_mode:
                _quiet(tr, 24)  # writebacks land while the writer runs
        finally:
            tr.eviction_fifo.put = real_put
            tr.close()  # joins the writer
        assert tr._ckpt_writer.thread is None
        return ck

    names = _files_equal(run(False), run(True))
    assert {"cache.npy", "touched.npy", "embed_acc.npy", "acc_store.npz", "master.npz",
            "dense_params.npz", "dense_acc.npz", "occupancy.npz", "meta.pkl"} == set(names)
    with np.load(str(tmp_path / "async" / "acc_store.npz")) as data:
        assert data["acc_ids_0"].size > 0
    assert not np.load(str(tmp_path / "async" / "touched.npy")).any()
    tr = CachedDlrmTrainer(_cycle_cfg(True, True), _CycleStream(30), device="cpu")
    try:
        tr.load_checkpoint(str(tmp_path / "async"))
        assert tr.global_step == 13
        _quiet(tr, 18)
        assert tr.global_step == 18
    finally:
        tr.close()


def _learnable_trainer(**kw):
    ln = np.array([500, 200, 1000])
    cfg = finalize(Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=64, world_size=1, cache_size=64, num_ways=4, lookahead=4,
        loss_function="bce", print_freq=1000, learning_rate=0.2, lr_embeds=0.2, **kw,
    ), ln_emb=ln)
    return CachedDlrmTrainer(cfg, _Learnable(ln, 60, 64, seed=0), device="cpu")


def test_dirty_master_resave_is_cumulative(tmp_path):
    """checkpoint_masters='dirty' (the default): the masters restore
    bit-exactly from (init + dirty rows), and a re-save after resume still
    holds the rows dirtied before the first save (test_trainer_e2e.py:113)."""
    tr = _learnable_trainer()
    try:
        _quiet(tr, 24)
        tr.save_checkpoint(str(tmp_path / "ck1"))
        assert tr.eviction_manager.rows_written > 0
        masters_1 = [t.copy() for t in tr.master.tables]
        with np.load(str(tmp_path / "ck1" / "master.npz")) as data:
            assert "dirty_format" in data.files
    finally:
        tr.close()
    tr2 = _learnable_trainer()
    try:
        tr2.load_checkpoint(str(tmp_path / "ck1"))
        for a, b in zip(tr2.master.tables, masters_1):
            np.testing.assert_array_equal(a, b)
        _quiet(tr2, 48)
        tr2.save_checkpoint(str(tmp_path / "ck2"))
        masters_2 = [t.copy() for t in tr2.master.tables]
    finally:
        tr2.close()
    tr3 = _learnable_trainer()
    try:
        tr3.load_checkpoint(str(tmp_path / "ck2"))
        for a, b in zip(tr3.master.tables, masters_2):
            np.testing.assert_array_equal(a, b)
    finally:
        tr3.close()
    # a different procedural base refuses the dirty file
    tr4 = _learnable_trainer(numpy_rand_seed=999)
    try:
        with pytest.raises(ValueError, match="init token"):
            tr4.load_checkpoint(str(tmp_path / "ck1"))
    finally:
        tr4.close()


def test_checkpoint_freq_fires_with_capped_scan_blocks(tmp_path):
    """checkpoint_freq=4 with save_model: a save at steps 4, 8 and 12, and
    no scan block of 3 crosses one; the last save holds step 12."""
    ck = str(tmp_path / "ck")
    tr = _learnable_trainer(scan_steps=3, checkpoint_freq=4, save_model=ck)
    saved, blocks, step0 = [], [], []
    save, get_step = tr.save_checkpoint, tr._get_step

    def recording_save(path):
        assert path == ck
        saved.append(tr.global_step)
        save(path)

    def recording_get_step(size, *key):
        step0.append(tr.global_step)
        blocks.append(size)
        return get_step(size, *key)

    tr.save_checkpoint, tr._get_step = recording_save, recording_get_step
    try:
        _quiet(tr, 13)
    finally:
        tr.close()
    assert saved == [4, 8, 12]
    assert sum(blocks) == 13 and max(blocks) == 3
    for j, size in zip(step0, blocks):
        assert (j // 4) == (j + size - 1) // 4, (j, size)  # no block crosses a save
    with open(os.path.join(ck, "meta.pkl"), "rb") as f:
        assert pickle.load(f)["global_step"] == 12


def test_fulltable_checkpoint_freq(tmp_path):
    """The port's full-table trainer saves every checkpoint_freq steps (its
    cdlrm_tpu counterpart ignores the flag)."""
    ln = np.array([300, 400, 500])
    ck = str(tmp_path / "ck")
    cfg = _fulltable_cfg(True, "adagrad", checkpoint_freq=3, save_model=ck)
    tr = FullTableDlrmTrainer(cfg, _Learnable(ln, 8, 32, seed=2), device="cpu")
    saved = []
    save = tr.save_checkpoint
    tr.save_checkpoint = lambda path: (saved.append(tr.global_step), save(path))
    try:
        _quiet(tr, 7)
    finally:
        tr.close()
    assert saved == [3, 6]
    with open(os.path.join(ck, "meta.pkl"), "rb") as f:
        assert pickle.load(f)["global_step"] == 6
    assert os.path.exists(os.path.join(ck, "fulltable_acc.npz"))


def _fulltable_cfg(port, opt, **kw):
    cfg = (Config if port else JaxConfig)(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=32, world_size=1, loss_function="bce", print_freq=1000,
        round_targets=True, use_cache=False, learning_rate=0.1, lr_embeds=0.2,
        optimizer=opt, **kw,
    )
    ln = np.array([300, 400, 500])
    return cfg.finalize(ln_emb=ln)


@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_fulltable_checkpoints_cross_packages(tmp_path, opt):
    """Each package's full-table save loads into the other's trainer
    bit-exactly, and from the port's save both train on alike within 1e-5;
    a trainer whose optimizer does not fit the checkpoint refuses it."""
    ln = np.array([300, 400, 500])
    ds = _Learnable(ln, 10, 32, seed=4)
    adagrad = opt == "adagrad"

    def port_state(tr):
        out = params_to_jax({**tr.params, "emb": tr.emb_tables()})
        if adagrad:
            out += params_to_jax({**tr.dense_acc, "emb": tr.emb_tables(tr.emb_acc)})
        return out

    def jax_state(tr):
        out = _jax_leaves(tr.params)
        return out + (_jax_leaves(tr.accum) if adagrad else [])

    # the port writes, both load and train on
    ptr = FullTableDlrmTrainer(_fulltable_cfg(True, opt), ds, device="cpu")
    _quiet(ptr, 5)
    ptr.save_checkpoint(str(tmp_path / "port"))
    saved = port_state(ptr)
    ptr.close()
    jtr = JaxFullTable(_fulltable_cfg(False, opt, numpy_rand_seed=9), ds)
    jtr.load_checkpoint(str(tmp_path / "port"))
    ptr = FullTableDlrmTrainer(_fulltable_cfg(True, opt, numpy_rand_seed=9), ds, device="cpu")
    ptr.load_checkpoint(str(tmp_path / "port"))
    assert jtr.global_step == ptr.global_step == 5
    for a, b, c in zip(jax_state(jtr), port_state(ptr), saved):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    _quiet(jtr, 9)
    _quiet(ptr, 9)
    for a, b in zip(jax_state(jtr), port_state(ptr)):
        np.testing.assert_allclose(b, a, **TOL)

    # cdlrm_tpu writes, the port loads
    jtr.save_checkpoint(str(tmp_path / "jax"))
    fresh = FullTableDlrmTrainer(_fulltable_cfg(True, opt), ds, device="cpu")
    fresh.load_checkpoint(str(tmp_path / "jax"))
    assert fresh.global_step == 9
    for a, b in zip(jax_state(jtr), port_state(fresh)):
        np.testing.assert_array_equal(b, a)

    other = FullTableDlrmTrainer(_fulltable_cfg(True, "sgd" if adagrad else "adagrad"), ds,
                                 device="cpu")
    with pytest.raises(ValueError, match="AdaGrad optimizer state" if adagrad
                       else "carries no optimizer"):
        other.load_checkpoint(str(tmp_path / "jax"))


def test_sgd_training_refuses_adagrad_checkpoint(tmp_path):
    """The fault repair: an SGD training run refuses a cdlrm_tpu checkpoint
    that carries AdaGrad state, since resuming would drop the accumulators,
    and ``--inference-only`` loads and serves it (the port's analog of
    test_trainer_e2e.py:1297). An AdaGrad run refuses an SGD checkpoint, and
    adagrad_master_state one without the accumulator store."""
    ln = np.array([500, 200, 1000])
    ds = _Learnable(ln, 20, 64, seed=0)
    test_ds = _Learnable(ln, 2, 64, seed=9)

    def cfg(port, **kw):
        c = (Config if port else JaxConfig)(arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
                   mini_batch_size=64, world_size=1, cache_size=64, num_ways=4, lookahead=4,
                   loss_function="bce", print_freq=1000, learning_rate=0.05, lr_embeds=0.05,
                   **kw)
        return c.finalize(ln_emb=ln)

    jtr = JaxTrainer(cfg(False, optimizer="adagrad", dedup_lookups="on"), ds, test_ds)
    try:
        _quiet(jtr, 8)
        jtr.save_checkpoint(str(tmp_path / "ag"))
    finally:
        jtr.close()
    sgd = CachedDlrmTrainer(cfg(True), ds, test_ds, device="cpu")
    try:
        with pytest.raises(ValueError, match="AdaGrad optimizer state"):
            sgd.load_checkpoint(str(tmp_path / "ag"))
    finally:
        sgd.close()
    srv = CachedDlrmTrainer(cfg(True, inference_only=True), ds, test_ds, device="cpu")
    try:
        srv.load_checkpoint(str(tmp_path / "ag"))
        assert srv.global_step == 8 and srv.embed_acc is None
        acc, auc = srv.evaluate(log_fn=lambda *_: None)
        assert 0.0 <= acc <= 1.0 and srv.metrics.eval_hit_rate > 0
    finally:
        srv.close()
    master = CachedDlrmTrainer(cfg(True, optimizer="adagrad", dedup_lookups="on",
                                   adagrad_master_state=True), ds, device="cpu")
    try:
        with pytest.raises(ValueError, match="no accumulator store"):
            master.load_checkpoint(str(tmp_path / "ag"))
    finally:
        master.close()
    plain = CachedDlrmTrainer(cfg(True), ds, device="cpu")
    plain.save_checkpoint(str(tmp_path / "sgd"))
    plain.close()
    ag = CachedDlrmTrainer(cfg(True, optimizer="adagrad", dedup_lookups="on"), ds,
                           device="cpu")
    try:
        with pytest.raises(ValueError, match="carries no optimizer state"):
            ag.load_checkpoint(str(tmp_path / "sgd"))
    finally:
        ag.close()
