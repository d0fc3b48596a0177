"""cdlrm_tpu_torch's sorted unpacked dedup wire (``Config.sorted_dedup_wire``)
against cdlrm_tpu's, on the CPU.

The sorted wire lays each step's unique rows out in ascending order from
position 0, trash padding at the tail, and ranks masked lookups to the last
position (cdlrm_tpu/train/step.py:304-328, trainer.py:1186-1197); the valid
prefix of the unique-row add is the unique count, not the count + 1 of the
default layout (step.py:812-818), and the coalesced block's rank rows start
at position 0 (trainer.py:1729). The decode is exact against cdlrm_tpu's.
The trainers, SGD and AdaGrad, single-index and pooled, single steps and
scan blocks of 3 (coalesced under SGD), agree with cdlrm_tpu within 1e-5 in
cache, parameters, AdaGrad state, per-window loss and masters, and exactly in
hits; and the port's sorted run is bit-equal to its unsorted run, since a
layout that only permutes the bucket changes no sum: each unique row's
gradient is the sum of its lookups in lookup order either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as W
from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.cache.geometry import CacheGeometry
from cdlrm_tpu_torch.cache.host_cache import HostCacheController
from cdlrm_tpu_torch.cache.master import MasterTables
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.models.dlrm import param_leaves
from cdlrm_tpu_torch.train import step as pstep
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

TOL = dict(atol=1e-5, rtol=1e-5)
LN_EMB = np.array([50, 200, 700])


@pytest.mark.parametrize("pooled", [False, True], ids=["single", "pooled"])
@pytest.mark.parametrize("srt", [True, False], ids=["sorted", "default"])
def test_decode_matches_cdlrm_tpu(srt, pooled):
    """A probe's ranks and unique rows, laid out as the trainer stages them,
    through both packages' ``_decode_dedup_raw``: the same unique rows and
    ranks, bit for bit; every lookup's rank names its own row."""
    geo = CacheGeometry.build(LN_EMB, 8, 32, 4, 64)
    rng = np.random.default_rng(5)
    ctl = HostCacheController(geo, seed=1, ln_emb=LN_EMB, slot_map=True)
    master = MasterTables(LN_EMB, 8, rng=np.random.default_rng(1))
    ids = np.stack([rng.integers(0, n, 96) for n in LN_EMB])
    uniq = [np.unique(ids[t][:48]) for t in range(3)]  # half the ids resident
    ctl.plan_insert(uniq, master.gather_all(uniq))
    valid = rng.random(ids.shape) < 0.7 if pooled else None
    dr = ctl.probe_dedup_raw(ids, master, valid=valid, sort=srt)
    u, cnt = dr.uniq, dr.uniq_counts
    ub = 1024
    row = np.full(ub, geo.trash_row, np.int32)
    if srt:
        row[: u.size] = u
        assert (np.diff(u) > 0).all()
    else:
        row[1: 1 + u.size] = u
    cnt = cnt.astype(np.int32)
    ju, jg = jstep._decode_dedup_raw(jnp.asarray(dr.inv_wire), jnp.asarray(row),
                                     jnp.asarray(cnt), srt)
    pu, pg = pstep._decode_dedup_raw(torch.from_numpy(dr.inv_wire), torch.from_numpy(row),
                                     torch.from_numpy(cnt), srt)
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    assert pg.dtype == torch.int32
    # each valid lookup resolves to its probe slot; masked ones to the trash
    slots = ctl.probe(ids, master, valid=valid).slots.reshape(-1)
    np.testing.assert_array_equal(row[pg.numpy()], slots)
    if pooled:
        assert (pg.numpy()[~valid.reshape(-1)] == (ub - 1 if srt else 0)).all()


def _run(port: bool, srt: bool, opt: str, pooled: bool, scan: int, steps: int = 12):
    ada = dict(optimizer="adagrad", learning_rate=0.05, lr_embeds=0.05) if opt == "adagrad" else {}
    cfg = W.make_cfg(Config if port else JaxConfig, LN_EMB, world_size=1, mini_batch_size=64,
                     lookahead=6, print_freq=3, table_agg_freq=3, scan_steps=scan,
                     dedup_lookups="on", pack_wire=False, sorted_dedup_wire=srt, **ada)
    ds = W.Stream(LN_EMB, num_batches=steps + 2, batch=64, seed=3, pooled=3 if pooled else 0)
    tr = CachedDlrmTrainer(cfg, ds, device="cpu") if port else JaxTrainer(cfg, ds)
    try:
        tr.eviction_manager.start = lambda: None  # hold the writebacks
        out = W.train_and_collect(
            tr, steps, to_numpy=(lambda t: t.detach().cpu().numpy()) if port else np.asarray)
        if port:
            out["params"] = [p.detach().numpy() for p in param_leaves(tr.params)]
        else:
            out["params"] = [np.asarray(a)[0] for a in jax.tree_util.tree_leaves(tr.params)]
        assert tr.eviction_manager.flush()
        out["masters"] = [np.array(t) for t in tr.master.tables]
        out["written"] = tr.eviction_manager.rows_written
        return out
    finally:
        tr.close()


@pytest.mark.parametrize("scan", [1, 3])
@pytest.mark.parametrize("pooled", [False, True], ids=["single", "pooled"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_trainer_sorted_wire_matches_cdlrm_tpu(opt, pooled, scan):
    want = _run(False, True, opt, pooled, scan)
    got = _run(True, True, opt, pooled, scan)
    assert got["global_step"] == want["global_step"] == 12
    for key in ("hits", "lookups", "refills", "written"):
        assert got[key] == want[key], key
    assert got["written"] > 0  # the third table evicts
    assert got["win_dedup"].all()
    np.testing.assert_allclose(got["win_loss"], want["win_loss"], **TOL)
    keep = np.ones(got["cache"].shape[0], bool)
    keep[-1] = False  # the trash row's value is unspecified by contract
    np.testing.assert_allclose(got["cache"][keep], want["cache"][keep], **TOL)
    if opt == "adagrad":
        np.testing.assert_allclose(got["embed_acc"][keep], want["embed_acc"][keep], **TOL)
    for g, w in zip(got["params"], want["params"]):
        np.testing.assert_allclose(g, w, **TOL)
    for g, w in zip(got["masters"], want["masters"]):
        np.testing.assert_allclose(g, w, **TOL)
    # SGD's blocks of 3 take the block-coalesced update
    if scan == 3:
        assert ("(3, True, True)" in list(got["step_keys"])) == (opt == "sgd")
    # the default layout: the same bits
    base = _run(True, False, opt, pooled, scan)
    for key in ("cache", "win_loss", "embed_acc"):
        if key in base:
            np.testing.assert_array_equal(got[key], base[key], err_msg=key)
    for g, b in zip(got["params"] + got["masters"], base["params"] + base["masters"]):
        np.testing.assert_array_equal(g, b)


def test_sorted_wire_stays_off_the_plain_steps(monkeypatch):
    """Only the dedup steps take the sorted wire (cdlrm_tpu trainer.py:527-530):
    under dedup_lookups='auto' a window on the plain wire builds a step
    without it."""
    ds = W.Stream(LN_EMB, num_batches=4, batch=64)
    cfg = W.make_cfg(Config, LN_EMB, world_size=1, pack_wire=False, sorted_dedup_wire=True)
    tr = CachedDlrmTrainer(cfg, ds, device="cpu")
    try:
        built = []
        make = pstep.make_cached_train_step
        monkeypatch.setattr(pstep, "make_cached_train_step", lambda geo, scfg, *a, **k:
                            built.append(scfg) or make(geo, scfg, *a, **k))
        tr._get_step(1, False)
        tr._get_step(1, True)
        assert [s.sorted_wire for s in built] == [False, True]
    finally:
        tr.close()
