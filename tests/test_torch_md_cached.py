"""Cached mixed-dimension tables (``md_flag`` with the cache) in
cdlrm_tpu_torch against cdlrm_tpu's, and against the port's own full-table
MD trainer.

The masters hold compact ``[n_t, d_t]`` rows and put zero-padded ``[., D]``
rows on the wire; the cache stays ``[R, D]``; each table's pooled output goes
through ``params["md_proj"][t]``. One generator draws the masters, the dense
weights and then one xavier block per compressed table, in cdlrm_tpu's order,
so both packages start bit-equal and train within 1e-5 in float32 (the dense
math's summation order). Fully resident, the cached trajectory equals the
full-table MD oracle's within rtol 2e-4, atol 1e-6 (tests/test_trainer_e2e.py's
tolerance for cached against full-table). The padded columns of a cache row
stay exactly zero.
"""

import numpy as np
import pytest
import torch

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.cache.master import MDMasterTables
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.models.dlrm import param_leaves, params_from_jax, params_to_jax
from cdlrm_tpu_torch.parallel.multihost import ShardedMasterTables
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from test_torch_adagrad import _jax_leaves
from test_torch_fulltable import _Learnable

TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(rtol=2e-4, atol=1e-6)


def _cfg(port: bool, ln_emb, **kw):
    base = dict(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=64, world_size=1, cache_size=32, num_ways=2, lookahead=4,
        loss_function="bce", print_freq=4, learning_rate=0.2, lr_embeds=0.2,
        md_flag=True, md_temperature=1.0, eviction_fifo_size=64,
    )
    base.update(kw)
    return (Config if port else JaxConfig)(**base).finalize(ln_emb=np.asarray(ln_emb))


def _pad_columns_zero(tr, dims):
    """Every cache row's columns past its table's width are exactly zero."""
    cache = np.array(tr.cache, dtype=np.float32)
    for t, d_t in enumerate(dims):
        lo = int(tr.geo.table_offsets[t])
        hi = int(tr.geo.table_offsets[t + 1]) if t + 1 < len(dims) else tr.geo.trash_row
        assert not cache[lo:hi, d_t:].any(), f"table {t}: padded columns moved"


def _run(tr, steps):
    """Train with the eviction thread held and flush at the end (writebacks
    race the prefetcher's gathers in both packages); returns windows, cache,
    parameter leaves and masters."""
    tr.eviction_manager.start = lambda: None
    windows = []
    tr._log_metrics = lambda kind, payload: windows.append(dict(payload))
    tr.train(max_steps=steps, log_fn=lambda *_: None)
    assert tr.eviction_manager.flush()
    leaves = params_to_jax if isinstance(tr, CachedDlrmTrainer) else _jax_leaves
    return dict(windows=windows, cache=np.array(tr.cache, dtype=np.float32),
                params=leaves(tr.params), masters=[t.copy() for t in tr.master.tables],
                written=tr.eviction_manager.rows_written)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(dedup_lookups="on"),
    dict(master_init="virtual", dedup_lookups="on", wire_rows_bf16=True),
    dict(scan_steps=2, pack_wire=False, dedup_lookups="on"),
], ids=["plain-wire", "dedup-wire", "virtual-masters-bf16-rows", "coalesced-blocks"])
def test_cached_md_trains_like_cdlrm_tpu(kw):
    """Under cache pressure (evictions write compact rows back through the
    padded wire): the same initial state, bit for bit, and the trajectory
    within 1e-5; virtual masters take the row-sharded class with one whole
    shard, as cdlrm_tpu does."""
    ln_emb, steps = [500, 200, 1000], 16
    ds = _Learnable(np.asarray(ln_emb), steps + 4, 64, seed=3)
    jtr = JaxTrainer(_cfg(False, ln_emb, **kw), ds)
    ptr = CachedDlrmTrainer(_cfg(True, ln_emb, **kw), ds, device="cpu")
    try:
        dims = ptr.cfg.m_spa_per_table
        assert dims == jtr.cfg.m_spa_per_table and any(d < 8 for d in dims)
        virtual = kw.get("master_init") == "virtual"
        assert isinstance(ptr.master, ShardedMasterTables if virtual else MDMasterTables)
        assert type(jtr.master).__name__ == type(ptr.master).__name__
        for a, b in zip(params_to_jax(ptr.params), _jax_leaves(jtr.params)):
            np.testing.assert_array_equal(a, b)  # bot, md_proj, top: the same draws
        for pm, jm, d_t in zip(ptr.master.tables, jtr.master.tables, dims):
            assert pm.shape[1] == d_t
            np.testing.assert_array_equal(pm, jm)
        j, p = _run(jtr, steps), _run(ptr, steps)
        assert p["written"] == j["written"] > 0
        assert len(p["windows"]) == len(j["windows"]) == steps // 4
        for pw, jw in zip(p["windows"], j["windows"]):
            assert pw["hit_rate"] == jw["hit_rate"]
            np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)
        np.testing.assert_allclose(p["cache"], j["cache"], **TOL)
        assert len(p["params"]) == len(j["params"]) == len(param_leaves(ptr.params))
        for a, b in zip(p["params"], j["params"]):
            np.testing.assert_allclose(a, b, **TOL)
        for pm, jm in zip(p["masters"], j["masters"]):
            np.testing.assert_allclose(pm, jm, **TOL)
        _pad_columns_zero(ptr, dims)
        # the projections' pad rows stay zero, a full-width table's identity frozen
        proj = ptr.params["md_proj"].numpy()
        for t, d_t in enumerate(dims):
            if d_t < 8:
                assert not proj[t, d_t:].any() and proj[t, :d_t].any()
            else:
                np.testing.assert_array_equal(proj[t], np.eye(8, dtype=np.float32))
        # eval runs through the projection, equal within the scores' tolerance
        ptr.test_dataset = jtr.test_dataset = ds
        p_acc, p_auc = ptr.evaluate(max_batches=3, log_fn=lambda *_: None)
        j_acc, j_auc = jtr.evaluate(max_batches=3, log_fn=lambda *_: None)
        assert p_acc == j_acc and abs(p_auc - j_auc) <= 1e-6
    finally:
        jtr.close()
        ptr.close()


def test_cached_md_equals_fulltable_md_oracle_when_fully_resident():
    """The analog of tests/test_trainer_e2e.py:491 with the port's own
    full-table MD trainer as the oracle: it looks each row up, projects it,
    then pools (``md_lookup``), where the cached form pools zero-padded rows
    and projects after; the two are the same sum. The full-table trainer
    trains a projection with ``lr_embeds`` and the cached one with the dense
    rate, so the run uses one rate for both. ``md_threshold=1`` makes every
    table an MD entry, as the cached path treats them."""
    ln_emb = np.array([40, 25, 60])
    steps, b = 12, 16
    kw = dict(mini_batch_size=b, cache_size=64, lookahead=3, print_freq=1000,
              learning_rate=0.2, lr_embeds=0.2, md_threshold=1)
    cfg = _cfg(True, ln_emb, **kw)
    dims, dim = cfg.m_spa_per_table, cfg.m_spa
    assert any(d < dim for d in dims), f"no compression at {dims}"
    assert any(d == dim for d in dims), "want a full-width table, to pin the freezing"
    assert all(int(n) <= cfg.cache_sets for n in ln_emb)  # fully resident
    ds = _Learnable(ln_emb, steps + 2, b, seed=3)
    tr = CachedDlrmTrainer(cfg, ds, device="cpu")
    oracle = FullTableDlrmTrainer(_cfg(True, ln_emb, use_cache=False, **kw), ds, device="cpu")
    # the oracle starts from the cached run's masters, dense weights and
    # projections
    oracle.params = {k: [(w.clone(), bb.clone()) for w, bb in tr.params[k]]
                     for k in ("bot", "top")}
    proj0 = tr.params["md_proj"].clone()
    for t, e in enumerate(oracle.emb_entries):
        assert tuple(e.weight.shape) == (ln_emb[t], dims[t])
        e.weight.copy_(torch.from_numpy(tr.master.tables[t]))
        assert (e.proj is None) == (dims[t] == dim)
        if e.proj is not None:
            e.proj.copy_(proj0[t, : dims[t]])
    try:
        tr.train(max_steps=steps, log_fn=lambda *_: None)
        oracle.train(max_steps=steps, log_fn=lambda *_: None)
        for key in ("bot", "top"):
            for (w, bb), (wo, bo) in zip(tr.params[key], oracle.params[key]):
                np.testing.assert_allclose(w.numpy(), wo.numpy(), **ORACLE_TOL)
                np.testing.assert_allclose(bb.numpy(), bo.numpy(), **ORACLE_TOL)
        proj = tr.params["md_proj"].numpy()
        cache = tr.cache.numpy()
        for t, e in enumerate(oracle.emb_entries):
            if e.proj is None:
                np.testing.assert_array_equal(proj[t], np.eye(dim, dtype=np.float32))
            else:
                assert not np.array_equal(proj[t], proj0[t].numpy())  # it trained
                np.testing.assert_allclose(proj[t, : dims[t]], e.proj.numpy(), **ORACLE_TOL)
                np.testing.assert_array_equal(proj[t, dims[t]:], 0.0)
            ids = np.unique(np.concatenate(
                [bt.ls_i[t] for bt, _ in zip(ds.batches(), range(steps))]))
            sets_t = int(tr.geo.sets[t])
            eq = tr.controller.occupancy[t][ids % sets_t] == ids[:, None]
            assert eq.any(axis=1).all(), f"table {t}: seen ids not resident"
            slots = tr.geo.table_offsets[t] + eq.argmax(axis=1) * sets_t + ids % sets_t
            np.testing.assert_allclose(cache[slots][:, : dims[t]], e.weight.numpy()[ids],
                                       **ORACLE_TOL)
            np.testing.assert_array_equal(cache[slots][:, dims[t]:], 0.0)
    finally:
        tr.close()
        oracle.close()


@pytest.mark.parametrize("writer", ["port", "cdlrm_tpu"])
def test_cached_md_checkpoints_cross_packages(tmp_path, writer):
    """The analog of tests/test_trainer_e2e.py:603 across packages: one
    package trains under pressure and saves (``dense_params.npz`` holds the
    bottom MLP, ``md_proj``, the top MLP, in that order; the dirty masters
    stay compact); both load it and train on alike within 1e-5."""
    ln_emb, save_at, steps = [500, 200, 1000], 12, 20
    ck = str(tmp_path / "ck")
    ds = _Learnable(np.asarray(ln_emb), steps + 4, 64, seed=5)

    def trainer(port):
        cfg = _cfg(port, ln_emb, dedup_lookups="on")
        return CachedDlrmTrainer(cfg, ds, device="cpu") if port else JaxTrainer(cfg, ds)

    tr = trainer(writer == "port")
    try:
        saved = _run(tr, save_at)
        tr.save_checkpoint(ck)
    finally:
        tr.close()
    with np.load(f"{ck}/dense_params.npz") as data:
        shapes = [data[f"leaf_{i}"].shape for i in range(len(data.files))]
    assert shapes == [(13, 16), (16,), (16, 8), (8,), (3, 8, 8), (14, 8), (8,), (8, 1), (1,)]
    runs = []
    for port in (True, False):
        tr = trainer(port)
        try:
            tr.load_checkpoint(ck)
            leaves = params_to_jax if port else _jax_leaves
            for a, b in zip(leaves(tr.params), saved["params"]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(tr.master.tables, saved["masters"]):
                np.testing.assert_array_equal(a, b)
            runs.append(_run(tr, steps))
        finally:
            tr.close()
    p, j = runs
    np.testing.assert_allclose(p["cache"], j["cache"], **TOL)
    for key in ("params", "masters"):
        for a, b in zip(p[key], j[key]):
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)
    for pw, jw in zip(p["windows"], j["windows"]):
        np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)


def test_md_checkpoint_does_not_load_into_a_plain_model(tmp_path):
    ln_emb = [500, 200, 1000]
    ds = _Learnable(np.asarray(ln_emb), 8, 64, seed=5)
    tr = CachedDlrmTrainer(_cfg(True, ln_emb), ds, device="cpu")
    try:
        tr.train(max_steps=4, log_fn=lambda *_: None)
        tr.save_checkpoint(str(tmp_path / "ck"))
    finally:
        tr.close()
    plain = CachedDlrmTrainer(_cfg(True, ln_emb, md_flag=False), ds, device="cpu")
    try:
        with pytest.raises(ValueError, match="dense leaves"):
            plain.load_checkpoint(str(tmp_path / "ck"))
    finally:
        plain.close()


def test_qr_with_the_cache_raises_cdlrm_tpu_error():
    """tests/test_trainer_e2e.py:637: the same error, for the same reason."""
    ln_emb = np.array([500, 200, 1000])
    ds = _Learnable(ln_emb, 4, 64, seed=1)
    errors = []
    for port in (False, True):
        cfg = _cfg(port, ln_emb, md_flag=False, qr_flag=True, qr_collisions=4)
        with pytest.raises(ValueError, match="qr_flag with the cached path") as err:
            CachedDlrmTrainer(cfg, ds, device="cpu") if port else JaxTrainer(cfg, ds)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_md_adagrad_is_refused_by_both_configs():
    for cls in (JaxConfig, Config):
        with pytest.raises(ValueError, match="plain embeddings only"):
            cls(arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
                md_flag=True, optimizer="adagrad", dedup_lookups="on").finalize(
                    ln_emb=np.array([500, 200]))


def test_step_refuses_adagrad_with_md_proj():
    """``_dense_adagrad`` walks the MLPs only; the step refuses the pair as
    Config.finalize does."""
    from cdlrm_tpu_torch.train import step as tstep

    ln_emb = [500, 200, 1000]
    ds = _Learnable(np.asarray(ln_emb), 2, 64, seed=1)
    tr = CachedDlrmTrainer(_cfg(True, ln_emb, dedup_lookups="on"), ds, device="cpu")
    try:
        assert tr.step_cfg.md_proj and len(tr.step_cfg.md_train_mask) == 3
        with pytest.raises(ValueError, match="md_proj"):
            tstep.make_cached_train_step(
                tr.geo, tr.step_cfg._replace(dedup=True, optimizer="adagrad"))
    finally:
        tr.close()


def test_params_carry_md_proj_across_packages():
    """``params_from_jax`` / ``params_to_jax`` keep ``md_proj`` between the
    bottom and the top MLP, as ``jax.tree_util.tree_flatten`` orders the
    keys."""
    import jax

    ln_emb = [500, 200, 1000]
    ds = _Learnable(np.asarray(ln_emb), 4, 64, seed=1)
    jtr = JaxTrainer(_cfg(False, ln_emb), ds)
    try:
        tree = jstep.unreplicate(jtr.params)
    finally:
        jtr.close()
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    from_tree = params_from_jax(tree)
    from_leaves = params_from_jax(leaves, n_bot=2, md_proj=True)
    assert set(from_tree) == {"bot", "md_proj", "top"}
    for got in (from_tree, from_leaves):
        assert tuple(got["md_proj"].shape) == (3, 8, 8)
        for a, b in zip(params_to_jax(got), leaves):
            np.testing.assert_array_equal(a, b)
