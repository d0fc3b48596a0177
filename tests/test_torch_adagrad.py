"""cdlrm_tpu_torch's AdaGrad against cdlrm_tpu's, on the same seeded inputs.

Layers pinned here, from the optimizer math up:

- ``_dense_adagrad`` (element-wise, torch.optim.Adagrad semantics) and
  ``_rowwise_adagrad_scale`` (torchrec's row-wise AdaGrad) against
  cdlrm_tpu's, within 1e-6;
- one cached train step on the dedup wire with the row-wise state riding
  along, on the same wire bytes (packed and unpacked, single-index and
  pooled): cache, ``embed_acc``, parameters and ``dense_acc`` within 1e-5;
  the trash row's state stays exactly 0;
- the refill step's two AdaGrad forms (the state reset to 0, and the master
  state's gather and resume), exact;
- the cached trainer's trajectory against cdlrm_tpu's (scan 1 and 3, the
  packed and unpacked dedup wires, plain and master state), within 1e-5;
- the longhand AdaGrad oracle (the analog of test_trainer_e2e.py:1093), for
  the cached and the full-table trainer, rtol 2e-4 and atol 1e-6, and the
  master state's oracle distance under eviction (the analog of
  test_adagrad_master_state.py:260);
- the eviction fence before the resume-accumulator gather, on the boundary
  and behind the refill stager (test_adagrad_master_state.py:313, :373).

The float32 differences are the dense math's summation order only."""

import itertools
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cdlrm_tpu_torch.cache.host_cache import InsertPlan
from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.parallel.mesh import make_dp_mesh
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config, finalize
from cdlrm_tpu_torch.models.dlrm import params_to_jax
from cdlrm_tpu_torch.train import step as tstep
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from test_adagrad_master_state import (
    BATCH as CYC_BATCH, LN as CYC_LN, WINDOW as CYC_WINDOW, _CycleStream, _longhand_oracle,
    _param_dist,
)
from test_torch_train_trainer import LN_EMB, _SkewSwitch

TOL = dict(atol=1e-5, rtol=1e-5)
ORACLE_TOL = dict(rtol=2e-4, atol=1e-6)


def _jax_leaves(tree) -> list:
    """cdlrm_tpu's replicated params (or dense_acc) as host leaves in
    tree_flatten order."""
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(jstep.unreplicate(tree))]


def _assert_leaves_close(port_tree, jax_tree, **tol):
    got, want = params_to_jax(port_tree), _jax_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **tol)


# ------------------------------------------------------------ optimizer math


@pytest.mark.parametrize("eps", [1e-10, 1e-2])
def test_adagrad_math_matches_jax(eps):
    rng = np.random.default_rng(7)
    shapes = {"bot": [((13, 8), (8,)), ((8, 4), (4,))], "top": [((4, 1), (1,))]}

    def tree(scale, positive=False):
        def draw(s):
            a = rng.normal(scale=scale, size=s).astype(np.float32)
            return np.abs(a) if positive else a
        return {k: [(draw(w), draw(b)) for w, b in v] for k, v in shapes.items()}

    params, grads, acc = tree(1.0), tree(0.1), tree(0.05, positive=True)
    lr = float(np.float32(0.05))
    j_params, j_acc = jstep._dense_adagrad(params, grads, jnp.float32(lr), acc, eps)
    t = {k: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in v] for k, v in params.items()}
    t_acc = {k: [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in v]
             for k, v in acc.items()}
    dflat = [torch.from_numpy(a) for k in ("bot", "top") for pair in grads[k] for a in pair]
    p_params, p_acc = tstep._dense_adagrad(t, dflat, lr, t_acc, eps)
    for got, want in ((p_params, j_params), (p_acc, j_acc)):
        for g, w in zip(params_to_jax(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)

    d_rows = rng.normal(scale=0.1, size=(300, 16)).astype(np.float32)
    d_rows[::7] = 0.0  # rows without a gradient keep their state, delta 0
    acc_rows = np.abs(rng.normal(scale=0.01, size=300)).astype(np.float32)
    acc_rows[::11] = 0.0
    j_delta, j_rows = jstep._rowwise_adagrad_scale(d_rows, acc_rows, jnp.float32(0.3), eps)
    p_delta, p_rows = tstep._rowwise_adagrad_scale(
        torch.from_numpy(d_rows), torch.from_numpy(acc_rows), float(np.float32(0.3)), eps)
    np.testing.assert_allclose(p_rows.numpy(), np.asarray(j_rows), rtol=1e-6, atol=0)
    np.testing.assert_allclose(p_delta.numpy(), np.asarray(j_delta), rtol=1e-6, atol=1e-9)
    assert np.array_equal(p_rows.numpy()[::7], acc_rows[::7])
    assert not p_delta.numpy()[::7].any()


# ------------------------------------------------------------------- steps


def _step_cfg(port: bool, **kw):
    base = dict(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=128, num_ways=4,
        loss_function="bce", round_targets=True, optimizer="adagrad", dedup_lookups="on",
        learning_rate=0.05, lr_embeds=0.1,
    )
    base.update(kw)
    ln = np.array([1000, 500, 2000])
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=ln)


@pytest.mark.parametrize("pooled", [0, 3])
@pytest.mark.parametrize("pack", [True, False])
def test_adagrad_dedup_step_matches_jax(pack, pooled):
    """One AdaGrad step on the same wire bytes (a batch part resident, part
    missing), from equal caches, parameters and state; the row-wise state
    starts from seeded positive values, so the step both adds to it and
    scales by it."""
    ln = np.array([1000, 500, 2000])
    kw = {} if not pooled else dict(num_indices_per_lookup=pooled,
                                    num_indices_per_lookup_fixed=False)
    ds = SyntheticDataset(m_den=13, ln_emb=ln, data_size=64 * 4, mini_batch_size=64,
                          seed=5, round_targets=True, **kw)
    jtr = JaxTrainer(_step_cfg(False, pack_wire=pack), ds)
    ptr = CachedDlrmTrainer(_step_cfg(True, pack_wire=pack), ds, device="cpu")
    try:
        batches = list(itertools.islice(ds.batches(), 4))
        uniques = []
        for t in range(len(ln)):
            parts = [b.ls_i[t] if b.ls_mask is None else b.ls_i[t][b.ls_mask[t]]
                     for b in batches[:2]]
            uniques.append(np.unique(np.concatenate([p.reshape(-1) for p in parts])))
        j_plan = jtr.controller.plan_insert(uniques, jtr.master.gather_all(uniques))
        jtr.cache, jtr.embed_acc, _ = jtr.refill_step(
            jtr.cache, *jtr._refill_device_inputs(j_plan), jtr.embed_acc)
        ptr.refill(ptr.controller.plan_insert(uniques, ptr.master.gather_all(uniques)))
        np.testing.assert_array_equal(ptr.cache.numpy(), np.asarray(jtr.cache))
        trash = ptr.geo.trash_row
        acc0 = np.abs(np.random.default_rng(3).normal(
            scale=0.01, size=ptr.geo.total_rows)).astype(np.float32)
        acc0[trash] = 0.0
        ptr.embed_acc = torch.from_numpy(acc0.copy())
        jtr.embed_acc = jax.device_put(acc0, jtr.embed_acc.sharding)

        j_in, _, j_dedup, _ = jtr._assemble(batches[3], 64)
        p_in, stats, p_dedup, _ = ptr._assemble(batches[3], 64)
        assert j_dedup and p_dedup and 0 < stats.hits < stats.lookups
        for a, b in zip(j_in, p_in):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        j_params, j_cache, _, j_dacc, j_eacc, j_loss, j_corr = jtr._get_step(1, True)(
            jtr.params, jtr.cache, jtr.touched, *j_in, jtr.dense_acc, jtr.embed_acc,
            jtr._lr, jtr._lr_emb,
        )
        cache0 = ptr.cache.numpy().copy()
        p_params, p_cache, p_dacc, p_eacc, p_loss, p_corr = ptr._get_step(1, True)(
            ptr.params, ptr.cache, *p_in, ptr.dense_acc, ptr.embed_acc, ptr._lr, ptr._lr_emb,
        )
        np.testing.assert_allclose(p_loss.item(), float(j_loss), **TOL)
        assert p_corr.item() == float(j_corr)
        np.testing.assert_allclose(p_cache.numpy(), np.asarray(j_cache), **TOL)
        np.testing.assert_allclose(p_eacc.numpy(), np.asarray(j_eacc), **TOL)
        _assert_leaves_close(p_params, j_params, **TOL)
        _assert_leaves_close(p_dacc, j_dacc, **TOL)
        moved = np.abs(p_cache.numpy() - cache0).max(axis=1) > 0
        grew = p_eacc.numpy() > acc0
        assert moved.any() and grew.any()
        assert not (grew & ~moved).any()  # state grows only where rows move
        assert p_eacc[trash].item() == 0.0  # the trash row's state stays 0
    finally:
        jtr.close()
        ptr.close()


@pytest.mark.parametrize("master", [False, True])
def test_refill_step_adagrad_forms_match_jax(master):
    """The refill step's AdaGrad forms move the same float32 values as
    cdlrm_tpu's (off mode, XLA path), exactly: the evicted rows and state
    gathered before the insert, the inserted state reset to 0 or resumed."""
    from cdlrm_tpu.cache.geometry import CacheGeometry

    rng = np.random.default_rng(4)
    d = 16
    geo = CacheGeometry.build([300, 1200, 2000], d, 64, 4, 32)
    tr = geo.trash_row
    cache0 = rng.normal(size=(geo.total_rows, d)).astype(np.float32)
    acc0 = rng.random(geo.total_rows).astype(np.float32)
    acc0[tr] = 0.0
    n_ins, n_ev = 200, 77
    ins = rng.permutation(tr)[:n_ins].astype(np.int32)
    ins_slots = np.concatenate([ins, np.full(256 - n_ins, tr, np.int32)])
    ins_rows = np.zeros((256, d), np.float32)
    ins_rows[:n_ins] = rng.normal(size=(n_ins, d))
    ins_acc = np.zeros(256, np.float32)
    ins_acc[:n_ins] = rng.random(n_ins)
    ev = ins[rng.permutation(n_ins)[:n_ev]]
    ev_slots = np.concatenate([ev, np.zeros(128 - n_ev, np.int32)])
    kw = dict(refill_broadcast="off", optimizer="adagrad", adagrad_master_state=master)
    j_args = [jnp.asarray(cache0), jnp.asarray(ins_slots), jnp.asarray(ins_rows),
              jnp.asarray(ev_slots), jnp.asarray(acc0)] + ([jnp.asarray(ins_acc)] if master else [])
    j_out = jstep.make_refill_step(make_dp_mesh(1), jstep.StepConfig(**kw), trash_row=tr)(*j_args)
    p_args = [torch.from_numpy(a.copy()) for a in (cache0, ins_slots, ins_rows, ev_slots, acc0)]
    p_args += [torch.from_numpy(ins_acc)] if master else []
    p_out = tstep.make_refill_step(tstep.StepConfig(**kw), trash_row=tr)(*p_args)
    assert len(p_out) == len(j_out) == (4 if master else 3)
    np.testing.assert_array_equal(p_out[0].numpy()[:tr], np.asarray(j_out[0])[:tr])
    for got, want in zip(p_out[1:], j_out[1:]):  # accum, evicted (, ev_acc)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    acc = p_out[1].numpy()
    np.testing.assert_array_equal(acc[ins], ins_acc[:n_ins] if master else 0.0)
    assert acc[tr] == 0.0
    if master:
        np.testing.assert_array_equal(p_out[3].numpy()[:n_ev], acc0[ev])  # pre-insert state


# -------------------------------------------------------------- trajectories


def _traj_cfg(port: bool, **kw):
    base = dict(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=64, num_ways=4,
        loss_function="bce", lookahead=4, print_freq=4, round_targets=True,
        eviction_fifo_size=64, optimizer="adagrad", dedup_lookups="on",
        learning_rate=0.05, lr_embeds=0.1,
    )
    base.update(kw)
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=LN_EMB)


def _cycle_cfg(port: bool, master: bool, **kw):
    """test_adagrad_master_state.py's regime: every window evicts the
    previous one whole, and an id comes back four windows later."""
    base = dict(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=CYC_BATCH, world_size=1, cache_size=16, num_ways=4,
        loss_function="bce", lookahead=CYC_WINDOW, print_freq=CYC_WINDOW,
        learning_rate=0.05, lr_embeds=0.1, optimizer="adagrad", dedup_lookups="on",
        adagrad_eps=1e-2, adagrad_master_state=master, batch_fifo_size=1,
        refill_prestage=False, round_targets=True,
    )
    base.update(kw)
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=CYC_LN)


def _run(tr, steps, sync_writeback=False):
    """Train ``tr`` (either package's cached trainer) up to step ``steps``
    with the eviction thread held: writebacks wait for the end (or, with
    ``sync_writeback``, apply inline at each boundary, the regime of
    test_adagrad_master_state.py), then close it. Returns the print windows,
    the state on the host (AdaGrad's None under SGD) and the store's
    accumulators."""
    tr.eviction_manager.start = lambda: None
    real_put = tr.eviction_fifo.put
    if sync_writeback:
        tr.eviction_fifo.put = lambda item: tr.eviction_manager._apply(item)
    windows = []
    tr._log_metrics = lambda kind, payload: windows.append(dict(payload))
    try:
        tr.train(max_steps=steps, log_fn=lambda *_: None)
        assert tr.eviction_manager.flush()
        leaves = params_to_jax if isinstance(tr, CachedDlrmTrainer) else _jax_leaves
        adagrad = tr.embed_acc is not None
        out = dict(
            windows=windows, cache=np.array(tr.cache, dtype=np.float32),
            embed_acc=np.array(tr.embed_acc, dtype=np.float32) if adagrad else None,
            params=leaves(tr.params), dense_acc=leaves(tr.dense_acc) if adagrad else [],
            masters=[t.copy() for t in tr.master.tables],
            store=None if tr._acc_master is None else [a.copy() for a in tr._acc_master.accs],
            written=tr.eviction_manager.rows_written, refills=tr.metrics.refills,
            trash=tr.geo.trash_row, step=tr.global_step,
        )
    finally:
        tr.eviction_fifo.put = real_put
        tr.close()
    return out


def _assert_runs_close(p, j):
    """Two runs of _run: the same windows, refills and writebacks, and the
    state within TOL."""
    assert p["refills"] == j["refills"] and p["written"] == j["written"] > 0
    assert p["step"] == j["step"]
    assert len(p["windows"]) == len(j["windows"]) > 0
    for pw, jw in zip(p["windows"], j["windows"]):
        assert pw["hit_rate"] == jw["hit_rate"]
        np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)
    np.testing.assert_allclose(p["cache"], j["cache"], **TOL)
    for key in ("params", "dense_acc", "masters", "store"):
        assert len(p[key] or []) == len(j[key] or [])
        for a, b in zip(p[key] or [], j[key] or []):
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)
    if p["embed_acc"] is not None:
        np.testing.assert_allclose(p["embed_acc"], j["embed_acc"], **TOL)
        assert p["embed_acc"][p["trash"]] == 0.0


@pytest.mark.parametrize("scan,pack,pooled", [
    (1, True, 0), (1, False, 3), (3, True, 3), (3, False, 0),
])
def test_adagrad_trainer_matches_cdlrm_tpu(scan, pack, pooled):
    """Cache-resident state (drop at evict, reset at insert), the eviction
    writeback held to the end, on a stream whose first half repeats ids."""
    steps = 16
    ds = _SkewSwitch(steps, pooled)
    kw = dict(scan_steps=scan, pack_wire=pack)
    j = _run(JaxTrainer(_traj_cfg(False, **kw), ds), steps)
    p = _run(CachedDlrmTrainer(_traj_cfg(True, **kw), ds, device="cpu"), steps)
    _assert_runs_close(p, j)


@pytest.mark.parametrize("scan,pack", [(1, True), (3, False)])
def test_master_state_trainer_matches_cdlrm_tpu(scan, pack):
    """adagrad_master_state under whole-window evictions, writebacks inline
    at each boundary: the store's accumulators, the masters and the whole
    trajectory agree with cdlrm_tpu's."""
    steps = 18
    kw = dict(scan_steps=scan, pack_wire=pack)
    j = _run(JaxTrainer(_cycle_cfg(False, True, **kw), _CycleStream(steps + CYC_WINDOW)),
             steps, sync_writeback=True)
    p = _run(CachedDlrmTrainer(_cycle_cfg(True, True, **kw), _CycleStream(steps + CYC_WINDOW),
                               device="cpu"), steps, sync_writeback=True)
    _assert_runs_close(p, j)
    assert sum(int(np.count_nonzero(a)) for a in p["store"]) > 0


class _Learnable:
    """Uniform ids; the target is a dense feature's threshold
    (test_trainer_e2e.py LearnableDataset)."""

    m_den = 13

    def __init__(self, ln_emb, num_batches, batch, seed):
        self.ln_emb, self.num_batches, self.batch, self.seed = ln_emb, num_batches, batch, seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        from cdlrm_tpu.data.synthetic import Batch

        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            ls_i = np.stack([rng.integers(0, n, self.batch) for n in self.ln_emb])
            y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
            yield Batch(x, ls_i, None, y)


def _oracle(params0, tables0, ds, steps, lr, lr_emb, eps, loss_function):
    """Longhand AdaGrad (test_trainer_e2e.py:1136-1167): element-wise on the
    dense MLPs, row-wise over the whole tables, by jax.grad."""
    from cdlrm_tpu.models.dlrm import compute_loss, dlrm_forward

    params = {k: [(jnp.asarray(w), jnp.asarray(b)) for w, b in v] for k, v in params0.items()}
    tables = [jnp.asarray(t) for t in tables0]
    acc_p = {k: [(jnp.zeros_like(w), jnp.zeros_like(b)) for w, b in v] for k, v in params.items()}
    acc_t = [jnp.zeros(t.shape[0]) for t in tables]
    for batch in itertools.islice(ds.batches(), steps):
        x, tgt, ls = jnp.asarray(batch.x), jnp.asarray(batch.y), batch.ls_i

        def loss_fn(params, tables):
            ly = jnp.stack([tables[t][ls[t]] for t in range(len(tables))])
            return compute_loss(dlrm_forward(params, x, ly, "dot", False, 0.0), tgt, loss_function)

        g_p, g_t = jax.grad(loss_fn, argnums=(0, 1))(params, tables)
        new_p, new_a = {}, {}
        for k, v in params.items():
            new_p[k], new_a[k] = [], []
            for (w, b), (gw, gb), (aw, ab) in zip(v, g_p[k], acc_p[k]):
                aw, ab = aw + gw * gw, ab + gb * gb
                new_p[k].append((w - lr * gw / (jnp.sqrt(aw) + eps),
                                 b - lr * gb / (jnp.sqrt(ab) + eps)))
                new_a[k].append((aw, ab))
        params, acc_p = new_p, new_a
        acc_t = [a + jnp.mean(g * g, axis=1) for a, g in zip(acc_t, g_t)]
        tables = [t - lr_emb * g / (jnp.sqrt(a) + eps)[:, None]
                  for t, g, a in zip(tables, g_t, acc_t)]
    return params, [np.asarray(t) for t in tables], [np.asarray(a) for a in acc_t]


@pytest.mark.parametrize("kind", ["cached", "fulltable"])
def test_adagrad_equals_longhand_oracle_when_fully_resident(kind):
    """The analog of test_trainer_e2e.py:1093 for the port: fully resident,
    the cached trainer's seen rows and their state, and the full-table
    trainer's tables and state, equal the longhand oracle's."""
    ln_emb = np.array([40, 25, 60])
    steps, b = 12, 16
    cfg = finalize(Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=b, world_size=1, cache_size=64, num_ways=2, lookahead=3,
        loss_function="bce", print_freq=1000, learning_rate=0.1, lr_embeds=0.2,
        optimizer="adagrad", dedup_lookups="on", use_cache=kind == "cached",
    ), ln_emb=ln_emb)
    ds = _Learnable(ln_emb, steps + 2, b, seed=3)
    if kind == "cached":
        assert all(int(n) <= cfg.cache_sets for n in ln_emb)
        tr = CachedDlrmTrainer(cfg, ds, device="cpu")
        tables0 = [t.copy() for t in tr.master.tables]
    else:
        tr = FullTableDlrmTrainer(cfg, ds, device="cpu")
        tables0 = [t.numpy().copy() for t in tr.emb_tables()]
    params0 = {k: [(w.numpy().copy(), bb.numpy().copy()) for w, bb in v]
               for k, v in tr.params.items()}
    try:
        tr.train(max_steps=steps, log_fn=lambda *_: None)
    finally:
        tr.close()
    lr, lr_emb = float(np.float32(0.1)), float(np.float32(0.2))
    params_o, tables_o, acc_o = _oracle(params0, tables0, ds, steps, lr, lr_emb,
                                        cfg.adagrad_eps, cfg.loss_function)
    for got, want in zip(params_to_jax(tr.params), jax.tree_util.tree_leaves(params_o)):
        np.testing.assert_allclose(got, np.asarray(want), **ORACLE_TOL)
    if kind == "fulltable":
        for t in range(3):
            np.testing.assert_allclose(tr.emb_tables()[t].numpy(), tables_o[t], **ORACLE_TOL)
            np.testing.assert_allclose(tr.emb_tables(tr.emb_acc)[t].numpy(), acc_o[t],
                                       **ORACLE_TOL)
        return
    cache, eacc = tr.cache.numpy(), tr.embed_acc.numpy()
    for t in range(3):
        ids = np.unique(np.concatenate(
            [bt.ls_i[t] for bt in itertools.islice(ds.batches(), steps)]))
        sets_t = int(tr.geo.sets[t])
        eq = tr.controller.occupancy[t][ids % sets_t] == ids[:, None]
        assert eq.any(axis=1).all(), f"table {t}: seen ids not resident"
        slots = tr.geo.table_offsets[t] + eq.argmax(axis=1) * sets_t + ids % sets_t
        np.testing.assert_allclose(cache[slots], tables_o[t][ids], **ORACLE_TOL)
        np.testing.assert_allclose(eacc[slots], acc_o[t][ids], **ORACLE_TOL)


def _run_cycle(master: bool, steps=36):
    """The port's run of test_adagrad_master_state.py's _run_cached."""
    tr = CachedDlrmTrainer(_cycle_cfg(True, master, print_freq=1 << 20),
                           _CycleStream(steps + CYC_WINDOW), device="cpu")
    tables0 = [t.copy() for t in tr.master.tables]
    p0 = {k: [(w.numpy().copy(), b.numpy().copy()) for w, b in v] for k, v in tr.params.items()}
    out = _run(tr, steps, sync_writeback=True)
    leaves = iter(out["params"])
    params = {k: [(next(leaves), next(leaves)) for _ in tr.params[k]] for k in ("bot", "top")}
    nonzero = 0 if out["store"] is None else sum(int(np.count_nonzero(a)) for a in out["store"])
    return tr.metrics.hit_rate, params, nonzero, tables0, p0


def test_master_state_tracks_oracle_under_eviction():
    """The analog of test_adagrad_master_state.py:260: under whole-window
    evictions the port's flag-on run tracks the full-table AdaGrad oracle to
    float precision, and the flag-off run, which restarts each reinserted
    id's state, lands more than 100 times farther."""
    hit_on, params_on, nonzero_on, tables0, p0 = _run_cycle(True)
    hit_off, params_off, nonzero_off, tables0b, _ = _run_cycle(False)
    for a, b in zip(tables0, tables0b):
        np.testing.assert_array_equal(a, b)
    assert hit_on == pytest.approx(1.0) and hit_off == pytest.approx(1.0)
    assert nonzero_on > 0 and nonzero_off == 0
    oracle = _longhand_oracle(tables0, p0)
    dist_on, dist_off = _param_dist(params_on, oracle), _param_dist(params_off, oracle)
    assert dist_on < 1e-6, dist_on
    assert dist_off > 100 * dist_on, (dist_on, dist_off)


# ----------------------------------------------------------------- the fence


def _fence_trainer(prestage: bool):
    return CachedDlrmTrainer(_cycle_cfg(True, True, refill_prestage=prestage),
                             _CycleStream(8), device="cpu")


def _stop_eviction_thread(tr):
    tr.eviction_fifo.put(None)
    tr.eviction_manager.join(timeout=60)


def _one_insert_plan(d):
    return InsertPlan(
        insert_slots=np.array([5], np.int32), insert_rows=np.zeros((1, d), np.float32),
        evict_slots=np.zeros(0, np.int32), evict_tables=np.zeros(0, np.int32),
        evict_idxs=np.zeros(0, np.int64), insert_tables=np.array([0], np.int32),
        insert_ids=np.array([7], np.int64),
    )


def _slow_writeback(tr, acc_value):
    """Queue a writeback of id 7 that the eviction thread applies slowly."""
    real_apply = tr.eviction_manager._apply

    def slow_apply(item):
        time.sleep(0.3)
        real_apply(item)

    tr.eviction_manager._apply = slow_apply
    tr.eviction_manager.start()
    d = tr.geo.dim
    tr.eviction_fifo.put((
        np.array([0], np.int32), np.array([7], np.int64),
        lambda: np.full((1, d), 2.0, np.float32), lambda: np.array([acc_value], np.float32),
    ))


def test_refill_inputs_fence_waits_for_inflight_writeback():
    """The analog of test_adagrad_master_state.py:313: the resume
    accumulators are gathered behind the eviction fence, so an id evicted
    and reinserted at the next boundary resumes its written-back state."""
    tr = _fence_trainer(prestage=False)
    try:
        _slow_writeback(tr, 3.25)
        ops = tr._refill_device_inputs(_one_insert_plan(tr.geo.dim))
        assert len(ops) == 4 and ops[3][0].item() == np.float32(3.25)
        np.testing.assert_array_equal(tr.master.tables[0][7], np.full(tr.geo.dim, 2.0))
    finally:
        tr.close()
        _stop_eviction_thread(tr)


def test_stager_defers_acc_gather_to_boundary_fence():
    """The analog of test_adagrad_master_state.py:373: the stager stages the
    three row operands only, and the boundary adds the fourth behind a fence
    on the train thread, after a writeback queued since."""
    tr = _fence_trainer(prestage=True)
    try:
        plan = _one_insert_plan(tr.geo.dim)
        staged = tr._refill_device_inputs(plan, stage_acc=False)
        assert len(staged) == 3
        _slow_writeback(tr, 4.5)
        done = tr._complete_staged_acc(plan, staged)
        assert len(done) == 4 and done[3][0].item() == np.float32(4.5)
    finally:
        tr.close()
        _stop_eviction_thread(tr)
