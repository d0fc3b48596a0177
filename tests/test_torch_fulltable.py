"""cdlrm_tpu_torch's ``FullTableDlrmTrainer`` (``use_cache=False``) against
cdlrm_tpu's, and the port's cached trainer against it.

The same seed draws the same dense weights and tables in both packages
(init_dlrm, then init_embedding_tables, from one generator). Training then
agrees within 1e-5 in float32: cdlrm_tpu applies ``w - lr * g`` to every row
of a dense per-table gradient, the port to the batch's distinct rows only,
with each row's gradient summed in the same lookup order, so only the dense
math's summation order differs. Evaluation agrees to AUC within 1e-6 with
equal accuracy, and a cdlrm_tpu checkpoint serves in the port with scores
within 1e-5."""

import numpy as np
import pytest
import torch

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import Batch, SyntheticDataset
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer as JaxFullTable
from cdlrm_tpu_torch.config import Config, finalize
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

LN_EMB = np.array([300, 400, 500])
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfg(port: bool, pooled=1, ln_emb=LN_EMB, **kw):
    base = dict(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=32, world_size=1, loss_function="bce", print_freq=5,
        round_targets=True, use_cache=False, learning_rate=0.1, lr_embeds=0.3,
        num_indices_per_lookup=pooled, num_indices_per_lookup_fixed=pooled == 1,
    )
    base.update(kw)
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=ln_emb)


def _ds(seed, batches, pooled=1, extra=0):
    return SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=32 * batches + extra,
                            mini_batch_size=32, seed=seed, round_targets=True,
                            num_indices_per_lookup=pooled,
                            num_indices_per_lookup_fixed=pooled == 1)


def _assert_params_close(jax_params, port, **tol):
    for key in ("bot", "top"):
        for (jw, jb), (pw, pb) in zip(jax_params[key], port.params[key]):
            np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **tol)
            np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **tol)
    assert len(jax_params["emb"]) == len(port.emb_tables())
    for jt, pt in zip(jax_params["emb"], port.emb_tables()):
        np.testing.assert_allclose(pt.numpy(), np.asarray(jt), **tol)


@pytest.mark.parametrize("pooled", [1, 3])
def test_fulltable_training_matches_cdlrm_tpu(pooled):
    ds = _ds(3, 12, pooled)
    jtr = JaxFullTable(_cfg(False, pooled), ds, ds)
    ptr = FullTableDlrmTrainer(_cfg(True, pooled), ds, ds, device="cpu")
    # the same draws: bit-equal initial weights and tables
    _assert_params_close(jstep.unreplicate(jtr.params), ptr, atol=0, rtol=0)
    tables0 = ptr.tables.clone()
    j_lines, p_lines = [], []
    jtr.train(max_steps=10, log_fn=j_lines.append)
    ptr.train(max_steps=10, log_fn=p_lines.append)
    assert jtr.global_step == ptr.global_step == 10
    assert [line.split("ms/it")[1] for line in p_lines] == [
        line.split("ms/it")[1] for line in j_lines]  # loss and accuracy, 5 digits
    _assert_params_close(jstep.unreplicate(jtr.params), ptr, **TOL)
    moved = (ptr.tables != tables0).any(dim=1)
    assert 0 < int(moved.sum()) < ptr.tables.shape[0]  # only looked-up rows move


@pytest.mark.parametrize("pooled", [1, 3])
def test_fulltable_evaluate_matches_cdlrm_tpu(pooled):
    """Trained a few steps, then evaluated on a stream with a short last
    batch (padded, its padding dropped)."""
    ds, test_ds = _ds(3, 6, pooled), _ds(9, 3, pooled, extra=7)
    jtr = JaxFullTable(_cfg(False, pooled), ds, test_ds)
    ptr = FullTableDlrmTrainer(_cfg(True, pooled), ds, test_ds, device="cpu")
    jtr.train(log_fn=lambda *_: None)
    ptr.train(log_fn=lambda *_: None)
    j_acc, j_auc = jtr.evaluate(log_fn=lambda *_: None)
    p_acc, p_auc = ptr.evaluate(log_fn=lambda *_: None)
    assert p_acc == j_acc
    assert abs(p_auc - j_auc) <= 1e-6


def test_port_serves_a_cdlrm_tpu_fulltable_checkpoint(tmp_path):
    ds, test_ds = _ds(3, 8), _ds(9, 2)
    jtr = JaxFullTable(_cfg(False), ds, test_ds)
    jtr.train(log_fn=lambda *_: None)
    jtr.save_checkpoint(str(tmp_path / "ck"))
    ptr = FullTableDlrmTrainer(_cfg(True, numpy_rand_seed=11), ds, test_ds, device="cpu")
    ptr.load_checkpoint(str(tmp_path / "ck"))
    assert ptr.global_step == 8
    _assert_params_close(jstep.unreplicate(jtr.params), ptr, atol=0, rtol=0)
    for batch in test_ds.batches():
        x, ls_i, mask, _ = ptr._put(batch)
        got = ptr.eval_step(ptr.params, ptr.tables, ptr._offsets, x, ls_i, mask).numpy()
        want = np.asarray(jtr.eval_step(jtr.params, *jtr._put(batch)[:3]))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _Learnable:
    """Uniform ids; the target is a dense feature's threshold, so the loss
    falls (tests/test_trainer_e2e.py LearnableDataset)."""

    m_den = 13

    def __init__(self, ln_emb, num_batches, batch, seed):
        self.ln_emb, self.num_batches, self.batch, self.seed = ln_emb, num_batches, batch, seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            ls_i = np.stack([rng.integers(0, n, self.batch) for n in self.ln_emb])
            y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
            yield Batch(x, ls_i, None, y)


@pytest.mark.parametrize("kw", [
    {},
    dict(scan_steps=4, pack_wire=False, dedup_lookups="on"),  # coalesced blocks
], ids=["single-steps", "coalesced-blocks"])
def test_cached_equals_fulltable_when_fully_resident(kw):
    """With every table inside the cache on one device, the port's cached
    trainer must train what its full-table trainer trains (the analog of
    tests/test_trainer_e2e.py:403-488): every id is resident from the first
    refill, and the sparse row updates coincide with full-table SGD. With
    coalesced blocks the row update is reassociated (c0 - lr * (g1 + g2)
    against (c0 - lr * g1) - lr * g2), within the same tolerance."""
    ln_emb = np.array([40, 25, 60])
    steps, b = 12, 16
    cfg = finalize(Config(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=b, world_size=1, cache_size=64, num_ways=2, lookahead=3,
        loss_function="bce", print_freq=1000, learning_rate=0.1, lr_embeds=0.3, **kw,
    ), ln_emb=ln_emb)
    assert all(int(n) <= cfg.cache_sets for n in ln_emb)  # fully resident
    ds = _Learnable(ln_emb, steps + 2, b, seed=3)
    tr = CachedDlrmTrainer(cfg, ds, device="cpu")
    oracle = FullTableDlrmTrainer(cfg, ds, device="cpu")
    # the oracle starts from the cached run's masters and dense weights
    oracle.params = {k: [(w.clone(), bb.clone()) for w, bb in v] for k, v in tr.params.items()}
    for dst, src in zip(oracle.emb_tables(), tr.master.tables):
        dst.copy_(torch.from_numpy(src))
    try:
        tr.train(max_steps=steps, log_fn=lambda *_: None)
        if kw:
            assert any(key[2] for key in tr._step_cache), "no coalesced block ran"
        oracle.train(max_steps=steps, log_fn=lambda *_: None)
        for key in ("bot", "top"):
            for (w, bb), (wo, bo) in zip(tr.params[key], oracle.params[key]):
                np.testing.assert_allclose(w.numpy(), wo.numpy(), rtol=2e-4, atol=1e-6)
                np.testing.assert_allclose(bb.numpy(), bo.numpy(), rtol=2e-4, atol=1e-6)
        # the cache rows of every id seen in the stream equal the oracle's
        # trained rows (unseen ids are never inserted)
        cache = tr.cache.numpy()
        for t, table in enumerate(oracle.emb_tables()):
            ids = np.unique(np.concatenate(
                [bt.ls_i[t] for bt, _ in zip(ds.batches(), range(steps))]))
            sets_t = int(tr.geo.sets[t])
            eq = tr.controller.occupancy[t][ids % sets_t] == ids[:, None]
            assert eq.any(axis=1).all(), f"table {t}: seen ids not resident"
            slots = tr.geo.table_offsets[t] + eq.argmax(axis=1) * sets_t + ids % sets_t
            np.testing.assert_allclose(cache[slots], table.numpy()[ids], rtol=2e-4, atol=1e-6)
    finally:
        tr.close()


@pytest.mark.parametrize("kw,name", [
    (dict(coordinator_address="localhost:1234"), "coordinator_address"),
])
def test_fulltable_refuses_unported_fields(kw, name):
    """The full-table trainer stays single-process: a multi-host group
    (``coordinator_address`` and two ranks) is refused in cdlrm_tpu's words
    (fulltable.py:33-36); with one rank it trains on one device."""
    from cdlrm_tpu_torch.parallel.mesh import DpGroup

    ds = _ds(3, 1)
    with pytest.raises(ValueError, match="FullTableDlrmTrainer is single-process; multi-host "
                                         "runs use the cached trainer"):
        FullTableDlrmTrainer(_cfg(True, world_size=2, **kw), ds, ds, device="cpu",
                             group=DpGroup(0, 2))
    tr = FullTableDlrmTrainer(_cfg(True, **kw), ds, ds, device="cpu")
    try:
        tr.train(max_steps=1, log_fn=lambda *_: None)
        assert tr.global_step == 1 and getattr(tr.cfg, name)
    finally:
        tr.close()
