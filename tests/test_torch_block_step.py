"""The unpacked dedup wire and one block-coalesced scan block of
cdlrm_tpu_torch against cdlrm_tpu, on the same inputs.

``_decode_dedup_raw`` must decode exactly. For the block, both packages'
trainers are built from one config and seed, get the same insert plan, and
assemble the same batches in the unpacked dedup wire, part resident and part
missing: the wire bytes and the host block union (sorted union, per-step
block ranks) must be equal, since the host layer is shared. Then each
package's coalesced block runs once from equal caches and parameters, with
the inputs interleaved by ``interleave_block_inputs``. The cache, parameters
and per-step losses agree within 1e-5 in float32 (summation order of the
dense math; both sum the pending buffer in lookup order on the CPU)."""

import itertools

import numpy as np
import pytest
import torch

import jax

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu_torch.ops import native
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.train import step as tstep
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

LN_EMB = np.array([1000, 500, 1200])
TOL = dict(atol=1e-5, rtol=1e-5)
K = 3  # steps in the block


def test_decode_dedup_raw_matches_jax():
    """Ranks -> global ranks into [trash, uniq..., pad]: masked lanes (-1)
    rank to 0, the rest to 1 + rank + the table's start in the list; a table
    with no unique slot and wholly masked lanes included."""
    rng = np.random.default_rng(4)
    t_count, n = 3, 50
    counts = np.array([7, 0, 12], np.int32)
    inv = np.stack([rng.integers(0, max(1, c), n) for c in counts]).astype(np.int32)
    inv[1] = -1
    inv[rng.random((t_count, n)) < 0.2] = -1
    uniq = np.full(64, 9999, np.int32)
    uniq[1: 1 + counts.sum()] = rng.integers(0, 9000, counts.sum())
    want_u, want_inv = jstep._decode_dedup_raw(inv, uniq, counts)
    got_u, got_inv = tstep._decode_dedup_raw(
        torch.from_numpy(inv), torch.from_numpy(uniq), torch.from_numpy(counts)
    )
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv))
    assert got_inv.dtype == torch.int32 and int(got_inv.reshape(t_count, n)[1].max()) == 0


def _cfg(port: bool, **kw):
    cfg = (Config if port else JaxConfig)(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=128, num_ways=4,
        loss_function="bce", round_targets=True, scan_steps=K, pack_wire=False,
        dedup_lookups="on", **kw,
    )
    return cfg.finalize(ln_emb=LN_EMB)


def _ds(pooled):
    kw = {} if not pooled else dict(num_indices_per_lookup=pooled,
                                    num_indices_per_lookup_fixed=False)
    return SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * (2 + K),
                            mini_batch_size=64, seed=5, round_targets=True, **kw)


def _refilled(trainer, batches):
    """Insert the batches' unique ids through the trainer's own refill."""
    uniques = []
    for t in range(len(LN_EMB)):
        parts = [b.ls_i[t] if b.ls_mask is None else b.ls_i[t][b.ls_mask[t]] for b in batches]
        uniques.append(np.unique(np.concatenate([p.reshape(-1) for p in parts])))
    return trainer.controller.plan_insert(uniques, trainer.master.gather_all(uniques))


@pytest.mark.parametrize("pooled", [0, 3])
def test_coalesced_block_matches_jax(pooled):
    ds = _ds(pooled)
    jtr = JaxTrainer(_cfg(False), ds)
    ptr = CachedDlrmTrainer(_cfg(True), ds, device="cpu")
    try:
        assert jtr._block_coalesce and ptr._block_coalesce
        batches = list(itertools.islice(ds.batches(), 2 + K))
        j_plan = _refilled(jtr, batches[:2])
        jtr.cache, _ = jtr.refill_step(jtr.cache, *jtr._refill_device_inputs(j_plan))
        ptr.refill(_refilled(ptr, batches[:2]))
        cache0 = ptr.cache.numpy().copy()
        np.testing.assert_array_equal(cache0, np.asarray(jtr.cache))

        j_items = [jtr._assemble(b, 64) for b in batches[2:]]
        p_items = [ptr._assemble(b, 64) for b in batches[2:]]
        for (j_in, j_st, j_dd, j_bi), (p_in, p_st, p_dd, p_bi) in zip(j_items, p_items):
            assert j_dd and p_dd
            assert 0 < p_st.hits == j_st.hits < p_st.lookups == j_st.lookups
            for a, b in zip(j_in, p_in):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            np.testing.assert_array_equal(p_bi[0], j_bi[0][0])
            assert p_bi[2] == j_bi[2]

        j_ranks, j_slots, j_counts = jtr._build_block_union([it[3] for it in j_items])
        p_ranks, p_slots, p_counts = ptr._build_block_union([it[3] for it in p_items])
        for a, b in zip(j_ranks, p_ranks):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(p_slots.numpy(), np.asarray(j_slots))
        np.testing.assert_array_equal(p_counts.numpy(), np.asarray(j_counts))

        j_flat = JaxTrainer.interleave_block_inputs([it[0] for it in j_items], j_ranks)
        p_flat = CachedDlrmTrainer.interleave_block_inputs([it[0] for it in p_items], p_ranks)
        j_params, j_cache, _, j_loss, j_corr = jtr._get_step(K, True, True)(
            jtr.params, jtr.cache, jtr.touched, *j_flat, j_slots, j_counts,
            jtr._lr, jtr._lr_emb,
        )
        p_params, p_cache, p_loss, p_corr = ptr._get_step(K, True, True)(
            ptr.params, ptr.cache, *p_flat, p_slots, p_counts, ptr._lr, ptr._lr_emb,
        )
        assert p_loss.shape == p_corr.shape == (K,)
        np.testing.assert_allclose(p_loss.numpy(), np.asarray(j_loss), **TOL)
        np.testing.assert_array_equal(p_corr.numpy(), np.asarray(j_corr))
        np.testing.assert_allclose(p_cache.numpy(), np.asarray(j_cache), **TOL)
        real = np.zeros(cache0.shape[0], bool)
        real[np.asarray(p_slots)[: int(p_counts[0])]] = True
        assert np.abs(p_cache.numpy()[real] - cache0[real]).max() > 1e-4  # rows did move
        j_leaves = jax.tree_util.tree_leaves(jstep.unreplicate(j_params))
        p_leaves = [a for key in ("bot", "top") for pair in p_params[key] for a in pair]
        assert len(j_leaves) == len(p_leaves)
        for jw, pw in zip(j_leaves, p_leaves):
            np.testing.assert_allclose(pw.numpy(), jw, **TOL)
    finally:
        jtr.close()
        ptr.close()


def test_block_union_numpy_form_matches_native(monkeypatch):
    """Without the native host library the block union takes its numpy
    form, with the same output."""
    if not native.available():
        pytest.skip("the native host library is not built here")
    ds = _ds(0)
    batches = list(itertools.islice(ds.batches(), 2 + K))
    outs = []
    for use_native in (True, False):
        tr = CachedDlrmTrainer(_cfg(True), ds, device="cpu")
        try:
            tr.refill(_refilled(tr, batches[:2]))
            infos = [tr._assemble(b, 64)[3] for b in batches[2:]]
            if not use_native:
                monkeypatch.setattr(native, "available", lambda: False)
            outs.append(tr._build_block_union(infos))
            monkeypatch.undo()
            assert (tr._blk_rank_map == -1).all()  # reset after the block
        finally:
            tr.close()
    (n_ranks, n_slots, n_counts), (p_ranks, p_slots, p_counts) = outs
    assert 0 < int(n_counts[0]) < n_slots.shape[0]
    for a, b in zip(n_ranks, p_ranks):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(n_slots.numpy(), p_slots.numpy())
    np.testing.assert_array_equal(n_counts.numpy(), p_counts.numpy())


def test_block_coalesce_needs_a_block_and_the_unpacked_dedup_wire():
    from cdlrm_tpu_torch.cache.geometry import CacheGeometry

    geo = CacheGeometry.build([100], 8, 16, 4, 8)
    cfg = tstep.StepConfig(dedup=True, block_coalesce=True)
    with pytest.raises(ValueError, match="scan block"):
        tstep.make_cached_train_step(geo, cfg, block=1)
    with pytest.raises(ValueError, match="UNPACKED"):
        tstep.make_cached_train_step(geo, cfg._replace(wire_pack=True), block=2)
    with pytest.raises(ValueError, match="UNPACKED"):
        tstep.make_cached_train_step(geo, cfg._replace(dedup=False), block=2)
