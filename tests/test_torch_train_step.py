"""cdlrm_tpu_torch's cached train step against cdlrm_tpu's
``make_cached_train_step``, one step on the same wire bytes.

Both packages' trainers are built from one config and seed, get the same
insert plan, and assemble the same batch, part resident and part missing:
the wire bytes must be equal (the host layer is shared). Then each package's
train step runs once from equal caches and parameters. Parameters, the
whole cache, loss_sum and correct agree within 1e-5 in float32: the two
frameworks sum the dense math in different orders, and nothing else
differs (duplicate slots are summed in index order by both on the CPU)."""

import itertools

import numpy as np
import pytest
import torch

import jax

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.train import step as tstep
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

LN_EMB = np.array([1000, 500, 2000])
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfg(port: bool, **kw):
    cfg = (Config if port else JaxConfig)(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=128, num_ways=4,
        loss_function="bce", round_targets=True, **kw,
    )
    return cfg.finalize(ln_emb=LN_EMB)


def _window_uniques(batches):
    """Per-table sorted unique ids of the batches' valid lookups."""
    out = []
    for t in range(len(LN_EMB)):
        parts = [b.ls_i[t] if b.ls_mask is None else b.ls_i[t][b.ls_mask[t]] for b in batches]
        out.append(np.unique(np.concatenate([p.reshape(-1) for p in parts])))
    return out


@pytest.mark.parametrize("pooled", [0, 3])
@pytest.mark.parametrize("dedup", [False, True])
def test_train_step_matches_jax(pooled, dedup):
    kw = {} if not pooled else dict(num_indices_per_lookup=pooled,
                                    num_indices_per_lookup_fixed=False)
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 4, mini_batch_size=64,
                          seed=5, round_targets=True, **kw)
    mode = "on" if dedup else "off"
    jtr = JaxTrainer(_cfg(False, dedup_lookups=mode), ds)
    ptr = CachedDlrmTrainer(_cfg(True, dedup_lookups=mode), ds, device="cpu")
    try:
        batches = list(itertools.islice(ds.batches(), 4))
        uniques = _window_uniques(batches[:2])
        j_plan = jtr.controller.plan_insert(uniques, jtr.master.gather_all(uniques))
        jtr.cache, _ = jtr.refill_step(jtr.cache, *jtr._refill_device_inputs(j_plan))
        ptr.refill(ptr.controller.plan_insert(uniques, ptr.master.gather_all(uniques)))
        cache0 = ptr.cache.numpy().copy()
        np.testing.assert_array_equal(cache0, np.asarray(jtr.cache))

        # batch 3 was not in the window: part hits, part aux misses
        j_in, j_stats, j_dedup, _ = jtr._assemble(batches[3], 64)
        p_in, p_stats, p_dedup, _ = ptr._assemble(batches[3], 64)
        assert j_dedup == p_dedup == dedup
        assert 0 < p_stats.hits == j_stats.hits < p_stats.lookups == j_stats.lookups
        assert len(p_in) == len(j_in)
        for a, b in zip(j_in, p_in):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))

        j_params, j_cache, _, j_loss, j_corr = jtr._get_step(1, dedup)(
            jtr.params, jtr.cache, jtr.touched, *j_in, jtr._lr, jtr._lr_emb,
        )
        p_params, p_cache, p_loss, p_corr = ptr._get_step(1, dedup)(
            ptr.params, ptr.cache, *p_in, ptr._lr, ptr._lr_emb,
        )
        np.testing.assert_allclose(p_loss.item(), float(j_loss), **TOL)
        assert p_corr.item() == float(j_corr)
        np.testing.assert_allclose(p_cache.numpy(), np.asarray(j_cache), **TOL)
        assert np.abs(p_cache.numpy() - cache0).max() > 1e-4  # rows did move
        j_flat = jax.tree_util.tree_leaves(jstep.unreplicate(j_params))
        p_flat = [a for key in ("bot", "top") for pair in p_params[key] for a in pair]
        assert len(j_flat) == len(p_flat)
        for jw, pw in zip(j_flat, p_flat):
            np.testing.assert_allclose(pw.numpy(), jw, **TOL)
    finally:
        jtr.close()
        ptr.close()


@pytest.mark.parametrize("bits,inv_bits", [(13, 9), (24, 13)])
def test_decode_dedup_matches_jax(bits, inv_bits):
    """The packed dedup wire decodes exactly: unique slots (trash rank at 0,
    sentinel padding -> trash) and the global ranks of every lookup."""
    from cdlrm_tpu.cache.geometry import CacheGeometry

    rng = np.random.default_rng(bits)
    geo = CacheGeometry.build([300, 1200, 2000], 16, 64, 4, 64)
    t_count, n = 3, 200
    counts = np.array([17, 0, 40])
    ranks = np.stack([rng.integers(0, max(1, c), n) for c in counts]).astype(np.int64)
    ranks[1] = -1  # a table whose every lookup is masked
    ranks[rng.random((t_count, n)) < 0.1] = -1
    inv_wire = tstep.pack_slots(ranks, np.zeros(t_count, np.int64), -1, inv_bits)
    ub = 128
    vals = np.full(ub, -1, np.int64)
    vals[1: 1 + counts.sum()] = rng.integers(0, 1 << (bits - 1), counts.sum())
    uniq_wire = tstep.pack_slots(vals[None], np.zeros(1, np.int64), -1, bits)[0]
    want_u, want_inv = jstep._decode_dedup(
        inv_wire, uniq_wire, counts.astype(np.int32), geo, inv_bits, bits, n
    )
    got_u, got_inv = tstep._decode_dedup(
        torch.from_numpy(inv_wire), torch.from_numpy(uniq_wire),
        torch.from_numpy(counts.astype(np.int32)),
        torch.as_tensor(geo.table_offsets, dtype=torch.int32), geo.trash_row,
        inv_bits, bits, n,
    )
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_inv.numpy(), np.asarray(want_inv))
    assert got_u[0] == geo.trash_row and got_u.dtype == got_inv.dtype == torch.int32


def test_train_step_refuses_adagrad():
    """AdaGrad needs the dedup wire and refuses the block-coalesced update,
    as cdlrm_tpu's step does (step.py:562-582)."""
    from cdlrm_tpu_torch.cache.geometry import CacheGeometry

    geo = CacheGeometry.build([100], 8, 16, 4, 8)
    with pytest.raises(ValueError, match="requires the dedup wire"):
        tstep.make_cached_train_step(geo, tstep.StepConfig(optimizer="adagrad"))
    with pytest.raises(ValueError, match="block_coalesce requires optimizer='sgd'"):
        tstep.make_cached_train_step(
            geo, tstep.StepConfig(optimizer="adagrad", dedup=True, block_coalesce=True),
            block=2,
        )
    with pytest.raises(ValueError, match="sgd|adagrad"):
        tstep.make_cached_train_step(geo, tstep.StepConfig(optimizer="rmsprop", dedup=True))
