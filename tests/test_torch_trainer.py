"""The serving slice end to end: cdlrm_tpu trains and saves a checkpoint,
then cdlrm_tpu and cdlrm_tpu_torch each load it and serve the same test
stream (``--inference-only``), at the verify-skill config on one device.

The host layer is shared, so the eval hit rate must be equal. Per-batch
scores agree within 1e-5 in float32 (summation order only) and AUC within
1e-6; accuracy is equal except for examples whose score lies within 1e-5 of
0.5, which may round the other way."""

import numpy as np
import pytest

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

LN_EMB = np.array([1000, 500, 2000])


def _cfg(port: bool, **kw):
    base = dict(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=128, num_ways=4,
        loss_function="bce", lookahead=4, print_freq=10, round_targets=True,
    )
    base.update(kw)
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=LN_EMB)


def _ds(seed, batches, pooled=0, extra=0):
    """``batches`` full batches of 64, then one of ``extra`` examples."""
    kw = {} if not pooled else dict(num_indices_per_lookup=pooled,
                                    num_indices_per_lookup_fixed=False)
    return SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * batches + extra,
                            mini_batch_size=64, seed=seed, round_targets=True, **kw)


def _serve(tr, ckpt=None):
    """Evaluate, capturing each batch's scores as the eval step returns them."""
    scores = []
    step = tr.eval_step

    def capturing(*args):
        cache, s = step(*args)
        scores.append(np.array(s, dtype=np.float32))
        return cache, s

    tr.eval_step = capturing
    if ckpt is not None:
        tr.load_checkpoint(ckpt)
    try:
        acc, auc = tr.evaluate(log_fn=lambda *_: None)
    finally:
        tr.close()
    return acc, auc, tr.metrics.eval_hit_rate, np.concatenate(scores)


def _assert_same_serving(jax_out, port_out, y):
    (j_acc, j_auc, j_hit, j_scores), (p_acc, p_auc, p_hit, p_scores) = jax_out, port_out
    assert p_hit == j_hit
    assert p_scores.shape == j_scores.shape
    np.testing.assert_allclose(p_scores, j_scores, atol=1e-5, rtol=0)
    assert abs(p_auc - j_auc) <= 1e-6
    near_half = int(np.sum(np.abs(j_scores - 0.5) < 1e-5))
    assert abs(p_acc - j_acc) * y.size <= near_half
    return near_half


def test_port_serves_a_cdlrm_tpu_checkpoint(tmp_path):
    train_ds, test_ds = _ds(5, 20), _ds(9, 8)
    tr = JaxTrainer(_cfg(False), train_ds, test_ds)
    try:
        tr.train(max_steps=20)
        tr.save_checkpoint(str(tmp_path / "ck"))
    finally:
        tr.close()
    ck = str(tmp_path / "ck")
    jax_out = _serve(JaxTrainer(_cfg(False, inference_only=True), train_ds, test_ds), ck)
    port_out = _serve(CachedDlrmTrainer(
        _cfg(True, inference_only=True), train_ds, test_ds, device="cpu"), ck)
    y = np.concatenate([b.y for b in test_ds.batches()])
    _assert_same_serving(jax_out, port_out, y)
    assert jax_out[2] > 0  # the trained cache serves hits


@pytest.mark.parametrize("pooled", [0, 3])
def test_port_matches_cold_cache_serving(pooled):
    """No checkpoint: the same seed must give both packages the same masters
    and weights (drawn in the same order), so a cold cache serves alike; the
    short last batch is padded alike."""
    train_ds, test_ds = _ds(5, 2, pooled), _ds(9, 3, pooled, extra=10)
    jax_out = _serve(JaxTrainer(_cfg(False, inference_only=True), train_ds, test_ds))
    port_out = _serve(CachedDlrmTrainer(
        _cfg(True, inference_only=True), train_ds, test_ds, device="cpu"))
    y = np.concatenate([b.y for b in test_ds.batches()])
    _assert_same_serving(jax_out, port_out, y)
    assert jax_out[2] == 0.0  # nothing resident: every lookup misses


def test_port_refill_then_serve_hits():
    """One insert plan through the port's refill step makes the planned ids
    resident: serving the batches they came from then hits."""
    train_ds, test_ds = _ds(5, 2), _ds(9, 2)
    tr = CachedDlrmTrainer(_cfg(True, inference_only=True), train_ds, test_ds, device="cpu")
    first = next(iter(test_ds.batches()))
    uniques = [np.unique(first.ls_i[t]) for t in range(len(LN_EMB))]
    plan = tr.controller.plan_insert(uniques, tr.master.gather_all(uniques))
    evicted = tr.refill(plan)
    assert evicted.shape == (0, 16)
    got = tr.cache.numpy()[plan.insert_slots]
    np.testing.assert_array_equal(got, plan.insert_rows)
    tr.evaluate(max_batches=1, log_fn=lambda *_: None)
    assert tr.metrics.eval_hit_rate > 0.5
    tr.close()


def test_unported_flags_are_refused():
    """The port implements every field of cdlrm_tpu's trainer: what it
    refuses is what cdlrm_tpu refuses. The hot tier and the sorted wire
    (tests/test_torch_hot_tier.py, test_torch_sorted_wire.py) build here
    beside the other variants."""
    ds = _ds(5, 1)
    # multi-host mode is ported (tests/test_torch_mh_trainer.py): with a
    # coordinator and one rank the trainer builds for one device
    tr = CachedDlrmTrainer(_cfg(True, coordinator_address="localhost:1234"), ds, ds,
                           device="cpu")
    assert not tr.multihost
    tr.close()
    # QR tables with the cache raise cdlrm_tpu's own error (trainer.py:285-294)
    with pytest.raises(ValueError, match="qr_flag with the cached path"):
        CachedDlrmTrainer(_cfg(True, qr_flag=True), ds, ds, device="cpu")
    # the wire and model variants, the hot tier and the sorted wire are
    # ported: these build
    for kw in (dict(md_flag=True), dict(wire_x_fp8=True), dict(wire_rows_bf16=True),
               dict(enable_profiling=True), dict(hot_tier_rows=64),
               dict(sorted_dedup_wire=True, pack_wire=False, dedup_lookups="on")):
        CachedDlrmTrainer(_cfg(True, **kw), ds, ds, device="cpu").close()
    # training is ported: at the defaults the trainer builds and trains
    tr = CachedDlrmTrainer(_cfg(True), ds, ds, device="cpu")
    try:
        tr.train(max_steps=1, log_fn=lambda *_: None)
        assert tr.global_step == 1
    finally:
        tr.close()


def test_plain_unpacked_wire_trains_and_serves():
    """pack_wire=False with the dedup wire off is the plain unpacked slot
    wire, which the port implements."""
    train_ds, test_ds = _ds(5, 4), _ds(9, 2)
    tr = CachedDlrmTrainer(_cfg(True, pack_wire=False, dedup_lookups="off"),
                           train_ds, test_ds, device="cpu")
    try:
        assert not tr._wire_pack
        tr.train(max_steps=4, log_fn=lambda *_: None)
        acc, _ = tr.evaluate(log_fn=lambda *_: None)
        assert tr.global_step == 4 and 0.0 <= acc <= 1.0
    finally:
        tr.close()
