"""cdlrm_tpu_torch's ``CachedDlrmTrainer.train`` with scan blocks
(``scan_steps=4``) on the unpacked wires against cdlrm_tpu's, on one stream
at a small geometry on one device.

Lookahead 6 and print_freq 5 do not divide by the block size, so blocks of
4, 3, 2 and 1 steps all run (each capped at a window or print boundary).
The host layer is shared, so the wire chosen per window, the hit rates, the
global step and the data cursor must be equal; the trajectory (window
losses, final cache, masters after the writeback flush) agrees within 1e-5
in float32 (summation order of the dense math only). The eviction thread is
held and flushed at the end, as in test_torch_train_trainer.py."""

import numpy as np
import pytest

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import Batch
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from test_torch_train_trainer import LN_EMB, _SkewSwitch

TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 24


def _cfg(port: bool, ln_emb=LN_EMB, **kw):
    base = dict(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=64, num_ways=4,
        loss_function="bce", lookahead=6, print_freq=5, round_targets=True,
        eviction_fifo_size=64, scan_steps=4, pack_wire=False,
    )
    base.update(kw)
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=ln_emb)


def _run(trainer_cls, cfg, ds, steps, **kw):
    """Train ``steps`` steps with the eviction thread held; returns the
    print windows' metrics, the wire of each window, the block sizes run,
    the cache, the masters after the writeback flush, and the counters."""
    tr = trainer_cls(cfg, ds, **kw)
    tr.eviction_manager.start = lambda: None
    windows, wires, blocks = [], [], []
    tr._log_metrics = lambda kind, payload: windows.append(dict(payload))
    refill, get_step = tr._apply_refill, tr._get_step

    def recording_refill(*args, **kwargs):
        refill(*args, **kwargs)
        wires.append(tr._dedup)

    def recording_get_step(size, dedup, coalesce=False):
        blocks.append((size, dedup, coalesce))
        return get_step(size, dedup, coalesce)

    tr._apply_refill, tr._get_step = recording_refill, recording_get_step
    try:
        tr.train(max_steps=steps, log_fn=lambda *_: None)
        assert tr.eviction_manager.flush()
        cache = np.array(tr.cache, dtype=np.float32)
        masters = [t.copy() for t in tr.master.tables]
        counters = dict(refills=tr.metrics.refills, written=tr.eviction_manager.rows_written,
                        step=tr.global_step, cursor=tuple(tr._cursor),
                        hits=tr.metrics.hits, lookups=tr.metrics.lookups)
    finally:
        tr.close()
    return windows, wires, blocks, cache, masters, counters


@pytest.mark.parametrize("pooled", [0, 3])
@pytest.mark.parametrize("mode,coalesce", [
    ("off", "auto"), ("on", "auto"), ("on", "off"), ("auto", "auto"), ("auto", "off"),
])
def test_scan_blocks_match_cdlrm_tpu(mode, coalesce, pooled):
    ds = _SkewSwitch(STEPS, pooled)
    kw = dict(dedup_lookups=mode, block_coalesced_update=coalesce)
    j = _run(JaxTrainer, _cfg(False, **kw), ds, STEPS)
    p = _run(CachedDlrmTrainer, _cfg(True, **kw), ds, STEPS, device="cpu")
    (j_win, j_wires, j_blocks, j_cache, j_mast, j_cnt) = j
    (p_win, p_wires, p_blocks, p_cache, p_mast, p_cnt) = p
    assert p_wires == j_wires
    if mode == "auto":  # the stream's switch shows in the wire choice
        assert p_wires[0] and not p_wires[-1], p_wires
    else:
        assert set(p_wires) == {mode == "on"}
    assert p_blocks == j_blocks
    assert {size for size, _, _ in p_blocks} == {1, 2, 3, 4}
    coalesced = any(c for _, _, c in p_blocks)
    assert coalesced == (mode != "off" and coalesce == "auto"), p_blocks
    assert p_cnt == j_cnt
    assert p_cnt["step"] == STEPS and p_cnt["cursor"] == (0, STEPS)
    assert p_cnt["written"] > 0  # evictions were written back
    assert len(p_win) == len(j_win) == STEPS // 5
    for pw, jw in zip(p_win, j_win):
        assert pw["hit_rate"] == jw["hit_rate"]
        assert pw["dedup"] == jw["dedup"] and pw["steps"] == jw["steps"]
        np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)
        np.testing.assert_allclose(pw["accuracy"], jw["accuracy"], **TOL)
    np.testing.assert_allclose(p_cache, j_cache, **TOL)
    for pm, jm in zip(p_mast, j_mast):
        np.testing.assert_allclose(pm, jm, **TOL)


@pytest.mark.parametrize("pooled", [0, 3])
@pytest.mark.parametrize("mode", ["on", "off"])
def test_scan_blocks_equal_single_steps(mode, pooled):
    """A non-coalesced block is a loop of the single steps, over the same
    inputs: scan_steps=4 trains bit for bit as scan_steps=1 does. The
    staging buckets differ (the window's negotiated ones against running
    maxima), but they only change the trash-row padding, which no kernel
    reads past the valid prefix."""
    ds = _SkewSwitch(STEPS, pooled)
    kw = dict(dedup_lookups=mode, block_coalesced_update="off")
    blocked = _run(CachedDlrmTrainer, _cfg(True, **kw), ds, STEPS, device="cpu")
    single = _run(CachedDlrmTrainer, _cfg(True, scan_steps=1, **kw), ds, STEPS, device="cpu")
    assert {size for size, _, _ in single[2]} == {1}
    assert max(size for size, _, _ in blocked[2]) == 4
    assert [w["loss"] for w in blocked[0]] == [w["loss"] for w in single[0]]
    np.testing.assert_array_equal(blocked[3], single[3])
    for a, b in zip(blocked[4], single[4]):
        np.testing.assert_array_equal(a, b)


class _DistinctIdStream:
    """Batch j looks up ids [j*B, (j+1)*B) mod R (tests/test_block_coalesce.py
    :106-163): every id appears at most once in a block."""

    def __init__(self, m_den, ln_emb, n_batches, b):
        self.m_den, self.ln_emb = m_den, np.asarray(ln_emb, np.int64)
        self.num_batches, self.b = n_batches, b

    def __len__(self):
        return self.num_batches

    def batches(self, skip: int = 0):
        for j in range(skip, self.num_batches):
            rng = np.random.default_rng([7, j])
            x = rng.random((self.b, self.m_den), np.float32)
            base = np.arange(j * self.b, (j + 1) * self.b, dtype=np.int64)
            ls_i = np.stack([base % int(r) for r in self.ln_emb])
            y = (rng.random((self.b, 1)) < 0.5).astype(np.float32)
            yield Batch(x, ls_i, None, y)


def test_coalesced_single_touch_rows_bit_exact():
    """Rows touched at most once per block take the same float path with
    the coalesced update (0 + g into pending, then one add of -lr * g) as
    with the per-step one: the real cache rows are bit-identical."""
    ln = np.array([4096])
    kw = dict(cache_size=1024, num_ways=4, lookahead=4, scan_steps=2,
              mini_batch_size=16, print_freq=1 << 20, dedup_lookups="on")

    def run(coalesce):
        ds = _DistinctIdStream(13, ln, n_batches=16, b=16)
        out = _run(CachedDlrmTrainer, _cfg(True, ln_emb=ln, block_coalesced_update=coalesce,
                                           **kw), ds, 8, device="cpu")
        assert any(c for _, _, c in out[2]) == (coalesce == "on")
        return out[3]

    cache_a, cache_b = run("off"), run("on")
    tr = CachedDlrmTrainer(_cfg(True, ln_emb=ln, **kw), _DistinctIdStream(13, ln, 1, 16),
                           device="cpu")
    real = np.zeros(tr.geo.total_rows, bool)
    real[: int(tr.geo.aux_base(0))] = True
    tr.close()
    np.testing.assert_array_equal(cache_b[real], cache_a[real])
