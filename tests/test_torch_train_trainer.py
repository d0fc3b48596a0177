"""cdlrm_tpu_torch's ``CachedDlrmTrainer.train`` against cdlrm_tpu's on the
same stream, at a small geometry on one device.

Both packages share the host layer (prefetcher, shadow planner, probes,
eviction writeback), so the window plans, hit rates and wire choices must be
equal, and the trajectories agree within 1e-5 in float32 (summation order of
the dense math only). Writebacks race the prefetcher's master gathers in
both packages (the reference's eventually consistent cache manager), so the
parity runs hold the eviction thread and flush its queue at the end: the
masters then hold every evicted row, in order, in both."""

import itertools
import sys

import numpy as np
import pytest

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import Batch, SyntheticDataset
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

TOL = dict(atol=1e-5, rtol=1e-5)
LN_EMB = np.array([300, 400, 500])


class _SkewSwitch:
    """Duplicate-heavy batches (ids in [0, 4)) for the first half of the
    stream, near-unique ones (a permutation slice per table) after, so
    ``dedup_lookups='auto'`` takes the dedup wire for the first windows and
    the plain wire for the last (the analog of test_trainer_e2e.py's
    SkewSwitchDataset). ``pooled`` > 0 gives multi-hot bags of that width
    with random masks."""

    m_den = 13

    def __init__(self, num_batches, pooled=0, batch=64, seed=0):
        self.ln_emb, self.num_batches, self.pooled = LN_EMB, num_batches, pooled
        self.batch, self.seed = batch, seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        p = max(1, self.pooled)
        for j in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            y = (x[:, :1] > 0.5).astype(np.float32)
            if j < self.num_batches // 2:
                ls = np.stack([rng.integers(0, 4, self.batch * p) for _ in LN_EMB])
            else:
                ls = np.stack([rng.permutation(n)[: self.batch * p] for n in LN_EMB])
            if not self.pooled:
                yield Batch(x, ls, None, y)
                continue
            mask = rng.random((len(LN_EMB), self.batch, p)) < 0.7
            mask[:, :, 0] = True
            yield Batch(x, ls.reshape(len(LN_EMB), self.batch, p), mask, y)


def _cfg(port: bool, **kw):
    base = dict(
        arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1",
        mini_batch_size=64, world_size=1, cache_size=64, num_ways=4,
        loss_function="bce", lookahead=4, print_freq=4, round_targets=True,
        eviction_fifo_size=64,
    )
    base.update(kw)
    cfg = (Config if port else JaxConfig)(**base)
    return cfg.finalize(ln_emb=LN_EMB)


def _train(trainer_cls, cfg, ds, steps, hold_writeback=True, **kw):
    """Train ``steps`` steps; returns the print windows' metrics, the wire
    chosen at each refill, the cache, the masters after the writeback
    flush, and the trainer's counters."""
    tr = trainer_cls(cfg, ds, **kw)
    if hold_writeback:
        tr.eviction_manager.start = lambda: None
    windows, wires = [], []
    tr._log_metrics = lambda kind, payload: windows.append(dict(payload))
    refill = tr._apply_refill

    def recording_refill(*args, **kwargs):
        refill(*args, **kwargs)
        wires.append(tr._dedup)

    tr._apply_refill = recording_refill
    try:
        tr.train(max_steps=steps, log_fn=lambda *_: None)
        assert tr.eviction_manager.flush()
        cache = np.array(tr.cache, dtype=np.float32)
        masters = [t.copy() for t in tr.master.tables]
        counters = dict(refills=tr.metrics.refills, written=tr.eviction_manager.rows_written,
                        occupancy=tr.controller.state_dict())
    finally:
        tr.close()
    return windows, wires, cache, masters, counters


@pytest.mark.parametrize("pooled", [0, 3])
@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_train_matches_cdlrm_tpu(mode, pooled):
    steps = 24
    ds = _SkewSwitch(steps, pooled)
    j = _train(JaxTrainer, _cfg(False, dedup_lookups=mode), ds, steps)
    p = _train(CachedDlrmTrainer, _cfg(True, dedup_lookups=mode), ds, steps, device="cpu")
    (j_win, j_wires, j_cache, j_mast, j_cnt), (p_win, p_wires, p_cache, p_mast, p_cnt) = j, p
    assert p_wires == j_wires
    if mode == "auto":  # the stream's switch shows in the wire choice
        assert p_wires[0] and not p_wires[-1], p_wires
    else:
        assert set(p_wires) == {mode == "on"}
    assert len(p_win) == len(j_win) == steps // 4
    for pw, jw in zip(p_win, j_win):
        assert pw["hit_rate"] == jw["hit_rate"]
        assert pw["dedup"] == jw["dedup"] and pw["steps"] == jw["steps"]
        np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)
        np.testing.assert_allclose(pw["accuracy"], jw["accuracy"], **TOL)
    assert p_cnt["refills"] == j_cnt["refills"] == steps // 4
    assert p_cnt["written"] == j_cnt["written"] > 0  # evictions were written back
    np.testing.assert_allclose(p_cache, j_cache, **TOL)
    for pm, jm in zip(p_mast, j_mast):
        np.testing.assert_allclose(pm, jm, **TOL)


def test_refill_prestage_matches_unstaged():
    """refill_prestage (the default) stages each window's refill operands on
    the _WindowStager thread. Plan metadata is shadow-planned, so occupancy
    and counters are equal with it on or off; with live writebacks the
    inserted values may read either side of one, so the losses agree to
    tolerance; with no evictions the runs are bit-identical (the analog of
    test_trainer_e2e.py::test_refill_prestage_matches_unstaged)."""
    def run(prestage, **kw):
        ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 40, mini_batch_size=64,
                              seed=3, round_targets=True)
        return _train(CachedDlrmTrainer, _cfg(True, refill_prestage=prestage, **kw), ds, 32,
                      hold_writeback=False, device="cpu")

    on, off = run(True), run(False)
    assert on[4]["refills"] == off[4]["refills"] == 8
    assert on[4]["written"] == off[4]["written"] > 0
    for k in off[4]["occupancy"]:
        np.testing.assert_array_equal(on[4]["occupancy"][k], off[4]["occupancy"][k], err_msg=k)
    for a, b in zip(on[0], off[0]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)

    # no evictions: bit-identical, also with the threads switched often
    big = dict(cache_size=1024, num_ways=8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        on, off = run(True, **big), run(False, **big)
    finally:
        sys.setswitchinterval(interval)
    assert on[4]["written"] == off[4]["written"] == 0
    assert [w["loss"] for w in on[0]] == [w["loss"] for w in off[0]]
    np.testing.assert_array_equal(on[2], off[2])


def test_resume_from_cdlrm_tpu_checkpoint(tmp_path):
    """cdlrm_tpu trains 10 steps (mid-window at lookahead 4) and saves; both
    packages load the checkpoint and train on to step 20 from the saved data
    cursor (the resumed window is replayed without its insert plan), and
    agree."""
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 24, mini_batch_size=64,
                          seed=8, round_targets=True)
    tr = JaxTrainer(_cfg(False), ds)
    try:
        tr.train(max_steps=10, log_fn=lambda *_: None)
        tr.save_checkpoint(str(tmp_path / "ck"))
    finally:
        tr.close()
    outs = []
    for cls, port, kw in ((JaxTrainer, False, {}), (CachedDlrmTrainer, True, {"device": "cpu"})):
        tr = cls(_cfg(port), ds, **kw)
        tr.eviction_manager.start = lambda: None
        tr.load_checkpoint(str(tmp_path / "ck"))
        assert tr._cursor == (0, 10)
        wins = []
        tr._log_metrics = lambda kind, payload, w=wins: w.append(dict(payload))
        try:
            tr.train(max_steps=20, log_fn=lambda *_: None)
            assert tr.global_step == 20
            outs.append((wins, np.array(tr.cache, dtype=np.float32), tr.metrics.refills))
        finally:
            tr.close()
    (j_win, j_cache, j_ref), (p_win, p_cache, p_ref) = outs
    assert p_ref == j_ref == 2  # windows 3 and 4; window 2 was replayed
    assert [w["hit_rate"] for w in p_win] == [w["hit_rate"] for w in j_win]
    for pw, jw in zip(p_win, j_win):
        np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)
    np.testing.assert_allclose(p_cache, j_cache, **TOL)


def test_train_then_evaluate_and_test_cadence():
    """test_freq runs the pipelined eval inside train(); train() called again
    resumes the same stream, and stops at its end."""
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 12, mini_batch_size=64,
                          seed=4, round_targets=True)
    test_ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 2, mini_batch_size=64,
                               seed=9, round_targets=True)
    tr = CachedDlrmTrainer(_cfg(True, test_freq=4), ds, test_ds, device="cpu")
    lines = []
    try:
        tr.train(max_steps=8, log_fn=lines.append)
        assert tr.global_step == 8
        tr.train(log_fn=lines.append)
        assert tr.global_step == 12 and tr._stream_done
        assert tr.train(log_fn=lines.append) is tr.metrics
    finally:
        tr.close()
    assert sum(line.startswith("Test accuracy") for line in lines) == 3
    assert sum(line.startswith("Step ") for line in lines) == 3
    assert tr.metrics.eval_lookups > 0 and tr.metrics.refills == 3
    assert all(np.isfinite(np.asarray(v)).all() for pair in tr.params["top"] for v in pair)


def test_metrics_match_after_train():
    """The cumulative train hit counters and per-table rates equal
    cdlrm_tpu's after the same run."""
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 8, mini_batch_size=64,
                          seed=6, round_targets=True)
    got = []
    for cls, port, kw in ((JaxTrainer, False, {}), (CachedDlrmTrainer, True, {"device": "cpu"})):
        tr = cls(_cfg(port), ds, **kw)
        try:
            m = tr.train(max_steps=8, log_fn=lambda *_: None)
            got.append((m.hits, m.lookups, m.table_lookups, list(m.table_hits)))
        finally:
            tr.close()
    assert got[0] == got[1] and got[0][0] > 0


def test_trainer_iterates_each_batch_once():
    """The pipeline drops the final partial batch and stops at the stream's
    end, as cdlrm_tpu's does."""
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 6 + 10,
                          mini_batch_size=64, seed=2, round_targets=True)
    assert len(list(itertools.islice(ds.batches(), 10))) == 7
    tr = CachedDlrmTrainer(_cfg(True), ds, device="cpu")
    try:
        tr.train(log_fn=lambda *_: None)
        assert tr.global_step == 6 and tr._stream_done
    finally:
        tr.close()
