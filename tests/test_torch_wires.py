"""The byte-lean wires of cdlrm_tpu_torch against cdlrm_tpu's, the records of
``--metrics-log``, and ``utils/profiling.py``.

- ``wire_x_fp8`` ships the dense features as float8_e4m3fn and
  ``wire_rows_bf16`` the refill, miss and evicted rows as bfloat16. The host
  rounds with torch where cdlrm_tpu rounds with ``ml_dtypes``: the two must
  round alike, bit for bit, on a seeded array that also holds every tie
  between adjacent float8 values, subnormals, values under half of the
  smallest subnormal and negative zero. Above 464 they differ by design
  (see :func:`test_fp8_overflow_is_a_designed_difference`).
- Training with either flag or both, on the plain and the dedup wire, SGD
  and AdaGrad with the master state, follows cdlrm_tpu's trajectory within
  1e-5 in float32 (per-window loss, final cache, masters after the flush):
  the roundings are equal, so only the dense math's summation order differs.
- The ``train_window`` and ``eval`` records of both packages carry the same
  keys, and ``evaluate`` prints the per-table hit-rate line.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.train import step as tstep
from cdlrm_tpu_torch.train import trainer as trainer_mod
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from cdlrm_tpu_torch.utils import profiling
from test_adagrad_master_state import WINDOW as CYC_WINDOW, _CycleStream
from test_torch_adagrad import _assert_runs_close, _cycle_cfg, _run
from test_torch_train_trainer import LN_EMB, _SkewSwitch, _cfg, _train

TOL = dict(atol=1e-5, rtol=1e-5)
FP8_AGREE_MAX = 464.0  # up to here torch and ml_dtypes round alike


def _rounding_array() -> np.ndarray:
    """Seeded values over six decades, every midpoint between adjacent
    finite float8_e4m3fn values (exact ties), values around the smallest
    normal (2^-6) and subnormal (2^-9), under half of the smallest subnormal
    (2^-10), and both zeros."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=4000).astype(np.float32)
    x *= rng.choice([1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0], 4000).astype(np.float32)
    f8 = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    fin = np.sort(f8[np.isfinite(f8)]).astype(np.float64)
    ties = ((fin[:-1] + fin[1:]) / 2).astype(np.float32)
    small = np.array([2.0 ** -6, 2.0 ** -7, 2.0 ** -8, 2.0 ** -9, 1.5 * 2.0 ** -9, 2.0 ** -10,
                      1.0001 * 2.0 ** -10, 0.999 * 2.0 ** -10, 2.0 ** -11, 2.0 ** -12,
                      -(2.0 ** -10), -(2.0 ** -11), 0.0, -0.0, 448.0, 449.0, 464.0, -464.0],
                     np.float32)
    out = np.concatenate([x, ties, small])
    return out[np.abs(out) <= FP8_AGREE_MAX]


def test_fp8_rounding_equals_ml_dtypes_exactly():
    x = _rounding_array()
    assert x.size > 4200 and (x == 0).sum() >= 2 and (np.abs(x) < 2.0 ** -10).any()
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)  # bit for bit, negative zero included
    # and the widening back is exact in both
    back = torch.from_numpy(got).view(torch.float8_e4m3fn).to(torch.float32).numpy()
    np.testing.assert_array_equal(
        back, want.view(ml_dtypes.float8_e4m3fn).astype(np.float32))


def test_fp8_overflow_is_a_designed_difference():
    """float8_e4m3fn has no infinity. ``ml_dtypes`` (cdlrm_tpu's host cast)
    turns every value that rounds past 448, 464 excluded, into NaN; torch's
    cast on the CPU saturates it to 448. Inside [-464, 464] the two agree
    exactly (the test above); the dense features of DLRM are log-scaled
    counts, far inside it."""
    big = np.array([465.0, 1e3, -465.0, -1e4, np.inf, -np.inf], np.float32)
    assert np.isnan(big.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)).all()
    got = torch.from_numpy(big).to(torch.float8_e4m3fn).to(torch.float32).numpy()
    np.testing.assert_array_equal(got, np.sign(big) * 448.0)
    nan = torch.tensor([float("nan")]).to(torch.float8_e4m3fn).to(torch.float32)
    assert bool(torch.isnan(nan).all())


def test_bf16_rounding_equals_ml_dtypes_exactly():
    x = np.concatenate([_rounding_array(), np.array([3e38, -3e38, 1e-40, np.inf], np.float32)])
    # ties between adjacent bfloat16 values: the upper half of the mantissa
    # kept, then exactly half an ulp added
    rng = np.random.default_rng(1)
    keep = rng.normal(size=2000).astype(np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    x = np.concatenate([x, (keep | np.uint32(0x8000)).view(np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


WIRES = {"fp8": dict(wire_x_fp8=True), "bf16": dict(wire_rows_bf16=True),
         "both": dict(wire_x_fp8=True, wire_rows_bf16=True)}


@pytest.mark.parametrize("mode", ["off", "on"])
@pytest.mark.parametrize("wire", sorted(WIRES))
def test_wire_variants_train_like_cdlrm_tpu(wire, mode):
    """SGD on the plain ('off') and the packed dedup ('on') wire with the
    byte-lean wires: windows, cache and masters within 1e-5 of cdlrm_tpu
    (the eviction thread held, the queue flushed at the end)."""
    steps = 16
    ds = _SkewSwitch(steps)
    kw = dict(dedup_lookups=mode, **WIRES[wire])
    j = _train(JaxTrainer, _cfg(False, **kw), ds, steps)
    p = _train(CachedDlrmTrainer, _cfg(True, **kw), ds, steps, device="cpu")
    (j_win, j_wires, j_cache, j_mast, j_cnt), (p_win, p_wires, p_cache, p_mast, p_cnt) = j, p
    assert p_wires == j_wires and set(p_wires) == {mode == "on"}
    assert len(p_win) == len(j_win) == steps // 4
    for pw, jw in zip(p_win, j_win):
        assert pw["hit_rate"] == jw["hit_rate"]
        np.testing.assert_allclose(pw["loss"], jw["loss"], **TOL)
    assert p_cnt["written"] == j_cnt["written"] > 0
    np.testing.assert_allclose(p_cache, j_cache, **TOL)
    for pm, jm in zip(p_mast, j_mast):
        np.testing.assert_allclose(pm, jm, **TOL)
    if "rows_bf16" in "".join(WIRES[wire]):
        # evicted rows crossed the wire as bfloat16: every written master row
        # is a bfloat16 value
        ref = _train(CachedDlrmTrainer, _cfg(True, dedup_lookups=mode), ds, steps, device="cpu")
        moved = [pm != rm for pm, rm in zip(p_mast, ref[3])]
        assert any(m.any() for m in moved)
        for pm, m in zip(p_mast, moved):
            rows = pm[m.any(axis=1)]
            np.testing.assert_array_equal(
                rows, rows.astype(ml_dtypes.bfloat16).astype(np.float32))


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_wire_variants_adagrad_master_state_like_cdlrm_tpu(wire):
    """AdaGrad with ``adagrad_master_state`` under whole-window evictions,
    writebacks inline at each boundary: rows cross as bfloat16, the evicted
    accumulators stay float32; store, masters and trajectory within 1e-5."""
    steps = 18
    runs = []
    for port in (False, True):
        cfg = _cycle_cfg(port, True, **WIRES[wire])
        ds = _CycleStream(steps + CYC_WINDOW)
        tr = CachedDlrmTrainer(cfg, ds, device="cpu") if port else JaxTrainer(cfg, ds)
        runs.append(_run(tr, steps, sync_writeback=True))
    j, p = runs
    _assert_runs_close(p, j)
    assert sum(int(np.count_nonzero(a)) for a in p["store"]) > 0


def test_refill_returns_float32_rows_on_the_bf16_wire():
    """``refill()`` and the eviction thunk hand float32 numpy rows to the
    masters also when the rows crossed as bfloat16."""
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 4, mini_batch_size=64,
                          seed=5, round_targets=True)
    tr = CachedDlrmTrainer(_cfg(True, wire_rows_bf16=True, cache_size=8, num_ways=2), ds,
                           device="cpu")
    try:
        evicted = None
        for batch in ds.batches():
            uniques = [np.unique(batch.ls_i[t]) for t in range(len(LN_EMB))]
            plan = tr.controller.plan_insert(uniques, tr.master.gather_all(uniques))
            evicted = tr.refill(plan)
        assert evicted.dtype == np.float32 and evicted.shape[0] > 0
        np.testing.assert_array_equal(
            evicted, evicted.astype(ml_dtypes.bfloat16).astype(np.float32))
        # the inserted rows were rounded to bfloat16 on the way in
        got = tr.cache.numpy()[plan.insert_slots]
        np.testing.assert_array_equal(
            got, plan.insert_rows.astype(ml_dtypes.bfloat16).astype(np.float32))
        thunk = tr._deferred_host(torch.ones(3, 16, dtype=torch.bfloat16))
        assert thunk().dtype == np.float32
    finally:
        tr.close()


def test_upcast_x_reads_fp8_only():
    x = torch.tensor([[0.3, 1.7, -2.2]])
    x8 = x.to(torch.float8_e4m3fn)
    assert tstep._upcast_x(x8, None).dtype == torch.float32
    assert tstep._upcast_x(x8, torch.bfloat16).dtype == torch.bfloat16
    np.testing.assert_array_equal(tstep._upcast_x(x8, None).numpy(), [[0.3125, 1.75, -2.25]])
    assert tstep._upcast_x(x, torch.bfloat16) is x


# ----------------------------------------------------------------- records


def _records(port: bool, tmp_path):
    log = str(tmp_path / ("port.jsonl" if port else "jax.jsonl"))
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 8, mini_batch_size=64,
                          seed=6, round_targets=True)
    cfg = _cfg(port, metrics_log=log)
    tr = CachedDlrmTrainer(cfg, ds, ds, device="cpu") if port else JaxTrainer(cfg, ds, ds)
    lines = []
    try:
        tr.train(max_steps=8, log_fn=lines.append)
        tr.evaluate(max_batches=2, log_fn=lines.append)
        last_window = dict(tr.last_window)
    finally:
        tr.close()
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    return recs, lines, last_window


def test_metrics_log_records_have_cdlrm_tpu_keys(tmp_path):
    """Every ``train_window`` and ``eval`` line of ``--metrics-log`` has the
    keys cdlrm_tpu writes, ``mh_prefetches`` (0 on one host) and
    ``per_table_hit_rates`` included; the rates are equal (the same host
    layer), rounded to 4 digits; ``evaluate`` prints the summary line."""
    (j_recs, j_lines, j_last), (p_recs, p_lines, p_last) = (
        _records(False, tmp_path), _records(True, tmp_path))
    assert [r["kind"] for r in p_recs] == [r["kind"] for r in j_recs]
    assert {r["kind"] for r in p_recs} == {"train_window", "eval"}
    for pr, jr in zip(p_recs, j_recs):
        assert list(pr) == list(jr), (pr["kind"], sorted(set(pr) ^ set(jr)))
        assert pr["per_table_hit_rates"] == jr["per_table_hit_rates"]
        assert len(pr["per_table_hit_rates"]) == len(LN_EMB)
    assert list(p_last) == list(j_last) and p_last["mh_prefetches"] == 0
    want = [line for line in j_lines if line.startswith("Per-table train hit rates")]
    got = [line for line in p_lines if line.startswith("Per-table train hit rates")]
    assert got == want and len(got) == 1


# --------------------------------------------------------------- profiling


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(None):  # falsy directory: nothing happens
        pass
    assert not os.listdir(tmp_path)
    trace_dir = str(tmp_path / "trace")
    with profiling.profile_trace(trace_dir, torch.device("cpu")):
        torch.ones(8, 8) @ torch.ones(8, 8)
    path = os.path.join(trace_dir, profiling.TRACE_FILE)
    with open(path) as f:
        trace = json.load(f)
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])


def test_device_time_and_step_timer():
    t0 = profiling.device_time()
    assert profiling.device_time(torch.ones(2), "not a tensor") >= t0
    timer = profiling.StepTimer()
    timer.tick()
    timer.tick(3)
    assert timer.steps == 4 and timer.ms_per_iter >= 0.0
    timer.reset()
    assert timer.steps == 0


# ------------------------------------------------------- the current device


def test_use_device_sets_only_an_indexed_cuda_device(monkeypatch):
    """The CPU has no current device, and ``torch.device("cuda")`` without
    an index means the current one already."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    trainer_mod.use_device(torch.device("cpu"))
    trainer_mod.use_device(torch.device("cuda"))
    assert calls == []
    trainer_mod.use_device(torch.device("cuda", 1))
    assert calls == [torch.device("cuda", 1)]


def test_every_thread_that_stages_makes_the_device_current(monkeypatch, tmp_path):
    """The current CUDA device is a per-thread setting: the trainers set
    theirs where they are built and on each of their threads that launches
    CUDA work (the stager, the assembly pipeline, the eval producer, the
    checkpoint writer)."""
    import threading

    seen = []
    from cdlrm_tpu_torch.train import fulltable as fulltable_mod

    def record(device):
        seen.append((threading.current_thread().name, device))

    monkeypatch.setattr(trainer_mod, "use_device", record)
    monkeypatch.setattr(fulltable_mod, "use_device", record)
    ds = SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=64 * 8, mini_batch_size=64,
                          seed=6, round_targets=True)
    tr = CachedDlrmTrainer(_cfg(True, checkpoint_async=True), ds, ds, device="cpu")
    main = threading.current_thread().name
    assert seen == [(main, torch.device("cpu"))]
    try:
        tr.train(max_steps=8, log_fn=lambda *_: None)
        tr.evaluate(max_batches=1, log_fn=lambda *_: None)
        tr.save_checkpoint(str(tmp_path / "ck"))
    finally:
        tr.close()
    names = {name for name, _ in seen}
    assert {main, "window-stager", "assembly-pipeline", "eval-pipeline", "ckpt-writer"} <= names
    assert {device for _, device in seen} == {torch.device("cpu")}
    seen.clear()
    ft = FullTableDlrmTrainer(_cfg(True, use_cache=False), ds, ds, device="cpu")
    ft.train(max_steps=1, log_fn=lambda *_: None)
    ft.evaluate(max_batches=1, log_fn=lambda *_: None)
    ft.close()
    assert len(seen) >= 3
