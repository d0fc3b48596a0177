"""bench_pressure_torch.py in its CPU mode, against bench_pressure.py.

At knobs where one print window fires and the 3% point is real pressure (2
tables x 20,000 ids, dim 8, batch 256, 48 steps: at the reference smoke's
600 ids the three capacity points clamp to the same 536 rows and no window
prints a hit rate), both harnesses run as a user runs them, each in a
subprocess in its CPU mode. The port's line is held to the reference's: the
rows per table, the last window's hit rate and the rows written back
exactly, ``pressure_real`` equal, and acc, AUC and loss within 5e-3, the
bfloat16-compute tolerance (the same operands rounded to bfloat16, summed in
float32 in another order; ROADMAP.md's designed differences). The stream is
held to a copy of the reference's ``LatentSignalDataset`` and the
configuration to the reference's ``_cfg``, finalized by cdlrm_tpu's Config.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cdlrm_tpu.config import Config as JaxConfig
from test_torch_jax_free import _fields_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_pressure_torch as P  # noqa: E402

KNOBS = {"PRESSURE_TABLES": "2", "PRESSURE_IDS": "20000", "PRESSURE_DIM": "8",
         "PRESSURE_BATCH": "256", "PRESSURE_STEPS": "48"}
BF16_TOL = 5e-3


def _line(script, env_extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu", **env_extra)
    p = subprocess.run([sys.executable, os.path.join(REPO, script)], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lines():
    env = dict(KNOBS, PRESSURE_CPU="1")
    return {"port": _line("bench_pressure_torch.py", env),
            "reference": _line("bench_pressure.py", env)}


def test_line_matches_the_reference_line(lines):
    port, ref = lines["port"], lines["reference"]
    assert port["metric"] == ref["metric"] == "pressure_auc_gap"
    assert port["backend"] == ref["backend"] == "cpu" and port["device"] is None
    assert port["steps"] == ref["steps"] == 48
    for key, value in ref["geometry"].items():
        assert port["geometry"][key] == value, key
    assert port["pressure_real"] is ref["pressure_real"] is True
    assert set(port["pressure_auc_gap"]) == set(ref["pressure_auc_gap"]) == {"30%", "10%", "3%"}
    assert len(port["cached"]) == len(ref["cached"]) == 3
    for p, r in zip(port["cached"], ref["cached"]):
        assert set(r) <= set(p)
        for key in ("capacity_frac", "rows_per_table", "hit_rate", "rows_written"):
            assert p[key] == r[key], (key, p, r)
        for key in ("acc", "auc", "loss"):
            assert abs(p[key] - r[key]) <= BF16_TOL, (key, p[key], r[key])
    for key in ("acc", "auc"):
        assert abs(port["oracle"][key] - ref["oracle"][key]) <= BF16_TOL, key
    for cap, gap in port["pressure_auc_gap"].items():
        assert abs(gap - ref["pressure_auc_gap"][cap]) <= 2 * BF16_TOL, cap
    # the hardest point is real pressure: misses and writebacks
    hardest = port["cached"][-1]
    assert hardest["hit_rate"] < 0.99 and hardest["rows_written"] > 0
    assert [c["rows_per_table"] for c in port["cached"]] == [6008, 2008, 632]
    assert all(np.isfinite([c["auc"], c["acc"], c["loss"]]).all() for c in port["cached"])


def test_reused_oracle_is_taken_as_given():
    """PRESSURE_ORACLE skips the oracle's training; one capacity point."""
    rec = _line("bench_pressure_torch.py", dict(
        KNOBS, PRESSURE_CPU="1", PRESSURE_ORACLE="0.5,0.75", PRESSURE_CAPS="0.03",
        PRESSURE_STEPS="16"))
    assert rec["oracle"] == {"acc": 0.5, "auc": 0.75, "reused": True}
    [only] = rec["cached"]
    assert rec["pressure_auc_gap"] == {"3%": round(0.75 - only["auc"], 4)}


@pytest.mark.parametrize("stream", ["loguniform", "zipf1.2"])
def test_stream_is_the_reference_stream(stream, monkeypatch):
    """The copied LatentSignalDataset against bench_pressure.py's own (its
    module reads the knobs at import: they are set before a fresh import)."""
    import importlib

    knobs = dict(KNOBS, PRESSURE_STREAM=stream, PRESSURE_BATCH="64")
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    import bench_pressure
    from cdlrm_tpu.data.synthetic import Batch

    ref_mod = importlib.reload(bench_pressure)
    ref_mod.Batch = Batch  # bound by the reference's main() before it builds a stream
    geo = P.geometry(knobs)
    for seed in (0, 1234):
        ours = list(P.LatentSignalDataset(geo, 3, seed=seed).batches())
        theirs = list(ref_mod.LatentSignalDataset(3, seed=seed).batches())
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            for x, y in zip((a.x, a.ls_i, a.y), (b.x, b.ls_i, b.y)):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            assert a.ls_mask is None and b.ls_mask is None


@pytest.mark.parametrize("extra", [
    {}, {"use_cache": False, "num_indices_per_lookup": 1, "num_indices_per_lookup_fixed": True},
    {"cache_size": 64},
], ids=["cached", "oracle", "small_cache"])
@pytest.mark.parametrize("env", [{}, {"PRESSURE_OPT": "adagrad", "PRESSURE_ADAGRAD_MASTER": "1"},
                                 {"PRESSURE_ROWS_BF16": "0", "PRESSURE_AVG_WB": "1"}],
                         ids=["sgd", "adagrad_master", "f32_rows_avg_wb"])
def test_config_is_the_reference_config(env, extra):
    """``config_kwargs`` (the reference's ``_cfg``) finalizes alike in both
    packages."""
    knobs = dict(KNOBS, **env)
    geo = P.geometry(knobs)
    port = P.make_config(knobs, geo, **extra)
    jax_cfg = JaxConfig(**P.config_kwargs(knobs, geo, **extra))
    jax_cfg.finalize(ln_emb=geo["sizes"].copy())
    _fields_equal(port, jax_cfg)


def test_without_a_card_exits_nonzero():
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_pressure_torch.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 1 and not p.stdout.strip(), p.stdout
    assert "no CUDA device" in p.stderr and "PRESSURE_CPU=1" in p.stderr
