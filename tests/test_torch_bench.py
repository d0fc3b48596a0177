"""The port's harnesses (bench_torch.py, bench_step_breakdown_torch.py,
bench_serving_ab_torch.py) in their CPU modes, against the contract of the
reference's harnesses (tests/test_bench_harnesses.py:76-130) and against
cdlrm_tpu.

Each harness runs as a subprocess, as a user runs it, and its last stdout
line is checked. bench_torch.py's stream is held to a copy of bench.py's
generator (bench.py:167-196), its Config keyword arguments finalize alike in
both packages, and the fields of its CPU line that are not times (hit rates,
the wire chosen, whether the block coalesced, refills, timed steps, staged
bytes) are held to cdlrm_tpu's CachedDlrmTrainer driven through bench.py's
flow in this process on the same config and stream. Times taken on the CPU
are checked only for being positive: they are never numbers to report.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.config import Config
from test_torch_jax_free import _fields_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_torch as B  # noqa: E402

HARNESSES = ("bench_torch.py", "bench_step_breakdown_torch.py", "bench_serving_ab_torch.py")
# tests/test_bench_harnesses.py:84-90, the keys bench.py's line must carry,
# but for vs_baseline (no TPU or V100 number is the port's denominator)
BENCH_KEYS = ("value", "unit", "hit_rate", "ms_per_iter", "device_step_ms",
              "eval_examples_per_sec", "steady_state_examples_per_sec",
              "steady_state_caching_overhead_ms_per_iter", "h2d_bytes_per_step")
BLOCK_KNOBS = {"BENCH_SKIP_EXTRAS": "1", "BENCH_DEDUP": "on", "BENCH_PACK": "0"}


def _run(script, env_extra, timeout=240):
    """Run one harness; returns its exit code, stdout lines and stderr."""
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    p = subprocess.run([sys.executable, os.path.join(REPO, script)], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    return p.returncode, [ln for ln in p.stdout.splitlines() if ln.strip()], p.stderr


def _last_line(script, env_extra):
    code, lines, err = _run(script, env_extra)
    assert code == 0, err[-3000:]
    assert lines, f"{script}: no stdout"
    return json.loads(lines[-1])


@pytest.fixture(scope="module")
def cpu_line():
    return _last_line("bench_torch.py", {"BENCH_CPU": "1"})


@pytest.fixture(scope="module")
def block_lines():
    """The BENCH_DEDUP=on BENCH_PACK=0 pair, with and without BENCH_BLOCK=0."""
    base = dict(BLOCK_KNOBS, BENCH_CPU="1")
    return {"coalesced": _last_line("bench_torch.py", base),
            "control": _last_line("bench_torch.py", dict(base, BENCH_BLOCK="0"))}


def test_bench_torch_cpu_line_keeps_the_contract(cpu_line):
    rec = cpu_line
    assert rec["metric"] == "cached_dlrm_train_examples_per_sec_per_chip"
    missing = [k for k in BENCH_KEYS if k not in rec]
    assert not missing, missing
    assert "vs_baseline" not in rec
    assert rec["value"] > 0 and rec["device_step_ms"] > 0
    assert rec["backend"] == "cpu" and rec["device"] is None
    # the steady-state regime holds refill boundaries
    assert rec["steady_refills"] >= 3
    rates = rec["window_examples_per_sec"]
    assert 0 < rates["min"] <= rates["median"] <= rates["max"] and rates["windows"] == 4
    # CPU tensors launch no kernel
    assert rec["launches"] == dict.fromkeys(B.KERNELS, 0)


@pytest.mark.parametrize("arm", ["coalesced", "control"])
def test_bench_torch_block_coalesce_pair(block_lines, arm):
    """tests/test_bench_harnesses.py:96-110's pair: the unpacked dedup wire
    resolves the block-coalesced update on under 'auto', BENCH_BLOCK=0 is
    the control arm, and both carry the scan-block metric."""
    rec = block_lines[arm]
    assert rec["block_coalesced"] is (arm == "coalesced")
    assert rec["block_step_ms_per_iter"] > 0
    assert rec["block_union_host_ms"] >= 0
    assert rec["dedup_active"] is True and rec["backend"] == "cpu"


def _bench_py_batches(ln_emb, batch, num_batches, stream, seed=0):
    """bench.py:167-196's generator, copied: (x, idx, y) per batch."""
    num_tables, table_rows = len(ln_emb), int(ln_emb[0])
    rng = np.random.Generator(np.random.SFC64(seed))
    for _ in range(num_batches):
        x = rng.random((batch, 13), dtype=np.float32)
        if stream.startswith("zipf"):
            a = float(stream[4:]) / 10.0
            idx = (rng.zipf(a, size=(num_tables, batch)) - 1) % table_rows
        elif stream == "uniform":
            idx = rng.integers(0, table_rows, size=(num_tables, batch))
        else:
            u = rng.random((num_tables, batch), dtype=np.float32)
            idx = np.exp(u * np.log(table_rows)).astype(np.int64) - 1
            np.minimum(idx, table_rows - 1, out=idx)
        y = np.round(rng.random((batch, 1), dtype=np.float32))
        yield x, idx, y


@pytest.mark.parametrize("stream", ["loguniform", "uniform", "zipf12"])
def test_stream_is_bench_py_stream(stream):
    ln_emb = np.full(5, 20_000, dtype=np.int64)
    got = list(B.ZipfDataset(ln_emb, 64, 3, stream, seed=4).batches())
    want = list(_bench_py_batches(ln_emb, 64, 3, stream, seed=4))
    assert len(got) == len(want) == 3
    for g, (x, idx, y) in zip(got, want):
        np.testing.assert_array_equal(g.x, x)
        np.testing.assert_array_equal(g.ls_i, idx)
        np.testing.assert_array_equal(g.y, y)
        assert g.ls_mask is None and g.ls_i.dtype == idx.dtype


@pytest.mark.parametrize("knobs", [
    {}, {"BENCH_CPU": "1"}, BLOCK_KNOBS, dict(BLOCK_KNOBS, BENCH_BLOCK="0"),
    {"BENCH_FP8": "1", "BENCH_SCAN": "1", "BENCH_PRESTAGE": "0", "BENCH_BATCH": "8192"},
    {"BENCH_HOT": "4096"}, {"BENCH_OPT": "adagrad", "BENCH_DEDUP": "1"},
    {"BENCH_SORTED": "1", "BENCH_PACK": "0", "BENCH_DEDUP": "on"},
], ids=["card", "cpu", "unpacked-dedup", "block-off", "fp8-scan1-noprestage-b8192", "hot",
        "adagrad", "sorted"])
def test_config_kwargs_finalize_alike_in_both_packages(knobs):
    """The harness's Config keyword arguments, finalized by cdlrm_tpu and by
    the port, give equal fields; so do the steady-state regime's."""
    geo = B.geometry(knobs)
    ln_emb = np.full(geo["tables"], geo["rows"], dtype=np.int64)
    kw = B.config_kwargs(knobs, geo)
    got = Config(**kw).finalize(ln_emb=ln_emb)
    want = JaxConfig(**kw).finalize(ln_emb=ln_emb)
    _fields_equal(got, want)
    _fields_equal(Config(**B.steady_config_kwargs(got, geo)).finalize(ln_emb=ln_emb),
                  JaxConfig(**B.steady_config_kwargs(want, geo)).finalize(ln_emb=ln_emb))


def _cdlrm_tpu_fields(env):
    """bench.py's flow (bench.py:201-431) through cdlrm_tpu's trainer in
    this process, on bench_torch.py's config and stream, without its timed
    calls: the fields of the line that are not times. The probes of the
    device-step and scan-block measurements run in bench.py's order."""
    geo = B.geometry(env)
    ln_emb = np.full(geo["tables"], geo["rows"], dtype=np.int64)
    cfg = JaxConfig(**B.config_kwargs(env, geo)).finalize(ln_emb=ln_emb)
    batch, warmup, steps = geo["batch"], geo["warmup"], geo["steps"]
    ds = B.ZipfDataset(ln_emb, batch, steps + warmup)
    tr = JaxTrainer(cfg, ds, B.ZipfDataset(ln_emb, batch, 12, seed=1))
    cfg.print_freq = warmup
    windows = []

    def capture(_line):
        if tr.last_window is not None:
            windows.append(dict(tr.last_window))

    try:
        tr.train(max_steps=warmup + steps, log_fn=capture)
        inputs, _, _, _ = tr._assemble(next(ds.batches()), cfg.local_batch_size)
        out = {"h2d_bytes_per_step": int(sum(getattr(a, "nbytes", 0) for a in inputs)),
               "block_coalesced": None}
        gen = ds.batches()
        items = [tr._assemble(next(gen), cfg.local_batch_size) for _ in range(tr._scan_block)]
        if all(it[2] == items[0][2] for it in items):
            out["block_coalesced"] = bool(items[0][2] and tr._block_coalesce
                                          and all(it[3] is not None for it in items))
        w = windows[-1]
        out.update(hit_rate=round(w["hit_rate"], 4), dedup_active=bool(w.get("dedup", False)),
                   timed_steps=sum(x["steps"] for x in windows[1:]))
        if env.get("BENCH_SKIP_EXTRAS") == "1":
            return out
        tr.evaluate(max_batches=2, log_fn=lambda *_: None)
        tr.evaluate(max_batches=10, log_fn=lambda *_: None)
        out["eval_hit_rate"] = round(tr.metrics.eval_hit_rate, 4)
    finally:
        tr.close()
    cfg_ss = JaxConfig(**B.steady_config_kwargs(cfg, geo)).finalize(ln_emb=ln_emb)
    ss = JaxTrainer(cfg_ss, B.ZipfDataset(ln_emb, batch, geo["ss_steps"] + 4, seed=2))
    try:
        ss.train(max_steps=geo["ss_steps"], log_fn=lambda *_: None)
        out["steady_refills"] = int(ss.metrics.refills)
    finally:
        ss.close()
    return out


def test_cpu_line_matches_cdlrm_tpu(cpu_line):
    """The default knobs: the plain packed wire (the CPU geometry's
    loguniform stream is too sparse for auto-dedup), blocks of 5 between the
    print cadences. Both packages stage the same wire, so the staged bytes
    agree exactly: x as bfloat16, the packed slots, the mask, the aux bucket,
    the uint8 targets."""
    want = _cdlrm_tpu_fields({"BENCH_CPU": "1"})
    got = {k: cpu_line[k] for k in want}
    assert got == want


def test_block_pair_matches_cdlrm_tpu(block_lines):
    """The unpacked dedup wire (BENCH_DEDUP=on BENCH_PACK=0): the same hits,
    wire and coalescing decision, and the same staged bytes (int32 ranks and
    unique rows, counts, aux bucket, targets)."""
    want = _cdlrm_tpu_fields(dict(BLOCK_KNOBS, BENCH_CPU="1"))
    got = {k: block_lines["coalesced"][k] for k in want}
    assert got == want


def test_step_breakdown_cpu_line():
    """tests/test_bench_harnesses.py:113-130's contract, and the port's
    coalesced block beside the components."""
    code, lines, err = _run("bench_step_breakdown_torch.py", {"BREAKDOWN_CPU": "1"})
    assert code == 0, err[-3000:]
    recs = [json.loads(ln) for ln in lines]
    rec = recs[-1]
    assert rec["metric"] == "step_breakdown" and rec["backend"] == "cpu"
    components = ("gather_uniq", "expand_take", "pend_scatter", "cache_scatter",
                  "flush_scatter", "dense_fwdbwd")
    assert [r["component"] for r in recs[:-1]] == list(components)
    for c in components:
        assert rec["components"][c] > 0, c
    assert rec["sum_components_coalesced_ms"] > 0 and rec["sum_components_perstep_ms"] > 0
    assert rec["block_step_ms_per_iter"] > 0 and rec["block_coalesced"] is True


def test_serving_ab_cpu_line():
    """tests/test_bench_harnesses.py:63-69's contract, near-full residency,
    one rank on the CPU (said in the line)."""
    rec = _last_line("bench_serving_ab_torch.py", {"SERVINGAB_CPU": "1"})
    assert rec["metric"] == "serving_pipeline_ab" and rec["backend"] == "cpu"
    assert rec["serial_examples_per_sec"] > 0 and rec["pipelined_examples_per_sec"] > 0
    assert rec["speedup"] > 0 and rec["eval_hit_rate"] > 0.9
    assert rec["ranks"] == 1 and "one rank" in rec["note"]


@pytest.mark.parametrize("script", HARNESSES)
def test_harness_without_a_card_exits_nonzero(script):
    """No card and no CPU request: a message and exit code 1, no line."""
    code, lines, err = _run(script, {"CUDA_VISIBLE_DEVICES": ""})
    assert code == 1 and not lines, (code, lines)
    assert "no CUDA device" in err and "_CPU=1" in err
