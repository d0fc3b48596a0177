"""bench_block_ab_torch.py in its CPU mode, against bench_block_ab.py.

At the reference smoke's knobs (2 tables, 500 ids, batch 32, a cache of
2,048 rows; tests/test_bench_harnesses.py:40-50): the streams are the
reference's ``stream_indices`` drawn from the same generator after the same
gradients; the uniques, ranks, block union and buckets are the reference's
host side (bench_block_ab.py:78-121, restated here); both arms' caches after
a chain are within 1e-5 of each other and of a float64 sum of the same
terms; and the line's fields that are not times equal those of the
reference's line, from a subprocess of bench_block_ab.py. Times taken on the
CPU are checked only for being positive.
"""

import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_block_ab_torch as BA  # noqa: E402

SMOKE = {"BLOCKAB_TABLES": "2", "BLOCKAB_IDS": "500", "BLOCKAB_BATCH": "32",
         "BLOCKAB_CACHE_ROWS": "2048"}
TIMES = ("per_step_ms_A_dedup", "per_step_ms_B_coalesced", "B_over_A")


def _lines(script, env_extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env_extra)
    p = subprocess.run([sys.executable, os.path.join(REPO, script)], capture_output=True,
                       text=True, timeout=240, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def reference():
    """bench_block_ab.py's module with the smoke knobs read at import."""
    old = {k: os.environ.get(k) for k in SMOKE}
    os.environ.update(SMOKE)
    try:
        import bench_block_ab

        yield importlib.reload(bench_block_ab)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def lines():
    """Both harnesses' lines at the smoke knobs, in their CPU modes."""
    env = dict(SMOKE, BLOCKAB_CPU="1", JAX_PLATFORMS="cpu")
    return {"port": _lines("bench_block_ab_torch.py", env),
            "reference": _lines("bench_block_ab.py", env)}


def _draws(module_stream, k):
    """The gradients, then each stream, from one SFC64(7) generator."""
    rng = np.random.Generator(np.random.SFC64(7))
    grads = rng.random((BA.STEPS, k["tables"] * k["batch"], BA.D), np.float32) - 0.5
    return grads, {kind: module_stream(kind, rng) for kind in BA.STREAMS}


def test_streams_are_the_reference_streams(reference):
    k = BA.knobs(SMOKE)
    assert (reference.T, reference.B, reference.R, reference.CACHE_ROWS) == (
        k["tables"], k["batch"], k["ids"], k["cache_rows"])
    g_port, port = _draws(lambda kind, rng: BA.stream_indices(
        kind, BA.STEPS, rng, k["tables"], k["batch"], k["ids"]), k)
    g_ref, ref = _draws(lambda kind, rng: reference.stream_indices(kind, BA.STEPS, rng), k)
    np.testing.assert_array_equal(g_port, g_ref)
    for kind in BA.STREAMS:
        assert len(port[kind]) == BA.STEPS
        for a, b in zip(port[kind], ref[kind]):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", BA.STREAMS)
def test_host_inputs_are_the_reference_host_side(reference, kind):
    """bench_block_ab.py:78-121, restated: per-step uniques and inverse
    ranks, the block union and each step's ranks in it, pow2 buckets and
    the paddings (CACHE_ROWS - 1 for slots, 0 for block ranks)."""
    k = BA.knobs(SMOKE)
    _, streams = _draws(lambda kd, rng: reference.stream_indices(kd, BA.STEPS, rng), k)
    ls = streams[kind]
    h = BA.host_inputs(ls, k["tables"], k["cache_rows"])
    cache_rows, tables = reference.CACHE_ROWS, reference.T
    flat = [(l + (np.arange(tables, dtype=np.int64) * (cache_rows // tables))[:, None])
            .reshape(-1) for l in ls]
    uniqs = [np.unique(f, return_inverse=True) for f in flat]
    u_bucket = 1 << int(np.ceil(np.log2(max(len(u) for u, _ in uniqs))))
    bu = np.unique(np.concatenate(flat))
    p_rows = 1 << int(np.ceil(np.log2(len(bu))))
    assert (h["u_bucket"], h["u_block"], h["p_rows"]) == (u_bucket, len(bu), p_rows)
    assert h["step_u"] == [len(u) for u, _ in uniqs]
    for s, (u, r) in enumerate(uniqs):
        np.testing.assert_array_equal(h["ranks_a"][s], r.astype(np.int32))
        np.testing.assert_array_equal(h["uniq_a"][s, : len(u)], u)
        assert (h["uniq_a"][s, len(u):] == cache_rows - 1).all()
        assert h["nvalid"][s] == len(u)  # every row lies in the cache here
        np.testing.assert_array_equal(h["ranks_b"][s], np.searchsorted(bu, flat[s]))
        np.testing.assert_array_equal(h["uniq_blk"][s, : len(u)], np.searchsorted(bu, u))
        assert (h["uniq_blk"][s, len(u):] == 0).all()
    np.testing.assert_array_equal(h["uniq_b"][: len(bu)], bu)
    assert (h["uniq_b"][len(bu):] == cache_rows - 1).all()
    assert h["u_valid"] == len(bu)
    for key in ("ranks_a", "uniq_a", "ranks_b", "uniq_blk", "uniq_b"):
        assert h[key].dtype == np.int32, key


def _inputs(knobs, kind):
    k = BA.knobs(knobs)
    grads, streams = _draws(lambda kd, rng: BA.stream_indices(
        kd, BA.STEPS, rng, k["tables"], k["batch"], k["ids"]), k)
    h = BA.host_inputs(streams[kind], k["tables"], k["cache_rows"])
    t = SimpleNamespace(**{key: torch.from_numpy(np.ascontiguousarray(h[key])) for key in (
        "ranks_a", "uniq_a", "nvalid", "ranks_b", "uniq_blk", "uniq_b")},
        u_bucket=h["u_bucket"], u_valid=h["u_valid"], p_rows=h["p_rows"],
        u_valid_t=torch.tensor([h["u_valid"]]))
    return k, grads, h, t


# the last table's rows run past the cache: table 1 owns rows 400-899 of 800
PAST_END = dict(SMOKE, BLOCKAB_CACHE_ROWS="800")


@pytest.mark.parametrize("knobs", [SMOKE, PAST_END], ids=["smoke", "past_end"])
@pytest.mark.parametrize("kind", BA.STREAMS)
def test_arms_agree_with_a_float64_sum(kind, knobs):
    """Each arm's whole cache after one chain from zero, on the wrappers'
    CPU forms, within 1e-5 of the other arm's and of the float64 sum of the
    same gradients at the same rows (numpy's unbuffered add), rows past the
    cache's end dropped."""
    k, grads, h, t = _inputs(knobs, kind)
    g = torch.from_numpy(grads)
    top = max(int(f.max()) for f in h["flat"]) + 1
    assert (top > k["cache_rows"]) == (knobs is PAST_END)
    ref = np.zeros((max(top, k["cache_rows"]), BA.D))
    for s in range(BA.STEPS):
        np.add.at(ref, h["flat"][s], grads[s].astype(np.float64))
    ref = ref[: k["cache_rows"]]
    ops = BA.row_ops()
    cache_a = BA.chain_a(torch.zeros((k["cache_rows"], BA.D)), t, g, ops)
    cache_b = torch.zeros((k["cache_rows"], BA.D))
    pend = torch.zeros((h["p_rows"], BA.D))
    BA.chain_b(cache_b, pend, t, g, ops)
    assert not pend.any()
    np.testing.assert_allclose(cache_a.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache_b.numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(cache_a.numpy(), cache_b.numpy(), rtol=0, atol=1e-5)
    errs = BA.check_chains(t, g, k["cache_rows"], torch.device("cpu"))
    assert set(errs) == {"A", "B", "A_plain", "B_plain", "A_vs_B", "A_vs_A_plain",
                         "B_vs_B_plain"}
    assert max(errs.values()) <= BA.CHECK_TOL, errs


@pytest.mark.parametrize("kind", BA.STREAMS)
def test_rows_past_the_cache_are_dropped_as_the_reference_drops_them(kind):
    """The reference's own chains (bench_block_ab.py:126-155, its XLA adds
    and gathers, restated in jax on the reference's unclamped host side)
    against the port's on the same inputs, where the last table's rows pass
    the cache's end: the same caches within 1e-5 (the adds reassociate) and
    the same effective-weight sum of arm B."""
    import jax.numpy as jnp

    k, grads, h, t = _inputs(PAST_END, kind)
    rows = k["cache_rows"]
    assert h["u_valid"] < h["u_block"] and min(h["nvalid"]) < max(h["step_u"])
    # the reference's uniq_a and uniq_b: sorted uniques padded with the last row
    uniq = [np.unique(f) for f in h["flat"]]
    uniq_a = np.stack([np.pad(u, (0, h["u_bucket"] - len(u)), constant_values=rows - 1)
                       for u in uniq]).astype(np.int32)
    bu = np.unique(np.concatenate(h["flat"]))
    uniq_b = np.pad(bu, (0, h["p_rows"] - len(bu)), constant_values=rows - 1).astype(np.int32)
    cache = jnp.zeros((rows, BA.D), jnp.float32)
    for s in range(BA.STEPS):
        seg = jnp.zeros((h["u_bucket"], BA.D), jnp.float32).at[h["ranks_a"][s]].add(grads[s])
        cache = cache.at[uniq_a[s]].add(seg)
    ref_a = np.asarray(cache)
    cache = jnp.zeros((rows, BA.D), jnp.float32)
    pend = jnp.zeros((h["p_rows"], BA.D), jnp.float32)
    ref_sum = 0.0
    for s in range(BA.STEPS):
        pend = pend.at[h["ranks_b"][s]].add(grads[s])
        ref_sum += float((cache[uniq_a[s]] - 0.1 * pend[h["uniq_blk"][s]]).sum())
    ref_b = np.asarray(cache.at[uniq_b].add(pend))

    g, ops = torch.from_numpy(grads), BA.row_ops()
    got_a = BA.chain_a(torch.zeros((rows, BA.D)), t, g, ops).numpy()
    got_b = torch.zeros((rows, BA.D))
    got_sum = float(BA.chain_b(got_b, torch.zeros((h["p_rows"], BA.D)), t, g, ops))
    np.testing.assert_allclose(got_a, ref_a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), ref_b, rtol=0, atol=1e-5)
    assert abs(got_sum - ref_sum) <= 1e-5 * max(1.0, abs(ref_sum))


def test_line_matches_the_reference_line(lines):
    port, ref = lines["port"], lines["reference"]
    assert [r["stream"] for r in port] == [r["stream"] for r in ref] == list(BA.STREAMS)
    for p, r in zip(port, ref):
        assert set(r) <= set(p), set(r) - set(p)
        for key in set(r) - set(TIMES):
            assert p[key] == r[key], (key, p[key], r[key])
        for key in TIMES + ("per_step_ms_A_dedup_events", "per_step_ms_B_coalesced_events"):
            assert p[key] > 0, (key, p[key])
        assert p["backend"] == "cpu" and p["device"] is None
        assert max(p["check_max_err"].values()) <= p["check_tol"] == 1e-5
        # the CPU forms launch no kernel
        assert p["launches"] == dict.fromkeys(
            ("gather_rows", "scatter_set_rows", "scatter_add_rows", "index_add_rows"), 0)


def test_without_a_card_exits_nonzero():
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_block_ab_torch.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 1 and not p.stdout.strip(), p.stdout
    assert "no CUDA device" in p.stderr and "BLOCKAB_CPU=1" in p.stderr
