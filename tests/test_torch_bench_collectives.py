"""bench_collectives_torch.py on CPU gloo ranks, against bench_collectives.py.

The reference counts collective bytes from compiled HLO over an 8-device
virtual mesh (run here in a subprocess: it sets ``XLA_FLAGS`` before jax
loads); the port counts them at its ``DpGroup`` calls, at 2 and 4 ranks, one
process each, at the same per-rank shapes. Per rank the refill (strict and
delta) and the train step move exactly the reference's bytes. The three
aggregates differ by one designed difference, asserted exactly: the union of
the touched masks is reduced over uint8 in the port (gloo reduces neither
bool nor bfloat16), 1 byte a cache row, where the reference's bfloat16 mask
is an all-reduce of 4 bytes a row in its HLO. With that difference added
back, the port's ratios are the reference's.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_collectives_torch as C  # noqa: E402

EXACT = ("refill_strict", "refill_delta", "train")
AGGREGATES = ("aggregate_sparse", "aggregate_dense", "aggregate_sparse_adagrad")
# bytes a cache row of the touched-mask reduction: the reference's HLO, the port
MASK_BYTES_REF, MASK_BYTES_PORT = 4, 1


def _lines(argv, env_extra=None, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    p = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr[-3000:]
    return [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def lines():
    port = _lines([os.path.join(REPO, "bench_collectives_torch.py"), "--backend", "cpu"])
    ref = _lines([os.path.join(REPO, "bench_collectives.py")], {"JAX_PLATFORMS": "cpu"})
    return {"port": port, "reference": {r["step"]: r for r in ref}}


def _port(lines, world):
    return {r["step"]: r for r in lines["port"] if r.get("world") == world}


@pytest.mark.parametrize("world", [2, 4])
def test_refill_and_train_bytes_equal_the_hlo_counts(lines, world):
    port, ref = _port(lines, world), lines["reference"]
    assert set(port) == set(ref)
    for step in EXACT:
        assert port[step]["total"] == ref[step]["total"], (step, port[step], ref[step])
    rows = ref["refill_strict"]["cache_rows"]
    assert port["refill_strict"]["cache_rows"] == rows
    assert port["refill_strict"]["collective_bytes"] == {
        "broadcast_from0": rows * C.DIM * 4 + C.EVICTS * C.DIM * 4}
    assert port["refill_delta"]["collective_bytes"] == {"broadcast_from0": C.EVICTS * C.DIM * 4}
    assert set(port["train"]["collective_bytes"]) == {"all_reduce_sum"}
    assert port["train"]["batch_per_rank"] * world == port["train"]["global_batch"]
    for step in ("refill_strict", "refill_delta"):
        assert (port[step]["inserts"], port[step]["evicts"]) == (
            ref[step]["inserts"], ref[step]["evicts"])


@pytest.mark.parametrize("world", [2, 4])
def test_aggregate_bytes_differ_by_the_mask_width_alone(lines, world):
    port, ref = _port(lines, world), lines["reference"]
    rows = ref["aggregate_sparse"]["cache_rows"]
    for step in AGGREGATES:
        got, want = port[step], ref[step]
        assert got["union_bucket"] == want["union_bucket"]
        assert got["collective_bytes"]["all_reduce_max"] == MASK_BYTES_PORT * rows, got
        assert got["total"] + (MASK_BYTES_REF - MASK_BYTES_PORT) * rows == want["total"], (
            step, got, want)
    # the rows (and the AdaGrad state) ride the sum: the union bucket's rows
    # in the sparse form, the whole cache in the dense one
    assert port["aggregate_sparse"]["collective_bytes"]["all_reduce_sum"] == (
        C.UNION_BUCKET * C.DIM * 4)
    assert port["aggregate_dense"]["collective_bytes"]["all_reduce_sum"] == rows * C.DIM * 4
    assert port["aggregate_sparse_adagrad"]["collective_bytes"]["all_reduce_sum"] == (
        C.UNION_BUCKET * (C.DIM + 1) * 4)


def test_ratios_are_the_reference_ratios_with_the_mask_width(lines):
    ref = list(lines["reference"].values())
    [last] = [r for r in lines["port"] if r.get("metric") == "collective_bytes_ratios"]
    assert last is lines["port"][-1]
    assert last["worlds"] == [2, 4] and last["backend"] == "cpu" and last["device"] is None
    rows = lines["reference"]["aggregate_sparse"]["cache_rows"]
    widened = [dict(r, total=r["total"] + (MASK_BYTES_REF - MASK_BYTES_PORT) * rows)
               if r["step"] in AGGREGATES else r for r in _port(lines, 2).values()]
    assert C.ratios(widened) == C.ratios(ref)
    # COLLECTIVES_r04.json's ratios, from the reference's own counts
    assert C.ratios(ref) == {"refill_strict_over_delta": 210.0,
                             "aggregate_dense_over_sparse": 9.6,
                             "adagrad_aggregate_overhead_frac": 0.0222}
    assert last["ratios"] == C.ratios(list(_port(lines, 4).values()))
    assert last["ratios"]["refill_strict_over_delta"] == 210.0
    assert last["launches"] == dict.fromkeys(
        ("gather_rows", "scatter_set_rows", "scatter_add_rows", "index_add_rows"), 0)


def test_counting_group_counts_each_call_once():
    """The wrapper counts the outer call alone: ``gather_batch_rows`` sums
    inside the group, and that sum is not counted again."""
    import numpy as np
    import torch

    from cdlrm_tpu_torch.parallel.mesh import DpGroup

    g = C.CountingGroup(DpGroup())
    assert g.single and g.world_size == 1
    g.all_reduce_sum(torch.zeros(3, 4))
    g.all_reduce_max(torch.zeros(5, dtype=torch.uint8))
    g.broadcast_from0(torch.zeros(2, dtype=torch.float64))
    g.gather_batch_rows(torch.zeros(6, 2))
    g.all_gather_host(np.zeros((2, 3), np.int32))
    g.gather_host_to0(np.zeros(4, np.float32))
    assert g.take() == {"all_reduce_sum": 48, "all_reduce_max": 5, "broadcast_from0": 16,
                        "gather_batch_rows": 48, "all_gather_host": 24, "gather_host_to0": 16}
    assert g.take() == {}


def test_without_a_card_exits_nonzero():
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_collectives_torch.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 1 and not p.stdout.strip(), p.stdout
    assert "no CUDA device" in p.stderr and "--backend cpu" in p.stderr
