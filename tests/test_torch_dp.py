"""cdlrm_tpu_torch's data-parallel device steps against cdlrm_tpu's, on the
CPU: N gloo ranks of the port (tests/torch_dp_worker.py) beside cdlrm_tpu's
N-device mesh of virtual CPU devices, on the same seeded inputs.

The counterparts of tests/test_step.py:128-284: the train step's dense-grad
mean, metric sums and touched mask, the refill's broadcast from replica 0,
and the aggregate step's three ops in its sparse and dense forms. The port's
rank-r tensors are held against block r of cdlrm_tpu's flat ``[N*R, ...]``
arrays, in float32 within 1e-5 (the frameworks sum the dense math and the
ranks in different orders; nothing else differs), masks and counts exactly.
The trash row's value is unspecified by contract and left out.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_worker as W
from cdlrm_tpu.models.dlrm import init_dlrm as jax_init_dlrm
from cdlrm_tpu.parallel.mesh import make_dp_mesh as jax_mesh
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu_torch.parallel import mesh as tmesh
from cdlrm_tpu_torch.train import step as tstep

TOL = dict(atol=1e-5, rtol=1e-5)
OPS = ["sum", "mean", "max"]

TRAIN_STEPS = {"ts2": dict(ndev=2, b_glob=16), "ts4": dict(ndev=4, b_glob=16, seed=3),
               "ts2_bias": dict(ndev=2, b_glob=16, strict_bias=True)}
REFILLS = {
    "rf4_strict": dict(ndev=4, mode="strict"),
    "rf4_off": dict(ndev=4, mode="off"),
    "rf2_delta": dict(ndev=2, mode="delta"),
    "rf2_strict_bf16": dict(ndev=2, mode="strict", bf16=True),
    "rf2_strict_adagrad": dict(ndev=2, mode="strict", optimizer="adagrad"),
    "rf2_delta_master": dict(ndev=2, mode="delta", optimizer="adagrad", master_state=True),
    "rf2_strict_master": dict(ndev=2, mode="strict", optimizer="adagrad", master_state=True),
}
AGGS = {}
for _op in OPS:
    for _bucket in (None, "union", 64):
        AGGS[f"ag4_{_op}_{_bucket}"] = dict(ndev=4, op=_op, bucket=_bucket)
    for _bucket in (None, "union"):
        AGGS[f"ag2_{_op}_{_bucket}_adagrad"] = dict(ndev=2, op=_op, bucket=_bucket,
                                                    optimizer="adagrad")
        AGGS[f"ag2_{_op}_{_bucket}"] = dict(ndev=2, op=_op, bucket=_bucket)
    # the three rows of tests/test_step.py::test_aggregate_ops in a bucket of 16
    AGGS[f"ag4_{_op}_16_few"] = dict(ndev=4, op=_op, bucket=16, density=0.0)
KINDS = {**{k: "train_step" for k in TRAIN_STEPS}, **{k: "refill" for k in REFILLS},
         **{k: "aggregate" for k in AGGS}}
ALL = {**TRAIN_STEPS, **REFILLS, **AGGS}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case of this file through the port's ranks: one launch of two
    ranks and one of four."""
    out = str(tmp_path_factory.mktemp("dp_steps"))
    loaders = {}
    for world in (2, 4):
        cases = [dict(name=k, kind=KINDS[k], args=a) for k, a in ALL.items()
                 if a["ndev"] == world]
        loaders[world] = W.run_ranks(world, cases, out)
    return lambda name: [loaders[ALL[name]["ndev"]](name, r) for r in range(ALL[name]["ndev"])]


def _lead(mesh):
    return NamedSharding(mesh, P("dp"))


def _keep(geo):
    keep = np.ones(geo.total_rows, bool)
    keep[geo.trash_row] = False
    return keep


@pytest.mark.parametrize("name", list(TRAIN_STEPS))
def test_train_step_matches_cdlrm_tpu(port, name):
    """test_step.py::test_dp_matches_single_device's setting: one plain-wire
    step on a global batch. Every rank's cache and touched mask equal its
    block of cdlrm_tpu's; the dense parameters equal cdlrm_tpu's and are the
    same bits on every rank (biases apart under strict_bias_divergence,
    where each rank's equal its replica's); loss_sum and correct are global."""
    args = TRAIN_STEPS[name]
    ndev, b, seed = args["ndev"], args["b_glob"], args.get("seed", 0)
    geo = W.step_geometry(b // ndev)
    inp = W.step_inputs(ndev, b, seed)
    mesh = jax_mesh(ndev)
    ln_bot, ln_top = W.step_params()
    params = jstep.replicate_for_mesh(
        jax_init_dlrm(np.random.default_rng(seed), ln_bot, ln_top), mesh)
    scfg = jstep.StepConfig(loss_function="bce",
                            strict_bias_divergence=args.get("strict_bias", False))
    step = jstep.make_cached_train_step(mesh, geo, scfg)
    cols = NamedSharding(mesh, P(None, "dp"))
    j_params, j_cache, j_touched, j_loss, j_corr = step(
        params,
        jax.device_put(jnp.asarray(np.tile(inp["cache"], (ndev, 1))), _lead(mesh)),
        jax.device_put(jnp.zeros(ndev * geo.total_rows, bool), _lead(mesh)),
        jax.device_put(inp["x"], _lead(mesh)), jax.device_put(inp["slots"], cols),
        jax.device_put(np.zeros(inp["slots"].shape, bool), cols),
        jax.device_put(np.tile(inp["aux_slots"], ndev), _lead(mesh)),
        jax.device_put(np.tile(inp["aux_rows"], (ndev, 1)), _lead(mesh)),
        jax.device_put(inp["tgt"], _lead(mesh)), jnp.float32(0.1), jnp.float32(0.3),
    )
    j_cache = np.asarray(j_cache).reshape(ndev, geo.total_rows, -1)
    j_touched = np.asarray(j_touched).reshape(ndev, geo.total_rows)
    j_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(j_params)]
    ranks = port(name)
    keep = _keep(geo)
    b_loc = b // ndev
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["cache"][keep], j_cache[r][keep], **TOL)
        np.testing.assert_array_equal(got["touched"].astype(bool), j_touched[r])
        assert got["touched"].any() and not got["touched"][geo.trash_row]
        np.testing.assert_allclose(got["loss"], float(j_loss), **TOL)
        assert float(got["correct"]) == float(j_corr)
        # a replica moved only the rows of its own slice
        other = keep.copy()
        other[inp["slots"][:, r * b_loc: (r + 1) * b_loc].reshape(-1)] = False
        np.testing.assert_array_equal(got["cache"][other], inp["cache"][other])
        for i, jw in enumerate(j_leaves):
            np.testing.assert_allclose(got[f"param_{i}"], jw[r], **TOL)
            is_bias = jw.ndim == 2
            if args.get("strict_bias") and is_bias:
                continue
            np.testing.assert_array_equal(got[f"param_{i}"], ranks[0][f"param_{i}"])
    if args.get("strict_bias"):
        # the biases did diverge, as cdlrm_tpu's replicas' do
        assert any(np.abs(ranks[0][f"param_{i}"] - ranks[1][f"param_{i}"]).max() > 0
                   for i, jw in enumerate(j_leaves) if jw.ndim == 2)


def test_dp_step_matches_single_device_shards(port):
    """The global loss_sum of the data-parallel step is the sum of the shard
    losses that the one-replica step (no group, no collective) gives."""
    args = TRAIN_STEPS["ts4"]
    ndev, b, seed = args["ndev"], args["b_glob"], args["seed"]
    inp = W.step_inputs(ndev, b, seed)
    geo = W.step_geometry(b // ndev)
    ln_bot, ln_top = W.step_params()
    step = tstep.make_cached_train_step(geo, tstep.StepConfig(loss_function="bce"))
    total, b_loc = 0.0, b // ndev
    for r in range(ndev):
        sl = slice(r * b_loc, (r + 1) * b_loc)
        from cdlrm_tpu_torch.models.dlrm import init_dlrm

        params = init_dlrm(np.random.default_rng(seed), ln_bot, ln_top, device=torch.device("cpu"))
        slots = torch.from_numpy(np.ascontiguousarray(inp["slots"][:, sl]))
        _, _, loss, _ = step(
            params, torch.from_numpy(inp["cache"].copy()), torch.from_numpy(inp["x"][sl]), slots,
            torch.zeros(slots.shape, dtype=torch.bool), torch.from_numpy(inp["aux_slots"]),
            torch.from_numpy(inp["aux_rows"]), torch.from_numpy(inp["tgt"][sl]), 0.0, 0.0,
        )
        total += float(loss)
    np.testing.assert_allclose(float(port("ts4")[0]["loss"]), total, rtol=1e-5)


@pytest.mark.parametrize("name", list(REFILLS))
def test_refill_broadcast_matches_cdlrm_tpu(port, name):
    """test_step.py:177 and :200: evicted rows are the values before the
    insert, from replica 0; strict makes every replica equal replica 0 after
    the insert; delta and off keep the replicas' own rows (off also their
    own evicted rows); the row-wise state follows the same rule."""
    args = REFILLS[name]
    ndev, mode = args["ndev"], args["mode"]
    adagrad = args.get("optimizer") == "adagrad"
    master = args.get("master_state", False)
    inp = W.refill_inputs(ndev)
    geo = W.step_geometry(2)
    mesh = jax_mesh(ndev)
    scfg = jstep.StepConfig(refill_broadcast=mode, optimizer=args.get("optimizer", "sgd"),
                            adagrad_master_state=master,
                            wire_rows_bf16=args.get("bf16", False))
    refill = jstep.make_refill_step(mesh, scfg)
    rows = jnp.asarray(inp["insert_rows"])
    ops = [jax.device_put(jnp.asarray(inp["caches"].reshape(-1, W.D)), _lead(mesh)),
           jnp.asarray(inp["insert_slots"]),
           rows.astype(jnp.bfloat16) if args.get("bf16") else rows,
           jnp.asarray(inp["evict_slots"])]
    if adagrad:
        ops.append(jax.device_put(jnp.asarray(inp["accs"].reshape(-1)), _lead(mesh)))
    if master:
        ops.append(jnp.asarray(inp["insert_acc"]))
    res = refill(*ops)
    j_cache = np.asarray(res[0]).reshape(ndev, geo.total_rows, -1)
    j_evicted = np.asarray(res[-2 if master else -1].astype(jnp.float32)).reshape(ndev, 2, -1)
    ranks = port(name)
    keep = _keep(geo)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["cache"][keep], j_cache[r][keep])
        np.testing.assert_array_equal(got["evicted"], j_evicted[r])
        if adagrad:
            j_acc = np.asarray(res[1]).reshape(ndev, -1)
            np.testing.assert_array_equal(got["accum"][keep], j_acc[r][keep])
        if master:
            np.testing.assert_array_equal(got["ev_acc"], np.asarray(res[-1]).reshape(ndev, 2)[r])
    # the semantics, stated on the port's own output
    first = 0 if mode != "off" else None
    for r, got in enumerate(ranks):
        src = r if first is None else 0
        want = inp["caches"][src][[5, 7]]
        if args.get("bf16"):
            want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got["evicted"], want)
        np.testing.assert_array_equal(got["cache"][5], np.full(W.D, 42.0, np.float32))
        kept_from = 0 if mode == "strict" else r
        np.testing.assert_array_equal(got["cache"][7], inp["caches"][kept_from][7])


@pytest.mark.parametrize("name", list(AGGS))
def test_aggregate_matches_cdlrm_tpu(port, name):
    """test_step.py:218-284: union rows take the sum, mean or max of every
    replica's value, rows outside the union keep the replica's own, the mask
    comes back cleared, in the sparse form (a bucket that is exactly full, a
    larger one, the reference test's 16) and the dense one; under AdaGrad
    the row-wise state combines alike."""
    args = AGGS[name]
    ndev, op, bucket = args["ndev"], args["op"], args["bucket"]
    adagrad = args.get("optimizer") == "adagrad"
    inp = W.aggregate_inputs(ndev, density=args.get("density", 0.15))
    geo = W.step_geometry(2)
    union = inp["touched"].any(axis=0)
    if bucket == "union":
        bucket = int(union.sum())
    mesh = jax_mesh(ndev)
    scfg = jstep.StepConfig(table_agg_op=op, optimizer=args.get("optimizer", "sgd"))
    agg = jstep.make_aggregate_step(mesh, scfg, union_bucket=bucket, trash_row=geo.trash_row)
    ops = [jax.device_put(jnp.asarray(inp["caches"].reshape(-1, W.D)), _lead(mesh)),
           jax.device_put(jnp.asarray(inp["touched"].reshape(-1)), _lead(mesh))]
    if adagrad:
        ops.append(jax.device_put(jnp.asarray(inp["accs"].reshape(-1)), _lead(mesh)))
    res = agg(*ops)
    j_cache = np.asarray(res[0]).reshape(ndev, geo.total_rows, -1)
    keep = _keep(geo)
    reduce = {"sum": np.sum, "mean": np.mean, "max": np.max}[op]
    ranks = port(name)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["cache"][keep], j_cache[r][keep], **TOL)
        assert not got["touched"].any()
        np.testing.assert_allclose(got["cache"][union], reduce(inp["caches"][:, union], axis=0),
                                   **TOL)
        np.testing.assert_array_equal(got["cache"][~union & keep],
                                      inp["caches"][r][~union & keep])
        # union rows are the same bits on every rank
        np.testing.assert_array_equal(got["cache"][union], ranks[0]["cache"][union])
        if adagrad:
            j_acc = np.asarray(res[2]).reshape(ndev, -1)
            np.testing.assert_allclose(got["accum"][keep], j_acc[r][keep], **TOL)
            np.testing.assert_array_equal(got["accum"][~union & keep],
                                          inp["accs"][r][~union & keep])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("ndev", [2, 4])
def test_aggregate_sparse_equals_dense_in_the_port(port, op, ndev):
    """The port's two forms against each other. Two ranks, or the max: the
    same bits (one addition, or an order-free maximum). Four ranks' sums may
    be taken in another order at another place in the buffer: within 1e-6."""
    geo = W.step_geometry(2)
    keep = _keep(geo)
    for r, (sparse, dense) in enumerate(zip(port(f"ag{ndev}_{op}_union"),
                                            port(f"ag{ndev}_{op}_None"))):
        if ndev == 2 or op == "max":
            np.testing.assert_array_equal(sparse["cache"][keep], dense["cache"][keep])
        else:
            np.testing.assert_allclose(sparse["cache"][keep], dense["cache"][keep],
                                       rtol=1e-6, atol=1e-6)


def test_failing_rank_ends_the_launch(tmp_path):
    """A rank that raises exits non-zero; the launcher ends the other ranks
    and reports it instead of waiting in a collective."""
    cases = [dict(name="bad", kind="fail", args={}),
             dict(name="never", kind="aggregate", args=dict(ndev=2, op="sum"))]
    with pytest.raises(RuntimeError, match="fails on purpose"):
        W.run_ranks(2, cases, str(tmp_path), timeout=60)


def test_a_failing_rank_reports_before_it_leaves_the_group(tmp_path):
    """The failing rank writes its own error before it leaves the group, and
    its error leads the launcher's report. Here it stays a while after
    leaving (a slow teardown): rank 0 fails on the closed connections in the
    meantime and exits first, and the launcher ends rank 1 after the grace.
    A rank that reported only after leaving would have lost its message."""
    cases = [dict(name="bad", kind="fail", args=dict(linger_s=10.0)),
             dict(name="never", kind="aggregate", args=dict(ndev=2, op="sum"))]
    with pytest.raises(RuntimeError) as err:
        W.run_ranks(2, cases, str(tmp_path), timeout=60)
    text = str(err.value)
    ranks = text.split("\n--- rank ")[1:]
    assert ranks[0].startswith("1, exit "), text
    assert "fails on purpose" in ranks[0], text
    assert W.failed_at(ranks[0]) is not None, text


def test_report_order_puts_the_first_failure_first():
    """Ranks by the time each caught its error, then by their own non-zero
    code, then those the launcher ended."""
    def log(at):
        return f"Traceback ...\nrank 0 failed at {at:.6f}\n"

    assert W.report_order([1, 1], [log(20.0), log(10.5)]) == [1, 0]
    assert W.report_order([-9, 1, -9], ["", log(3.0), ""]) == [1, 0, 2]
    assert W.report_order([-9, 1, 0], ["", "", ""]) == [1, 0, 2]
    assert W.failed_at("rank 12 failed at 1760000000.250000") == 1760000000.25
    assert W.failed_at("no report") is None


def test_a_failed_join_launches_the_ranks_again(tmp_path, monkeypatch):
    """Joining the group can fail in gloo's connection of the ranks under
    load ("Connection closed by peer" in connectFullMesh), before any case
    has run on any rank: the launch starts again on a fresh rendezvous file.
    A rank that fails after joining is never relaunched (the test above)."""
    marker = tmp_path / "failed_once"
    monkeypatch.setenv("DP_WORKER_FAIL_JOIN_ONCE", str(marker))
    cases = [dict(name="agg", kind="aggregate", args=dict(ndev=2, op="sum"))]
    load = W.run_ranks(2, cases, str(tmp_path), timeout=60)
    assert marker.exists()
    assert {"cache", "touched"} <= set(load("agg", 1))


def test_destroy_dp_mesh_stops_the_group_threads(tmp_path):
    """Leaving the group joins its gloo threads, even while a reference
    cycle (a closed trainer's) holds the process group: a rank that exited
    with them running could abort in the interpreter's teardown after its
    results were written (SIGABRT, "terminate called without an active
    exception"), which failed a whole launch. Each rank checks after
    destroy_dp_mesh that no gloo thread is left, and raises if one is."""
    cases = [dict(name="cycle", kind="cycle", args={})]
    W.run_ranks(2, cases, str(tmp_path), timeout=60)
    for r in range(2):
        log = (tmp_path / f"log_w2_r{r}.txt").read_text()
        assert f"rank {r}: 1 cases done" in log, log


def test_world_size_one_needs_no_process_group():
    group = tmesh.make_dp_mesh(1)
    assert group.single and group.group is None and group.backend is None
    assert not torch.distributed.is_initialized()
    t = torch.arange(4.0)
    assert group.all_reduce_sum(t) is t and group.broadcast_from0(t) is t
    assert group.all_reduce_max(t) is t and group.gather_batch_rows(t) is t
    assert tmesh.local_replica_ids(group) == [0]
    assert tmesh.local_batch_rows(t, group) is t
    [only] = group.gather_host_to0(np.arange(3))
    np.testing.assert_array_equal(only, np.arange(3))
    group.barrier()


def test_local_batch_rows_slices_the_ranks_block():
    group = tmesh.DpGroup(rank=1, world_size=4)
    x = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(tmesh.local_batch_rows(x, group), x[2:4])
    ls = np.arange(2 * 8 * 3).reshape(2, 8, 3)
    np.testing.assert_array_equal(tmesh.local_batch_rows(ls, group, axis=1), ls[:, 2:4])
    assert tmesh.local_replica_ids(group) == [1]


def test_make_dp_mesh_refuses_what_it_cannot_join():
    with pytest.raises(ValueError, match="one process per device"):
        tmesh.make_dp_mesh(2)
    with pytest.raises(ValueError, match="backend must be one of"):
        tmesh.make_dp_mesh(2, 0, init_method="file:///nonexistent/x", backend="mpi")


@pytest.mark.parametrize("k", [40, 7, 1])
def test_union_slots_is_a_static_shape_nonzero(k):
    """``jnp.nonzero(size=k, fill_value=trash)``: ascending rows, the trash
    row after them, cut at the bucket; the count a tensor."""
    rng = np.random.default_rng(k)
    for flags in (rng.random(50) < 0.3, np.zeros(50, bool), np.ones(50, bool)):
        want = np.full(k, 49, np.int64)
        rows = np.flatnonzero(flags)[:k]
        want[: rows.size] = rows
        idx, count = tstep.union_slots(torch.from_numpy(flags), k, 49)
        assert idx.dtype == torch.int32 and count.dtype == torch.int64
        np.testing.assert_array_equal(idx.numpy(), want)
        assert int(count) == rows.size


def test_step_factories_refuse_unknown_modes():
    group = tmesh.DpGroup(rank=0, world_size=2)
    with pytest.raises(ValueError, match="unsupported refill_broadcast"):
        tstep.make_refill_step(tstep.StepConfig(refill_broadcast="lazy"), 0, group=group)
    with pytest.raises(ValueError, match="unsupported table_agg_op"):
        tstep.make_aggregate_step(tstep.StepConfig(table_agg_op="min"), group)
