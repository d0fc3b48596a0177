"""The numpy parts of cdlrm_tpu_torch's parallel/multihost.py against
cdlrm_tpu's, without a process group: the window row store, the collecting
master, the routed eval exchange's pure parts and the window exchange's
packing, at simulated rank counts with each all-gather replaced by stacking
the ranks' operands (as tests/test_multihost.py:228-281 simulates hosts),
and the row-sharded accumulator store's refusal of rows it does not own.
Every comparison is exact: both packages copy numpy rows."""

import numpy as np
import pytest

from cdlrm_tpu.cache.master import AccumulatorStore as JaxAccumulatorStore
from cdlrm_tpu.parallel import multihost as jmh
from cdlrm_tpu_torch.cache.master import AccumulatorStore
from cdlrm_tpu_torch.parallel import multihost as pmh
from cdlrm_tpu_torch.parallel.mesh import DpGroup

LN_EMB, DIM = [97, 215, 31], 8


def _masters(mod, hosts, dims=None, seed=5):
    return [mod.ShardedMasterTables(LN_EMB, DIM, mod.RowShard(h, hosts),
                                    np.random.default_rng(seed), dims=dims)
            for h in range(hosts)]


def _whole(mod=pmh, dims=None):
    return mod.ShardedMasterTables(LN_EMB, DIM, mod.RowShard(0, 1), np.random.default_rng(5),
                                   dims=dims)


# ------------------------------------------------------------ window store
def test_window_row_store_matches_cdlrm_tpu(rng):
    uniques = [np.unique(rng.integers(0, n, 20)) for n in LN_EMB]
    rows = [rng.normal(size=(u.size, DIM)).astype(np.float32) for u in uniques]
    port, jax_ = pmh.WindowRowStore(uniques, rows), jmh.WindowRowStore(uniques, rows)
    for t, u in enumerate(uniques):
        ids = rng.choice(u, 30)
        got = port.gather(t, ids)
        np.testing.assert_array_equal(got, jax_.gather(t, ids))
        np.testing.assert_array_equal(got, rows[t][np.searchsorted(u, ids)])
    # the 1-D accumulators of the master state take the same join
    accs = [rng.random(u.size).astype(np.float32) for u in uniques]
    ids = uniques[1][::3]
    np.testing.assert_array_equal(pmh.WindowRowStore(uniques, accs).gather(1, ids),
                                  jmh.WindowRowStore(uniques, accs).gather(1, ids))


@pytest.mark.parametrize("empty", [False, True], ids=["missing-id", "empty-window"])
def test_window_row_store_refuses_ids_outside_the_window(empty):
    uniques = [np.zeros(0, np.int64) if empty else np.array([3, 7, 11], np.int64)]
    rows = [np.arange(uniques[0].size * 4, dtype=np.float32).reshape(-1, 4)]
    for mod in (pmh, jmh):
        store = mod.WindowRowStore(uniques, rows)
        with pytest.raises(KeyError, match="not in current lookahead window"):
            store.gather(0, np.array([5, 7]))
        # no ids: an empty answer, even from an empty window
        assert store.gather(0, np.zeros(0, np.int64)).shape == (0, 4)
    if empty:
        with pytest.raises(KeyError, match="empty window"):
            pmh.WindowRowStore(uniques, rows).gather(0, np.array([1]))


def test_collecting_master_matches_cdlrm_tpu(rng):
    port, jax_ = pmh.CollectingMaster(DIM), jmh.CollectingMaster(DIM)
    for t in (2, 0, 2):
        ids = rng.integers(0, 50, 7).astype(np.int32)
        got, want = port.gather(t, ids), jax_.gather(t, ids)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (7, DIM) and not got.any()
        ids[:] = -1  # the request is a copy, not a view of the caller's ids
    assert [t for t, _ in port.requests] == [t for t, _ in jax_.requests] == [2, 0, 2]
    for (_, a), (_, b) in zip(port.requests, jax_.requests):
        assert a.dtype == np.int64 and (a >= 0).all()
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- routed exchange
@pytest.mark.parametrize("hosts", [4, 16])
def test_routed_row_exchange_pure_parts_match_cdlrm_tpu(rng, hosts):
    """Each stage of the port's exchange equals cdlrm_tpu's on the same
    gathered operands, and every rank assembles exactly the rows one whole
    shard holds, with the routed payload O(capacity) rows in all."""
    cap = 48
    pm, jm = _masters(pmh, hosts), _masters(jmh, hosts)
    whole = _whole()
    pex = [pmh.GlobalRowExchange(m, cap) for m in pm]
    jex = [jmh.GlobalRowExchange(m, cap) for m in jm]
    reqs = [[(t, rng.integers(0, n, int(rng.integers(0, cap // len(LN_EMB)))))
             for t, n in enumerate(LN_EMB)] for _ in range(hosts)]
    packed = [pex[h]._pack_requests(reqs[h]) for h in range(hosts)]
    for h in range(hosts):
        np.testing.assert_array_equal(packed[h], jex[h]._pack_requests(reqs[h]))
    all_req = np.stack(packed)  # the first all-gather
    owners = pex[0]._owner_map(all_req)
    for h in range(hosts):
        np.testing.assert_array_equal(pex[h]._owner_map(all_req), owners)
        np.testing.assert_array_equal(jex[h]._owner_map(all_req), owners)
    per_owner = np.bincount(owners[owners >= 0], minlength=hosts)
    assert per_owner.sum() == int((owners >= 0).sum()) <= hosts * cap
    pad_to = max(1, int(per_owner.max()))
    contribs = [pex[h]._contribution(all_req, owners, pad_to) for h in range(hosts)]
    for h in range(hosts):
        np.testing.assert_array_equal(contribs[h],
                                      jex[h]._contribution(all_req, owners, pad_to))
    gathered = np.stack(contribs)  # the second all-gather
    for h in range(hosts):
        mine = pex[h]._assemble(owners, gathered)
        np.testing.assert_array_equal(mine, jex[h]._assemble(owners, gathered))
        n = 0
        for t, ids in reqs[h]:
            np.testing.assert_array_equal(mine[n: n + ids.size], whole.tables[t][ids])
            n += ids.size


def test_routed_exchange_refuses_requests_over_capacity():
    ex = pmh.GlobalRowExchange(_whole(), capacity=4)
    with pytest.raises(ValueError, match="5 eval miss rows exceed exchange capacity 4"):
        ex._pack_requests([(0, np.arange(3)), (1, np.arange(2))])


def test_routed_exchange_fetch_on_one_rank():
    """fetch on a group of one: both all-gathers are the identity, and the
    rows are the whole shard's, in request order."""
    whole = _whole()
    ex = pmh.GlobalRowExchange(whole, capacity=16, group=DpGroup())
    reqs = [(1, np.array([5, 200, 5])), (0, np.zeros(0, np.int64)), (2, np.array([30]))]
    got = ex.fetch(reqs)
    for (t, ids), rows in zip(reqs, got):
        np.testing.assert_array_equal(rows, whole.tables[t][ids])
    assert [r.shape[0] for r in ex.fetch([])] == []


# --------------------------------------------------------- window exchange
def _window(rng, hosts, dims=None):
    uniques = [np.unique(rng.integers(0, n, 40)) for n in LN_EMB]
    masters = _masters(pmh, hosts, dims)
    stores = [AccumulatorStore(LN_EMB, owned_ranges=m.ranges) for m in masters]
    for s in stores:
        for t, a in enumerate(s.accs):
            a[:] = np.arange(a.size, dtype=np.float32) + 1000 * t + 0.5
    owned = [[m.gather(t, uniques[t]) for t in range(len(LN_EMB))] for m in masters]
    accs = [[s.gather_owned_slice(t, uniques[t]) for t in range(len(LN_EMB))] for s in stores]
    return uniques, masters, owned, accs


@pytest.mark.parametrize("with_accs", [False, True], ids=["rows", "rows-and-accs"])
@pytest.mark.parametrize("hosts", [2, 4])
def test_window_exchange_pack_and_unpack(rng, hosts, with_accs, monkeypatch):
    """pack_window_rows / unpack_window_rows at simulated rank counts: every
    rank reassembles the window's rows of one whole shard (and, with the
    master state's column, its accumulators), and each rank's operand is the
    one cdlrm_tpu's exchange_window_rows hands its all-gather."""
    from jax.experimental import multihost_utils

    uniques, masters, owned, accs = _window(rng, hosts, dims=[8, 4, 8])
    whole = _whole(dims=[8, 4, 8])
    ops = [pmh.pack_window_rows(masters[h], uniques, owned[h], accs[h] if with_accs else None)
           for h in range(hosts)]
    gathered = np.stack([packed for packed, _ in ops])
    assert gathered.shape[2] == DIM + with_accs
    jm = _masters(jmh, hosts, dims=[8, 4, 8])
    for h in range(hosts):
        packed, bounds = ops[h]
        out = pmh.unpack_window_rows(masters[h], bounds, gathered, with_accs=with_accs)
        rows = out[0] if with_accs else out
        for t, u in enumerate(uniques):
            np.testing.assert_array_equal(rows[t], whole.gather(t, u))
            if with_accs:
                lo_hi = [m.ranges[t] for m in masters]
                owner = np.searchsorted([hi for _, hi in lo_hi], u, side="right")
                want = u - np.array([lo_hi[o][0] for o in owner]) + 1000 * t + 0.5
                np.testing.assert_array_equal(out[1][t], want.astype(np.float32))
        # cdlrm_tpu's exchange on host h, its all-gather answered by the
        # port's operands: it hands over the same operand and returns the same
        seen = []

        def allgather(block, seen=seen):
            seen.append(np.array(block))
            return gathered

        monkeypatch.setattr(multihost_utils, "process_allgather", allgather)
        want = jmh.exchange_window_rows(jm[h], uniques, owned[h], accs[h] if with_accs else None)
        np.testing.assert_array_equal(seen[0], packed)
        for a, b in zip(want if with_accs else [want], out if with_accs else [out]):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_window_exchange_with_one_rank_is_the_identity(rng):
    uniques, (master,), (owned,), (accs,) = _window(rng, 1)
    rows = pmh.exchange_window_rows(master, uniques, owned, group=DpGroup())
    rows2, accs2 = pmh.exchange_window_rows(master, uniques, owned, accs, group=DpGroup())
    for t in range(len(LN_EMB)):
        assert rows[t] is owned[t] and rows2[t] is owned[t] and accs2[t] is accs[t]


def test_window_exchange_refuses_rows_that_disagree_with_the_bounds(rng):
    uniques, masters, owned, _ = _window(rng, 2)
    short = [r[:-1] if r.shape[0] else r for r in owned[0]]
    with pytest.raises(ValueError, match="owned window rows"):
        pmh.pack_window_rows(masters[0], uniques, short)


def test_all_gather_host_on_one_rank():
    block = np.arange(6, dtype=np.float32).reshape(2, 3)
    got = DpGroup().all_gather_host(block)
    assert got.shape == (1, 2, 3)
    np.testing.assert_array_equal(got[0], block)


# ------------------------------------------------------ accumulator store
def test_sharded_accumulator_store_refuses_rows_it_does_not_own():
    """A row-sharded store serves its owned rows only: the resume values of
    the others come with the window exchange. Port and cdlrm_tpu alike."""
    ranges = pmh.ShardedMasterTables(LN_EMB, DIM, pmh.RowShard(1, 2)).ranges
    port = AccumulatorStore(LN_EMB, owned_ranges=ranges)
    jax_ = JaxAccumulatorStore(LN_EMB, owned_ranges=ranges)
    lo, hi = ranges[1]
    for store in (port, jax_):
        store.writeback(1, np.array([0, lo, hi - 1]), np.array([9.0, 1.0, 2.0], np.float32))
        np.testing.assert_array_equal(
            store.gather(np.array([1, 1]), np.array([lo, hi - 1])), [1.0, 2.0])
        with pytest.raises(IndexError, match="outside owned range"):
            store.gather(np.array([1]), np.array([lo - 1]))
    np.testing.assert_array_equal(port.accs[1], jax_.accs[1])
    # the write of row 0, which rank 0 owns, was dropped
    assert port.accs[1].size == hi - lo and np.count_nonzero(port.accs[1]) == 2


# ------------------------------------------------------------ host fields
def test_initialize_distributed_without_a_coordinator_joins_nothing():
    import torch.distributed as dist

    assert pmh.initialize_distributed() == (0, 1)
    assert pmh.initialize_distributed("127.0.0.1:1", 1, 0) == (0, 1)
    assert not dist.is_initialized()


@pytest.mark.parametrize("kw,match", [
    (dict(num_hosts=3, host_id=-1, world=2), "must equal --world-size"),
    (dict(num_hosts=2, host_id=1, world=2, rank=0), "the host id is the rank"),
], ids=["num-hosts", "host-id"])
def test_check_hosts_refuses_fields_that_disagree_with_the_group(kw, match):
    with pytest.raises(ValueError, match=match):
        pmh.check_hosts(**kw)
    pmh.check_hosts(-1, -1, 4, 3)
    pmh.check_hosts(4, 3, 4, 3)
