"""The copied id streams against bench_torch.ZipfDataset, and the stream's
end at its deadline."""

import time

import numpy as np
import pytest

from perfbench import streams


@pytest.mark.parametrize("kind", ["loguniform", "uniform"])
def test_the_copied_stream_draws_what_zipfdataset_draws(kind):
    import bench_torch

    ln_emb = np.full(5, 250_000, dtype=np.int64)
    ids = {"kind": kind}
    old = list(bench_torch.ZipfDataset(ln_emb, 256, 4, kind, seed=2**31 + 5).batches())
    new = streams.Stream(ln_emb, 256, ids, 2**31 + 5, pool_examples=4 * 256).head(4)
    for a, b in zip(old, new):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.ls_i, b.ls_i)
        np.testing.assert_array_equal(a.y, b.y)
        assert b.ls_mask is None


@pytest.mark.parametrize("kind", ["loguniform", "uniform"])
def test_each_table_draws_within_its_own_rows(kind):
    ln_emb = np.array([3, 10, 40_000_000, 155], dtype=np.int64)
    b = streams.Stream(ln_emb, 4096, {"kind": kind}, 7, pool_examples=4096).head(1)[0]
    assert b.ls_i.dtype == np.int64
    for t, n in enumerate(ln_emb):
        assert b.ls_i[t].min() >= 0 and b.ls_i[t].max() < n
    assert b.ls_i[2].max() > 1000  # the big table is not cut to the first's size


def test_batches_are_restartable_and_the_same_on_every_pass():
    s = streams.Stream([100, 2000], 32, {"kind": "loguniform"}, 3, limit=5, pool_examples=1 << 20)
    a = [b.ls_i for b in s.batches()]
    c = [b.ls_i for b in s.batches()]
    assert len(a) == 5 and len(s.pool) == 5
    for x, y in zip(a, c):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(list(s.batches(skip=2))[0].ls_i, a[2])


def test_the_pool_is_served_again_from_its_start():
    s = streams.Stream([100, 2000], 32, {"kind": "uniform"}, 3, pool_examples=3 * 32)
    out = []
    for b in s.batches():
        out.append(b)
        if len(out) == 7:
            break
    assert out[3] is out[0] and out[6] is out[0]


def test_a_stream_that_does_not_wrap_ends_with_its_pool():
    s = streams.Stream([100, 2000], 32, {"kind": "uniform"}, 3, pool_examples=3 * 32, wrap=False)
    assert len(list(s.batches())) == 3


def test_the_stream_ends_on_an_aligned_batch_after_its_deadline():
    dl = streams.Deadline()
    s = streams.Stream([100, 2000], 32, {"kind": "uniform"}, 3, deadline=dl, align=7,
                       pool_examples=32 * 50)
    n = 0
    for b in s.batches():
        n += 1
        if n == 3:
            dl.start(0.0)
            time.sleep(0.01)
    assert n == 7
