"""cdlrm_tpu_torch's hot-tier update (``Config.hot_tier_rows``) against
cdlrm_tpu's, on the CPU.

The hot tier splits the sparse SGD update: the lookups of the window's hot
rows are summed into an ``[H, D]`` buffer and applied in one H-row add, the
cold lookups are compacted to the window's cold bucket and added one by one
(cdlrm_tpu/train/step.py:375-440). On CPU tensors the port's row kernels run
their plain versions, which add in lane order as XLA's CPU scatter does, so
the port's ``_hot_cold_update`` agrees with cdlrm_tpu's within 1e-6 and the
touched mask exactly, a hot list with a repeated row included. The trainers
run cdlrm_tpu's own test cases (tests/test_trainer_e2e.py:952-1031) at one
device; the caches, parameters, per-window losses and masters agree within
1e-5, the hits, hot lists and cold buckets exactly, and the port's hot run
stays within cdlrm_tpu's own tolerance of the port's baseline. Two gloo ranks
(tests/torch_dp_worker.py) hold the touched mask and the aggregate step at
N = 2, and multi-host mode with the hot tier on the pooled sorted wire, as
tests/mh_worker.py:93-115 configures its soak. A mid-window resume re-derives
the same hot lists and cold buckets, and cdlrm_tpu's refusals raise its
words.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as W
from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import Batch
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch.cache.geometry import CacheGeometry
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.models.dlrm import param_leaves
from cdlrm_tpu_torch.train import step as pstep
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
from test_torch_dp_trainer import _assert_dense_bit_equal, _assert_ranks_match_jax, _jax_trainer

TOL = dict(atol=1e-5, rtol=1e-5)
LN_EMB = np.array([60, 30, 80])
H = 16


# --------------------------------------------------------------------------
# _hot_cold_update on the same numpy inputs
# --------------------------------------------------------------------------


def _hot_inputs(seed: int, n_sel: int, dup: bool):
    """cdlrm_tpu's CPU test geometry (3 tables, 32 sets, 4 ways, 8 aux rows a
    table) and a hot list of ``n_sel`` selected way rows padded as the
    trainers pad it: the trash row last, below it rows that descend from the
    trash row. Fewer than 7 selected rows put pads past the last table's aux
    rows, on its way rows; ``dup`` selects one of those, so the sorted list
    holds it twice. The lanes: half on selected rows, a third on any row,
    the rest masked (the trash row, zero gradient)."""
    geo = CacheGeometry.build(LN_EMB, 8, 32, 4, 8)
    rng = np.random.default_rng(seed)
    trash = geo.trash_row
    npad = H - 1 - n_sel
    pads = (trash - 1 - np.arange(npad)) % trash
    ways = np.concatenate([np.arange(geo.table_offsets[t], geo.aux_base(t)) for t in range(3)])
    free = np.setdiff1d(ways, pads)
    if dup:
        on_ways = np.intersect1d(pads, ways)
        assert on_ways.size, "the pads stay inside the aux rows"
        sel = np.concatenate([on_ways[:1], rng.choice(free, n_sel - 1, replace=False)])
    else:
        sel = rng.choice(free, n_sel, replace=False)
    hot = np.sort(np.concatenate([sel, pads, [trash]])).astype(np.int32)
    assert (np.unique(hot).size < H) == dup
    n = 240
    kind = rng.random(n)
    flat = np.where(kind < 0.5, rng.choice(sel, n),
                    np.where(kind < 0.85, rng.integers(0, trash, n), trash)).astype(np.int32)
    drows = rng.normal(size=(n, 8)).astype(np.float32)
    drows[flat == trash] = 0.0
    cache = rng.normal(size=(geo.total_rows, 8)).astype(np.float32)
    touched = rng.random(geo.total_rows) < 0.1
    touched[trash] = False
    cold = int((~np.isin(flat, hot)).sum())
    return geo, hot, flat, drows, cache, touched, max(64, 1 << int(np.ceil(np.log2(cold))))


@pytest.mark.parametrize("tracked", [True, False], ids=["touched", "untracked"])
@pytest.mark.parametrize("n_sel,dup", [(12, False), (4, False), (4, True)],
                         ids=["pads-in-aux", "pads-on-ways", "repeated-row"])
def test_hot_cold_update_matches_cdlrm_tpu(tracked, n_sel, dup):
    geo, hot, flat, drows, cache, touched, k = _hot_inputs(3 + n_sel, n_sel, dup)
    lr = float(np.float32(0.3))
    jc, jt = jstep._hot_cold_update(
        jnp.asarray(cache), jnp.asarray(touched) if tracked else None, jnp.asarray(flat),
        jnp.asarray(drows), jnp.asarray(hot), jnp.float32(lr),
        jstep.StepConfig(hot_rows=H, cold_bucket=k), geo.trash_row)
    pc = torch.from_numpy(cache.copy())
    pt = torch.from_numpy(touched.astype(np.uint8)) if tracked else None
    pstep._hot_cold_update(pc, pt, torch.from_numpy(flat), torch.from_numpy(drows),
                           torch.from_numpy(hot), lr,
                           pstep.StepConfig(hot_rows=H, cold_bucket=k), geo.trash_row)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6, rtol=1e-6)
    moved = np.abs(pc.numpy() - cache).max(axis=1) > 0
    # every row a valid lane names moved, and nothing else did
    np.testing.assert_array_equal(moved, np.isin(np.arange(cache.shape[0]),
                                                 flat[flat != geo.trash_row]))
    if tracked:
        np.testing.assert_array_equal(pt.numpy().astype(bool), np.asarray(jt))
        assert (pt.numpy().astype(bool) == (touched | moved)).all()


# --------------------------------------------------------------------------
# the trainers at one device
# --------------------------------------------------------------------------


class _HotHeavy:
    """tests/test_trainer_e2e.py:964-998: half the lookups on 4 hot ids."""

    m_den = 13

    def __init__(self, pooled, num_batches=26, batch=32, seed=7):
        self.ln_emb, self.pooled = LN_EMB, pooled
        self.num_batches, self.batch, self.seed = num_batches, batch, seed

    def __len__(self):
        return self.num_batches

    def batches(self):
        rng = np.random.default_rng(self.seed)
        for _ in range(self.num_batches):
            x = rng.random((self.batch, self.m_den)).astype(np.float32)
            y = (x[:, 0] > 0.5).astype(np.float32)[:, None]
            if self.pooled:
                p = 3
                hot = rng.integers(0, 4, (self.batch, p))
                cold = np.stack([rng.integers(0, n, (self.batch, p)) for n in LN_EMB])
                pick = rng.random((3, self.batch, p)) < 0.5
                mask = rng.random((3, self.batch, p)) < 0.7
                mask[:, :, 0] = True
                yield Batch(x, np.where(pick, hot[None], cold), mask, y)
            else:
                hot = rng.integers(0, 4, self.batch)
                cold = np.stack([rng.integers(0, n, self.batch) for n in LN_EMB])
                pick = rng.random((3, self.batch)) < 0.5
                yield Batch(x, np.where(pick, hot[None], cold), None, y)


def _run(port: bool, pooled: bool, dedup: str, scan: int, hot: int, steps: int = 22):
    """test_hot_tier_matches_baseline's run at world_size=1, collected as the
    data-parallel tests collect theirs (per-window loss and print every 5
    steps), with the masters after the held writebacks."""
    cfg = W.make_cfg(Config if port else JaxConfig, LN_EMB, world_size=1, lookahead=5,
                     table_agg_freq=3, print_freq=5, scan_steps=scan, dedup_lookups=dedup,
                     hot_tier_rows=hot)
    tr = (CachedDlrmTrainer(cfg, _HotHeavy(pooled), device="cpu") if port
          else JaxTrainer(cfg, _HotHeavy(pooled)))
    try:
        tr.eviction_manager.start = lambda: None  # hold the writebacks
        out = W.train_and_collect(
            tr, steps, to_numpy=(lambda t: t.detach().cpu().numpy()) if port else np.asarray)
        if port:
            out["params"] = [p.detach().numpy() for p in param_leaves(tr.params)]
        else:
            out["params"] = [np.asarray(a)[0] for a in jax.tree_util.tree_leaves(tr.params)]
        assert tr.eviction_manager.flush()
        out["masters"] = [np.array(t) for t in tr.master.tables]
        out["written"] = tr.eviction_manager.rows_written
        return out
    finally:
        tr.close()


@pytest.mark.parametrize("pooled,dedup,scan", [
    (False, "off", 1), (False, "on", 1), (True, "off", 1), (False, "auto", 4),
])
def test_trainer_hot_tier_matches_cdlrm_tpu(pooled, dedup, scan):
    want = _run(False, pooled, dedup, scan, H)
    got = _run(True, pooled, dedup, scan, H)
    assert got["global_step"] == want["global_step"] == 22
    for key in ("hits", "lookups", "refills", "written"):
        assert got[key] == want[key], key
    np.testing.assert_array_equal(got["win_hit_rate"], want["win_hit_rate"])
    np.testing.assert_array_equal(got["win_dedup"], want["win_dedup"])
    # the hot lists and cold buckets, window by window
    np.testing.assert_array_equal(got["hot_lists"], want["hot_lists"])
    np.testing.assert_array_equal(got["cold_buckets"], want["cold_buckets"])
    assert len(got["cold_buckets"]) == got["refills"] > 1
    np.testing.assert_allclose(got["win_loss"], want["win_loss"], **TOL)
    keep = np.ones(got["cache"].shape[0], bool)
    keep[-1] = False  # the trash row's value is unspecified by contract
    np.testing.assert_allclose(got["cache"][keep], want["cache"][keep], **TOL)
    for g, w in zip(got["params"], want["params"]):
        np.testing.assert_allclose(g, w, **TOL)
    for g, w in zip(got["masters"], want["masters"]):
        np.testing.assert_allclose(g, w, **TOL)
    # every step took the hot tier: each step's key carries the cold bucket
    assert all(k.count(",") == 3 for k in got["step_keys"]), got["step_keys"]
    # the port's hot run against its own baseline, as cdlrm_tpu's test holds
    # its own (same gradient sums, another float order)
    base = _run(True, pooled, dedup, scan, 0)
    assert base["hits"] == got["hits"]
    np.testing.assert_allclose(got["cache"], base["cache"], rtol=1e-4, atol=1e-6)
    for g, b in zip(got["params"], base["params"]):
        np.testing.assert_allclose(g, b, rtol=1e-5, atol=1e-6)


def test_mid_window_resume_rederives_hot_lists(tmp_path):
    """tests/test_trainer_e2e.py:197's case (3, 16, 'sgd') for the port:
    train 18 steps (mid-window at lookahead 4, mid-block at scan 3), save,
    resume in a fresh trainer to step 38; the cache, parameters, occupancy,
    hot lists and cold buckets equal the uninterrupted run's (fully resident
    geometry: no writeback races the gathers)."""
    ln_emb = np.array([40, 25, 60])

    def trainer():
        cfg = W.make_cfg(Config, ln_emb, world_size=1, mini_batch_size=16, cache_size=64,
                         num_ways=2, lookahead=4, table_agg_freq=5, scan_steps=3,
                         hot_tier_rows=16, dedup_lookups="auto", print_freq=1000)
        ds = W.Stream(ln_emb, num_batches=50, batch=16, seed=11)
        return CachedDlrmTrainer(cfg, ds, device="cpu")

    def collect(tr, steps):
        out = W.train_and_collect(tr, steps, to_numpy=lambda t: t.detach().numpy())
        out["params"] = [p.detach().numpy() for p in param_leaves(tr.params)]
        out["occupancy"] = [o.copy() for o in tr.controller.occupancy]
        return out

    tr = trainer()
    try:
        whole = collect(tr, 38)
    finally:
        tr.close()
    tr = trainer()
    try:
        first = collect(tr, 18)
        assert tr._cursor == (0, 18)
        tr.save_checkpoint(str(tmp_path / "mid"))
    finally:
        tr.close()
    tr = trainer()
    try:
        tr.load_checkpoint(str(tmp_path / "mid"))
        rest = collect(tr, 38)
        assert tr.global_step == 38
    finally:
        tr.close()
    for a, b in zip(rest["occupancy"], whole["occupancy"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rest["cache"], whole["cache"])
    for a, b in zip(rest["params"], whole["params"]):
        np.testing.assert_array_equal(a, b)
    # the resumed run replays the cursor's window: the same list and bucket as
    # the uninterrupted run's window 5 (steps 17-20), then windows 6-10
    n_first = len(first["cold_buckets"])
    np.testing.assert_array_equal(
        np.concatenate([first["hot_lists"], rest["hot_lists"]]),
        np.concatenate([whole["hot_lists"][:n_first], whole["hot_lists"][n_first - 1:]]))
    np.testing.assert_array_equal(
        np.concatenate([first["cold_buckets"], rest["cold_buckets"]]),
        np.concatenate([whole["cold_buckets"][:n_first], whole["cold_buckets"][n_first - 1:]]))


# --------------------------------------------------------------------------
# two gloo ranks: data parallel, and multi-host mode
# --------------------------------------------------------------------------

BIG = [300, 400, 500]
MH = dict(coordinator_address="127.0.0.1:1", master_init="virtual")


def _case(steps=13, pooled=0, skew=40, **cfg):
    """A trainer case at two ranks; 13 steps end one step after an aggregate
    step, so the touched masks hold that step's marks."""
    return dict(ln_emb=BIG, cfg=dict(world_size=2, mini_batch_size=32, **cfg), steps=steps,
                stream=dict(num_batches=steps + 2, batch=32, seed=6, pooled=pooled, skew=skew))


RANK_CASES = {
    # the touched mask through the hot tier's marks and the sparse aggregate
    # step after every other step; the plain wire, then scan blocks on the
    # packed dedup wire
    "dp_hot": _case(hot_tier_rows=H, table_agg_freq=2, dedup_lookups="off"),
    "dp_hot_scan": _case(hot_tier_rows=H, table_agg_freq=3, lookahead=6, scan_steps=3,
                         dedup_lookups="on"),
    # the sorted wire's coalesced blocks
    "dp_sorted": _case(pack_wire=False, sorted_dedup_wire=True, dedup_lookups="on",
                       scan_steps=3, lookahead=6, table_agg_freq=3, steps=14),
    # multi-host, tests/mh_worker.py's soak and pooled modes in one run: scan
    # blocks, delta refill, the hot tier, pooled bags on the sorted wire
    "mh_hot_sorted": _case(pooled=3, hot_tier_rows=H, pack_wire=False, sorted_dedup_wire=True,
                           dedup_lookups="on", scan_steps=3, lookahead=6, table_agg_freq=3,
                           refill_broadcast="delta", **MH),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("hot_ranks"))
    load = W.run_ranks(2, [dict(name=k, kind="trainer", args=a) for k, a in RANK_CASES.items()],
                       out, timeout=400)
    return lambda name: [load(name, r) for r in range(2)], out


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_two_ranks_match_cdlrm_tpu(ranks, name):
    load, out_dir = ranks
    got = load(name)
    want = _jax_trainer(RANK_CASES[name], out_dir)
    _assert_ranks_match_jax(got, want)
    _assert_dense_bit_equal(got)
    cfg = RANK_CASES[name]["cfg"]
    if cfg.get("hot_tier_rows"):
        for g in got:
            # the same lists and buckets on every rank, and cdlrm_tpu's
            np.testing.assert_array_equal(g["hot_lists"], want["hot_lists"])
            np.testing.assert_array_equal(g["cold_buckets"], want["cold_buckets"])
        assert got[0]["touched"].any()
    if cfg.get("sorted_dedup_wire"):
        assert got[0]["win_dedup"].any()
    if name == "dp_sorted":
        assert "(3, True, True)" in list(got[0]["step_keys"])


# --------------------------------------------------------------------------
# cdlrm_tpu's refusals, in its words
# --------------------------------------------------------------------------


def _finalize_error(config_cls, **kw):
    with pytest.raises(ValueError) as err:
        W.make_cfg(config_cls, LN_EMB, **kw)
    return str(err.value)


@pytest.mark.parametrize("kw", [
    dict(sorted_dedup_wire=True, pack_wire=True),
    dict(hot_tier_rows=H, block_coalesced_update="on", scan_steps=3, pack_wire=False),
    dict(hot_tier_rows=H, optimizer="adagrad", dedup_lookups="on"),
], ids=["sorted-packed", "coalesce-hot", "adagrad-hot"])
def test_config_refusals_use_cdlrm_tpu_words(kw):
    assert _finalize_error(Config, **kw) == _finalize_error(JaxConfig, **kw)


@pytest.mark.parametrize("kw,words", [
    (dict(optimizer="adagrad", dedup=True),
     "optimizer='adagrad' is incompatible with the hot tier"),
    (dict(block_coalesce=True, dedup=True), "block_coalesce is incompatible with the hot tier"),
], ids=["adagrad", "coalesce"])
def test_step_refusals_use_cdlrm_tpu_words(kw, words):
    """cdlrm_tpu/train/step.py:568-569 and :583-584."""
    geo = CacheGeometry.build(LN_EMB, 8, 32, 4, 8)
    with pytest.raises(ValueError) as err:
        pstep.make_cached_train_step(geo, pstep.StepConfig(hot_rows=H, cold_bucket=64, **kw),
                                     block=3)
    assert str(err.value) == words
    with open(os.path.join(W.REPO, "cdlrm_tpu", "train", "step.py")) as f:
        assert f'"{words}"' in f.read()
