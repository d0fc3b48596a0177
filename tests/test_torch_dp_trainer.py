"""cdlrm_tpu_torch's trainers at ``world_size`` > 1 against cdlrm_tpu's, on
the CPU: N gloo ranks of the port (tests/torch_dp_worker.py), each with its
own cache replica, prefetcher and masters, beside cdlrm_tpu's one process
over N virtual CPU devices, on the same seeded stream.

Rank r's cache, touched mask and row-wise state are held against block r of
cdlrm_tpu's flat ``[N*R, ...]`` arrays, and the dense parameters, per-window
losses, hit rates, masters, AUC and checkpoints against cdlrm_tpu's, in
float32 within 1e-5 (the frameworks sum the dense math and the ranks in
different orders; nothing else differs); counts, masks and wire choices
exactly; the dense parameters are the same bits on every rank of the port.
Both packages hold their eviction threads and apply the queued writebacks at
the end (or where they are queued, for the AdaGrad master state), as the
one-device parity tests do: a live writeback races the prefetcher's master
reads in both.

Counterparts of tests/test_trainer_e2e.py:270 (strict_bias_divergence), :646
(delta matches strict), :688 (scan blocks equal single steps) and :830 (the
fallback to strict), at the world sizes those tests use.
"""

import os
import socket
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import torch_dp_worker as W
from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer as JaxFullTable
from cdlrm_tpu.train.trainer import CachedDlrmTrainer as JaxTrainer
from cdlrm_tpu_torch import cli
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.parallel.mesh import DpGroup
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

TOL = dict(atol=1e-5, rtol=1e-5)
REPO = W.REPO
BIG = [300, 400, 500]      # more ids than cache rows: refills evict
SMALL = [60, 30, 90]       # fully resident
TEST = dict(num_batches=2, batch=32, seed=9)


def _case(ln_emb=BIG, steps=13, world=2, batch=32, seed=6, pooled=0, skew=0, test=False,
          **kw):
    extra = {k: kw.pop(k) for k in ("load", "save", "more_steps", "inline") if k in kw}
    cfg = dict(world_size=world, mini_batch_size=batch, **kw)
    args = dict(ln_emb=ln_emb, cfg=cfg, steps=steps,
                stream=dict(num_batches=steps + extra.get("more_steps", 0) + 2, batch=batch,
                            seed=seed, pooled=pooled, skew=skew), **extra)
    if test:
        args["test_stream"] = dict(TEST, pooled=pooled)
    return args


SCAN = dict(ln_emb=[50, 20, 70], world=4, steps=22, lookahead=6, table_agg_freq=3,
            print_freq=5, seed=4)
CKPT = dict(table_agg_freq=4, steps=6, seed=8)
# a run that goes on after its save has prefetched windows before the save's
# flush wrote the evicted rows back, a resumed one after: bit-equal resume is
# the contract only when nothing is evicted (as for cdlrm_tpu's own resume test)
CKPT_OWN = dict(CKPT, ln_emb=SMALL, cache_size=128)
ADA = dict(optimizer="adagrad", dedup_lookups="on", learning_rate=0.05, lr_embeds=0.05)
TRAINER = {
    # one run on each wire; the sparse aggregate (freq 1) and the dense one
    "plain": _case(dedup_lookups="off", table_agg_freq=1, test=True),
    "dedup_packed": _case(dedup_lookups="on", test=True),
    "dedup_auto_pooled": _case(dedup_lookups="auto", pooled=3, skew=12, table_agg_freq=1),
    "coalesce": _case(dedup_lookups="on", pack_wire=False, scan_steps=3, lookahead=6,
                      table_agg_freq=3, skew=40, steps=14),
    "bf16_fp8": _case(dedup_lookups="on", wire_rows_bf16=True, wire_x_fp8=True),
    "md": _case(ln_emb=[50, 400, 3000], md_flag=True, test=True),
    "strict_bias": _case(strict_bias_divergence=True, steps=10),
    "op_sum_sparse": _case(table_agg_op="sum", table_agg_freq=1, learning_rate=0.05,
                           lr_embeds=0.05),
    "op_max_sparse": _case(table_agg_op="max", table_agg_freq=1),
    "op_sum_dense": _case(table_agg_op="sum", learning_rate=0.05, lr_embeds=0.05),
    "op_max_dense": _case(table_agg_op="max"),
    "bucket_given": _case(table_agg_freq=1, table_agg_bucket=100),
    "adagrad_dense": _case(**ADA),
    "adagrad_sparse": _case(table_agg_freq=1, table_agg_op="max", **ADA),
    "adagrad_master": _case(adagrad_master_state=True, inline=True, **ADA),
    "adagrad_scan": _case(scan_steps=3, lookahead=6, table_agg_freq=3, **ADA),
    # test_trainer_e2e.py:646 at its world size
    "strict4": _case(ln_emb=SMALL, world=4, batch=64, steps=24, refill_broadcast="strict"),
    "delta4": _case(ln_emb=SMALL, world=4, batch=64, steps=24, refill_broadcast="delta"),
    "delta2_evicting": _case(refill_broadcast="delta", steps=16),
    # test_trainer_e2e.py:688 at its world size
    "scan1": _case(scan_steps=1, **SCAN),
    "scan4": _case(scan_steps=4, **SCAN),
    "scan1_pooled": _case(scan_steps=1, pooled=3, **SCAN),
    "scan4_pooled": _case(scan_steps=4, pooled=3, **SCAN),
    "scan1_dedup": _case(scan_steps=1, dedup_lookups="on", **SCAN),
    "scan4_dedup": _case(scan_steps=4, dedup_lookups="on", **SCAN),
    # checkpoints: saved mid-window and between two aggregate steps
    "ck_save": _case(save="ck_port", more_steps=6, **CKPT_OWN),
    "ck_resume_port": _case(load="ck_port", **dict(CKPT_OWN, steps=12)),
    "ck_resume_jax": _case(load="ck_jax", **dict(CKPT, steps=12)),
    "cka_save": _case(save="cka_port", more_steps=6, **CKPT_OWN, **ADA),
    "cka_resume_port": _case(load="cka_port", **dict(CKPT_OWN, steps=12), **ADA),
    "cka_resume_jax": _case(load="cka_jax", **dict(CKPT, steps=12), **ADA),
}
# cdlrm_tpu runs of its own are needed only where the port is held to it
JAX_SKIP = {"scan4_pooled", "scan4_dedup", "ck_resume_port", "cka_resume_port"}

FT = dict(ln_emb=SMALL, steps=6)
FULLTABLE = {
    "ft_sgd": _case(test=True, save="ft_port", **FT),
    "ft_adagrad": _case(optimizer="adagrad", learning_rate=0.05, lr_embeds=0.05, **FT),
    "ft_pooled": _case(pooled=3, num_indices_per_lookup=3, num_indices_per_lookup_fixed=False,
                       test=True, **FT),
    "ft_qr": _case(ln_emb=[50, 400, 3000], steps=6, qr_flag=True, qr_threshold=200,
                   qr_collisions=4),
    "ft_md": _case(ln_emb=[50, 400, 3000], steps=6, md_flag=True, md_threshold=200),
    "ft_world4": _case(world=4, **FT),
}
ALL = {**TRAINER, **FULLTABLE}


def _hold(tr, inline):
    if inline:
        W.inline_writeback(tr)
    else:
        tr.eviction_manager.start = lambda: None


def _jax_trainer(args, out_dir):
    """The case through cdlrm_tpu's trainer, collected as the worker
    collects the port's."""
    cfg = W.make_cfg(JaxConfig, args["ln_emb"], **args["cfg"])
    ds = W.Stream(args["ln_emb"], **args["stream"])
    test_ds = W.Stream(args["ln_emb"], **args["test_stream"]) if "test_stream" in args else None
    tr = JaxTrainer(cfg, ds, test_ds)
    try:
        _hold(tr, args.get("inline", False))
        if args.get("load"):
            tr.load_checkpoint(os.path.join(out_dir, args["load"]))
        save = os.path.join(out_dir, args["save"] + "_by_jax") if args.get("save") else None
        out = W.train_and_collect(tr, args["steps"], evaluate=test_ds is not None,
                                  more_steps=args.get("more_steps", 0), save=save)
        out["params"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.params)]
        if tr.dense_acc is not None:
            out["dense_acc"] = [np.asarray(a) for a in jax.tree_util.tree_leaves(tr.dense_acc)]
        assert tr.eviction_manager.flush()
        if hasattr(tr.master, "tables"):
            out["masters"] = [np.asarray(t) for t in tr.master.tables]
        return out
    finally:
        tr.close()


def _jax_save(args, out_dir, name):
    """cdlrm_tpu trains the case's first steps and saves ``name``."""
    cfg = W.make_cfg(JaxConfig, args["ln_emb"], **args["cfg"])
    tr = JaxTrainer(cfg, W.Stream(args["ln_emb"], **args["stream"]))
    try:
        _hold(tr, False)
        tr.train(max_steps=6, log_fn=lambda *_: None)
        tr.save_checkpoint(os.path.join(out_dir, name))
    finally:
        tr.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case of this file through the port's ranks (one launch of two
    ranks, one of four), after cdlrm_tpu has saved the checkpoints that the
    port resumes from. Returns (ranks(name), out_dir)."""
    out = str(tmp_path_factory.mktemp("dp_trainer"))
    _jax_save(TRAINER["ck_resume_jax"], out, "ck_jax")
    _jax_save(TRAINER["cka_resume_jax"], out, "cka_jax")
    loaders = {}
    for world in (2, 4):
        cases = [dict(name=k, kind="fulltable" if k in FULLTABLE else "trainer", args=a)
                 for k, a in ALL.items() if a["cfg"]["world_size"] == world]
        loaders[world] = W.run_ranks(world, cases, out, timeout=400)

    def ranks(name):
        world = ALL[name]["cfg"]["world_size"]
        return [loaders[world](name, r) for r in range(world)]

    return ranks, out


_JAX_CACHE = {}


def _jax(name, out_dir):
    if name not in _JAX_CACHE:
        _JAX_CACHE[name] = _jax_trainer(TRAINER[name], out_dir)
    return _JAX_CACHE[name]


def _assert_ranks_match_jax(ranks, want, exact_windows=True):
    ndev = len(ranks)
    rows = ranks[0]["cache"].shape[0]
    j_cache = want["cache"].reshape(ndev, rows, -1)
    keep = np.ones(rows, bool)
    keep[-1] = False  # the trash row's value is unspecified by contract
    for r, got in enumerate(ranks):
        assert int(got["global_step"]) == want["global_step"]
        assert int(got["refills"]) == want["refills"]
        np.testing.assert_array_equal(got["cursor"], want["cursor"])
        assert (int(got["hits"]), int(got["lookups"]), int(got["table_lookups"])) == (
            want["hits"], want["lookups"], want["table_lookups"])
        np.testing.assert_array_equal(got["table_hits"], want["table_hits"])
        np.testing.assert_array_equal(got["win_dedup"], want["win_dedup"])
        np.testing.assert_array_equal(got["win_hit_rate"], want["win_hit_rate"])
        assert len(got["win_loss"]) == len(want["win_loss"]) > 0
        np.testing.assert_allclose(got["win_loss"], want["win_loss"], **TOL)
        np.testing.assert_allclose(got["win_acc"], want["win_acc"], **TOL)
        np.testing.assert_allclose(got["cache"][keep], j_cache[r][keep], **TOL)
        np.testing.assert_array_equal(got["touched"], want["touched"].reshape(ndev, rows)[r])
        if "embed_acc" in want:
            np.testing.assert_allclose(got["embed_acc"][keep],
                                       want["embed_acc"].reshape(ndev, rows)[r][keep], **TOL)
        for i, jw in enumerate(want["params"]):
            np.testing.assert_allclose(got[f"param_{i}"], jw[r], **TOL)
        for i, jw in enumerate(want.get("dense_acc", [])):
            np.testing.assert_allclose(got[f"acc_param_{i}"], jw[r], **TOL)
        for t, jm in enumerate(want.get("masters", [])):
            np.testing.assert_allclose(got[f"master_{t}"], jm, **TOL)
            # N full copies of the masters, kept equal by the broadcast
            np.testing.assert_array_equal(got[f"master_{t}"], ranks[0][f"master_{t}"])
        if "eval_auc" in want:
            assert float(got["eval_acc"]) == want["eval_acc"]
            np.testing.assert_allclose(float(got["eval_auc"]), want["eval_auc"], atol=1e-6)
            assert (int(got["eval_hits"]), int(got["eval_lookups"])) == (
                want["eval_hits"], want["eval_lookups"])


def _assert_dense_bit_equal(ranks, biases_too=True):
    n = sum(k.startswith("param_") for k in ranks[0])
    for got in ranks[1:]:
        for i in range(n):
            if biases_too or ranks[0][f"param_{i}"].ndim > 1:
                np.testing.assert_array_equal(got[f"param_{i}"], ranks[0][f"param_{i}"])


@pytest.mark.parametrize("name", [k for k in TRAINER if k not in JAX_SKIP])
def test_trainer_matches_cdlrm_tpu(runs, name):
    ranks, out_dir = runs
    got = ranks(name)
    _assert_ranks_match_jax(got, _jax(name, out_dir))
    _assert_dense_bit_equal(got, biases_too=name != "strict_bias")
    assert int(got[0]["refills"]) >= (1 if "load" in TRAINER[name] else 3)


def test_the_runs_took_the_paths_they_name(runs):
    """The sparse and the dense aggregate, the coalesced block and the
    evictions the cases are meant to drive did run."""
    ranks, _ = runs
    for name, bucket in (("plain", 128), ("op_sum_sparse", 128), ("adagrad_sparse", 128),
                         ("bucket_given", 100), ("dedup_packed", -1), ("op_max_dense", -1),
                         ("adagrad_dense", -1), ("strict4", -1)):
        assert int(ranks(name)[0]["agg_bucket"]) == bucket, name
    assert "(3, True, True)" in list(ranks("coalesce")[0]["step_keys"])
    assert "(3, True, False)" in list(ranks("adagrad_scan")[0]["step_keys"])
    # blocks of 4 are capped by the aggregate cadence of 3
    assert "(3, False, False)" in list(ranks("scan4")[0]["step_keys"])
    auto = ranks("dedup_auto_pooled")[0]
    assert auto["win_dedup"].any()  # the skewed stream took the dedup wire
    for name in ("plain", "adagrad_master", "delta2_evicting"):
        # rows were written back: a master differs from its initial values
        assert any(k.startswith("master_") for k in ranks(name)[0]), name
    # replicas differ between aggregations: the run ended one step after one
    plain = ranks("dedup_packed")
    assert plain[0]["touched"].any() and np.abs(plain[0]["cache"] - plain[1]["cache"]).max() > 0


def test_strict_bias_divergence_lets_biases_diverge(runs):
    """test_trainer_e2e.py:270: weights stay replicated, biases do not."""
    ranks, _ = runs
    a, b = ranks("strict_bias")
    n = sum(k.startswith("param_") for k in a)
    weights = [i for i in range(n) if a[f"param_{i}"].ndim > 1]
    biases = [i for i in range(n) if a[f"param_{i}"].ndim == 1]
    for i in weights:
        np.testing.assert_array_equal(a[f"param_{i}"], b[f"param_{i}"])
    assert any(np.abs(a[f"param_{i}"] - b[f"param_{i}"]).max() > 0 for i in biases)


def test_refill_delta_matches_strict(runs):
    """test_trainer_e2e.py:646: with table_agg_freq dividing lookahead every
    refill follows an aggregation, so delta's trajectory is strict's."""
    ranks, _ = runs
    for s, d in zip(ranks("strict4"), ranks("delta4")):
        np.testing.assert_allclose(d["win_loss"], s["win_loss"], rtol=1e-6)
        np.testing.assert_allclose(d["cache"][:-1], s["cache"][:-1], rtol=1e-6, atol=1e-7)
        for k in s:
            if k.startswith("param_"):
                np.testing.assert_allclose(d[k], s[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("variant", ["", "_pooled", "_dedup"])
def test_scan_block_matches_single_step(runs, variant):
    """test_trainer_e2e.py:688 at four ranks: blocks of 4 (which divide
    neither the lookahead of 6 nor the aggregate cadence of 3) are capped at
    every boundary and train step for step what single steps train."""
    ranks, _ = runs
    for base, scan in zip(ranks("scan1" + variant), ranks("scan4" + variant)):
        assert int(base["global_step"]) == int(scan["global_step"]) == 22
        np.testing.assert_array_equal(base["cursor"], scan["cursor"])
        assert (int(base["hits"]), int(base["lookups"])) == (int(scan["hits"]),
                                                            int(scan["lookups"]))
        np.testing.assert_allclose(scan["win_loss"], base["win_loss"], rtol=1e-5)
        np.testing.assert_allclose(scan["cache"][:-1], base["cache"][:-1], rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(scan["touched"], base["touched"])
        for k in base:
            if k.startswith("param_"):
                np.testing.assert_allclose(scan[k], base[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("prefix", ["ck", "cka"])
def test_checkpoint_written_by_the_port_at_two_ranks(runs, prefix):
    """One file set in cdlrm_tpu's format: the ranks' cache, mask and state
    blocks in rank order, a real touched mask; a fresh pair of ranks resumes
    it bit-equal to the run that went on, and cdlrm_tpu loads it and goes on
    alike."""
    ranks, out_dir = runs
    ck = os.path.join(out_dir, prefix + "_port")
    saved = ranks(prefix + "_save")
    rows = saved[0]["cache"].shape[0]
    cache = np.load(os.path.join(ck, "cache.npy"))
    touched = np.load(os.path.join(ck, "touched.npy"))
    assert cache.shape == (2 * rows, 8) and touched.shape == (2 * rows,)
    assert touched.dtype == bool and touched[:rows].any() and touched[rows:].any()
    assert (touched[:rows] != touched[rows:]).any()  # each rank's own mask
    assert os.path.exists(os.path.join(ck, "embed_acc.npy")) == (prefix == "cka")
    if prefix == "cka":
        assert np.load(os.path.join(ck, "embed_acc.npy")).shape == (2 * rows,)
    resumed = ranks(prefix + "_resume_port")
    for a, b in zip(saved, resumed):
        for k in ("cache", "touched", "cursor", "global_step") + tuple(
                k for k in a if k.startswith(("param_", "acc_param_", "embed_acc"))):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # cdlrm_tpu at world_size=2 loads the port's files and continues
    args = dict(TRAINER[prefix + "_resume_port"])
    want = _jax_trainer(args, out_dir)
    _assert_ranks_match_jax(resumed, want)


@pytest.mark.parametrize("prefix", ["ck", "cka"])
def test_checkpoint_written_by_cdlrm_tpu_resumes_on_two_ranks(runs, prefix):
    """A world_size=2 checkpoint of cdlrm_tpu: rank r takes block r, and both
    packages continue alike from the saved cursor."""
    ranks, out_dir = runs
    got = ranks(prefix + "_resume_jax")
    assert int(got[0]["global_step"]) == 12
    _assert_ranks_match_jax(got, _jax(prefix + "_resume_jax", out_dir))


def _ft_losses(lines):
    return [tuple(float(v) for v in re.search(r"loss ([\d.]+), acc ([\d.]+)", s).groups())
            for s in lines]


@pytest.mark.parametrize("name", list(FULLTABLE))
def test_fulltable_matches_cdlrm_tpu(runs, name):
    """Fully synchronous data parallelism: dense and embedding gradients are
    averaged, so every rank's replica equals cdlrm_tpu's and the others'."""
    ranks, out_dir = runs
    args = FULLTABLE[name]
    cfg = W.make_cfg(JaxConfig, args["ln_emb"], use_cache=False, **args["cfg"])
    ds = W.Stream(args["ln_emb"], **args["stream"])
    test_ds = W.Stream(args["ln_emb"], **args["test_stream"]) if "test_stream" in args else None
    tr = JaxFullTable(cfg, ds, test_ds)
    lines = []
    tr.train(max_steps=args["steps"], log_fn=lines.append)
    params = jstep.unreplicate(tr.params)
    dense = jax.tree_util.tree_leaves({"bot": params["bot"], "top": params["top"]})
    emb = jax.tree_util.tree_leaves(params["emb"])
    got = ranks(name)
    for g in got:
        assert int(g["global_step"]) == args["steps"]
        for i, w in enumerate(dense):
            np.testing.assert_allclose(g[f"param_{i}"], w, **TOL)
            np.testing.assert_array_equal(g[f"param_{i}"], got[0][f"param_{i}"])
        for i, w in enumerate(emb):
            np.testing.assert_allclose(g[f"emb_{i}"], w, **TOL)
            np.testing.assert_array_equal(g[f"emb_{i}"], got[0][f"emb_{i}"])
        if tr.accum is not None:
            for i, a in enumerate(jstep.unreplicate(tr.accum)["emb"]):
                np.testing.assert_allclose(g[f"embacc_{i}"], a, **TOL)
    np.testing.assert_allclose(_ft_losses(got[0]["lines"]), _ft_losses(lines), **TOL)
    assert len(lines) > 0 and len(got[1]["lines"]) == 0  # rank 0 alone prints
    if test_ds is not None:
        acc, auc = tr.evaluate(log_fn=lambda *_: None)
        for g in got:
            assert float(g["eval_acc"]) == acc
            np.testing.assert_allclose(float(g["eval_auc"]), auc, atol=1e-6)
    if args.get("save"):
        # rank 0's files load into cdlrm_tpu at the same world size
        tr2 = JaxFullTable(cfg, ds, test_ds)
        tr2.load_checkpoint(os.path.join(out_dir, args["save"]))
        assert tr2.global_step == args["steps"]
        for w, g in zip(jax.tree_util.tree_leaves(jstep.unreplicate(tr2.params)["emb"]),
                        (got[0][f"emb_{i}"] for i in range(len(emb)))):
            np.testing.assert_array_equal(np.asarray(w), g)


# --------------------------------------------------------------------------
# refusals and the CLI, in this process
# --------------------------------------------------------------------------


def _ds():
    return W.Stream(SMALL, num_batches=2, batch=32)


def test_delta_with_nondividing_agg_freq_falls_back_to_strict():
    """test_trainer_e2e.py:830 for the port's Config."""
    with pytest.warns(UserWarning, match="falling back to 'strict'"):
        cfg = W.make_cfg(Config, SMALL, refill_broadcast="delta", table_agg_freq=3, lookahead=4)
    assert cfg.refill_broadcast == "strict"
    assert W.make_cfg(Config, SMALL, refill_broadcast="delta").refill_broadcast == "delta"


def test_refill_broadcast_off_is_refused_above_one_rank():
    cfg = W.make_cfg(Config, SMALL, refill_broadcast="off")
    with pytest.raises(ValueError, match=r"requires refill_broadcast='strict' or 'delta' "
                                         r"\(evicted-row broadcast\)"):
        CachedDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(0, 2))
    # one replica needs no broadcast
    cfg = W.make_cfg(Config, SMALL, refill_broadcast="off", world_size=1)
    CachedDlrmTrainer(cfg, _ds(), device="cpu").close()


def test_undersized_table_agg_bucket_is_refused():
    """cdlrm_tpu's error (trainer.py:558-568): a bucket below the exact
    union bound would drop touched rows."""
    cfg = W.make_cfg(Config, SMALL, table_agg_freq=1, table_agg_bucket=64)
    with pytest.raises(ValueError, match="--table-agg-bucket 64 is below the exact "
                                         "touched-union bound 96"):
        CachedDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(0, 2))
    want = None
    try:
        JaxTrainer(W.make_cfg(JaxConfig, SMALL, table_agg_freq=1, table_agg_bucket=64), _ds())
    except ValueError as e:
        want = str(e)
    with pytest.raises(ValueError) as got:
        CachedDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(0, 2))
    assert str(got.value) == want


@pytest.mark.parametrize("cls", [CachedDlrmTrainer, FullTableDlrmTrainer])
def test_world_size_needs_a_joined_group(cls):
    """world_size=2 builds only inside a process group of two ranks."""
    cfg = W.make_cfg(Config, SMALL, use_cache=cls is CachedDlrmTrainer)
    with pytest.raises(ValueError, match="one process per device"):
        cls(cfg, _ds(), device="cpu")
    with pytest.raises(ValueError, match="the group has 4 ranks, config world_size=2"):
        cls(cfg, _ds(), device="cpu", group=DpGroup(0, 4))


def test_checkpoint_load_names_both_world_sizes(tmp_path):
    """A world_size=1 checkpoint does not load into a rank of two."""
    one = CachedDlrmTrainer(W.make_cfg(Config, SMALL, world_size=1, aux_capacity=32), _ds(),
                            device="cpu")
    try:
        one.save_checkpoint(str(tmp_path / "ck"))
        assert not np.load(tmp_path / "ck" / "touched.npy").any()
    finally:
        one.close()
    # the aux region follows the local batch: give both the same geometry
    cfg = W.make_cfg(Config, SMALL, aux_capacity=32)
    two = CachedDlrmTrainer(cfg, _ds(), device="cpu", group=DpGroup(1, 2))
    try:
        assert two.cache.shape == one.cache.shape
        with pytest.raises(ValueError, match="saved with world_size=1, this run has world_size=2"):
            two.load_checkpoint(str(tmp_path / "ck"))
    finally:
        two.close()


def test_cli_refuses_cuda_with_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match=r"--world-size 2: one CUDA device per rank is "
                                           r"needed, 1 available"):
        cli.main(["--device", "cuda", "--world-size", "2", "--arch-embedding-size", "100-200",
                  "--arch-sparse-feature-size", "2"])


_CLI = ("--device", "cpu", "--world-size", "2", "--data-generation", "random",
        "--arch-embedding-size", "1000-500-2000", "--arch-sparse-feature-size", "16",
        "--arch-mlp-bot", "13-32-16", "--arch-mlp-top", "16-8-1", "--mini-batch-size", "64",
        "--num-batches", "8", "--cache-size", "128", "--num-ways", "4", "--loss-function",
        "bce", "--round-targets", "--lookahead", "4", "--print-freq", "4")


def _cli(*extra):
    return subprocess.run(
        [sys.executable, "-m", "cdlrm_tpu_torch.cli", *_CLI, *extra], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240,
    )


@pytest.mark.parametrize("extra,want", [
    (("--refill-broadcast", "delta"), "Step 8:"),
    (("--no-use-cache",), "Epoch 0: 4/8"),
], ids=["cached", "fulltable"])
def test_cli_spawns_two_ranks(tmp_path, extra, want):
    """The CLI spawns the ranks itself; rank 0 alone prints and saves."""
    res = _cli(*extra, "--save-model", str(tmp_path / "ck"), "--metrics-log",
               str(tmp_path / "log.jsonl"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.count(want) == 1 and res.stdout.count("Test accuracy") == 1
    assert os.path.exists(tmp_path / "ck" / "meta.pkl")
    if "--no-use-cache" not in extra:
        rows = np.load(tmp_path / "ck" / "cache.npy").shape[0]
        assert np.load(tmp_path / "ck" / "touched.npy").shape == (rows,) and rows % 2 == 0
        with open(tmp_path / "log.jsonl") as f:
            assert sum('"train_window"' in line for line in f) == 2


def test_cli_fails_when_a_rank_fails(tmp_path):
    """A rank that raises takes the whole run down with a non-zero code."""
    res = _cli("--load-model", str(tmp_path / "no_such_checkpoint"))
    assert res.returncode != 0
    assert "no_such_checkpoint" in res.stderr


def test_cli_rank_reports_its_own_error_under_a_launcher(tmp_path):
    """Two ranks started as a launcher starts them (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), of which only rank 1
    raises, after joining the group: its stderr shows its own error, written
    before it left the group, and rank 0, which waits for it in a
    collective, fails too."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    extra = [(), ("--load-model", str(tmp_path / "no_such_checkpoint"))]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cdlrm_tpu_torch.cli", *_CLI, *extra[r]], cwd=REPO,
        env=dict(env, RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    err1 = outs[1][1]
    assert procs[1].returncode != 0 and procs[0].returncode != 0, outs
    report = err1.index("rank 1 failed at ")
    assert "no_such_checkpoint" in err1[:report], err1
    assert "Connection closed" not in err1[:report], err1
