"""QR and mixed-dimension (MD) tables in cdlrm_tpu_torch against
cdlrm_tpu's: the lookups (tests/test_tricks.py:13-36), the full-table trainer
with ``--qr-flag`` (mult, add, concat) and ``--md-flag``, its checkpoints
across packages, and the CLI runs of tests/test_cli.py:90, :117, :142 on
``--device cpu``.

One generator draws the dense weights and then, per table, ``weight_q`` then
``weight_r`` (QR), ``weight`` then the xavier ``proj`` (MD) or the plain
table, in cdlrm_tpu's order: the two packages start bit-equal. Training agrees
within 1e-5 in float32: cdlrm_tpu applies ``w - lr * g`` to a dense gradient
per tensor, the port the same to a compressed table's tensors and the
distinct-row update to the plain tables; only the dense math's summation
order differs.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu.data.synthetic import SyntheticDataset
from cdlrm_tpu.models import tricks as jtricks
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu.train.fulltable import FullTableDlrmTrainer as JaxFullTable
from cdlrm_tpu_torch import cli
from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.models import embedding as pemb
from cdlrm_tpu_torch.models import tricks as ptricks
from cdlrm_tpu_torch.models.dlrm import params_to_jax
from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer
from cdlrm_tpu_torch.utils.profiling import TRACE_FILE

TOL = dict(atol=1e-5, rtol=1e-5)
LN_EMB = np.array([500, 200, 800])  # thresholds of 300 leave the middle table plain


def _cfg(port: bool, pooled=1, **kw):
    base = dict(
        arch_sparse_feature_size=8, arch_mlp_bot="13-16-8", arch_mlp_top="8-1",
        mini_batch_size=32, world_size=1, loss_function="bce", print_freq=4,
        round_targets=True, use_cache=False, learning_rate=0.1, lr_embeds=0.3,
        num_indices_per_lookup=pooled, num_indices_per_lookup_fixed=pooled == 1,
    )
    base.update(kw)
    return (Config if port else JaxConfig)(**base).finalize(ln_emb=LN_EMB)


def _ds(seed, batches, pooled=1, extra=0):
    return SyntheticDataset(m_den=13, ln_emb=LN_EMB, data_size=32 * batches + extra,
                            mini_batch_size=32, seed=seed, round_targets=True,
                            num_indices_per_lookup=pooled,
                            num_indices_per_lookup_fixed=pooled == 1)


def _jax_emb(emb) -> list:
    """cdlrm_tpu's ``params["emb"]`` as numpy arrays and plain dicts (never
    its dataclasses): what ``emb_from_jax`` takes."""
    out = []
    for e in emb:
        if isinstance(e, jtricks.QRParams):
            out.append(dict(weight_q=np.asarray(e.weight_q), weight_r=np.asarray(e.weight_r),
                            num_collisions=e.num_collisions, operation=e.operation))
        elif isinstance(e, jtricks.MDParams):
            out.append(dict(weight=np.asarray(e.weight),
                            proj=None if e.proj is None else np.asarray(e.proj)))
        else:
            out.append(np.asarray(e))
    return out


def _assert_emb_close(port_emb: list, jax_emb: list, **tol):
    """Two lists in ``emb_to_jax``'s form."""
    assert len(port_emb) == len(jax_emb)
    for p, j in zip(port_emb, jax_emb):
        assert type(p) is type(j)
        if not isinstance(p, dict):
            np.testing.assert_allclose(p, j, **tol)
            continue
        assert list(p) == list(j)
        for key in p:
            if isinstance(p[key], np.ndarray):
                np.testing.assert_allclose(p[key], j[key], err_msg=key, **tol)
            else:
                assert p[key] == j[key], key


def _assert_state_close(ptr, jtr, **tol):
    jp = jstep.unreplicate(jtr.params)
    for key in ("bot", "top"):
        for (jw, jb), (pw, pb) in zip(jp[key], ptr.params[key]):
            np.testing.assert_allclose(pw.numpy(), np.asarray(jw), **tol)
            np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **tol)
    _assert_emb_close(pemb.emb_to_jax(ptr.emb_tables()), _jax_emb(jp["emb"]), **tol)


# ------------------------------------------------------------------ lookups


@pytest.mark.parametrize("op", ["mult", "add", "concat"])
def test_qr_lookup_matches_cdlrm_tpu(op):
    n, d, c = 100, 8, 4
    jp = jtricks.init_qr_embedding(np.random.default_rng(0), n, d, c, operation=op)
    pp = ptricks.init_qr_embedding(np.random.default_rng(0), n, d, c, operation=op)
    np.testing.assert_array_equal(pp.weight_q.numpy(), np.asarray(jp.weight_q))
    np.testing.assert_array_equal(pp.weight_r.numpy(), np.asarray(jp.weight_r))
    assert tuple(pp.weight_q.shape) == (25, 8) and tuple(pp.weight_r.shape) == (4, 8)
    for idx in (np.array([0, 5, 99, 42]), np.array([[3, 3, 98], [17, 0, 64]])):
        got = ptricks.qr_lookup(pp, torch.from_numpy(idx)).numpy()
        want = np.asarray(jtricks.qr_lookup(jp, jnp.asarray(idx)))
        assert got.shape == want.shape == idx.shape + ((2 * d,) if op == "concat" else (d,))
        np.testing.assert_allclose(got, want, rtol=1e-6)
        wq, wr = pp.weight_q.numpy()[idx // c], pp.weight_r.numpy()[idx % c]
        by_hand = {"mult": wq * wr, "add": wq + wr, "concat": np.concatenate([wq, wr], -1)}[op]
        np.testing.assert_allclose(got, by_hand, rtol=1e-6)
    with pytest.raises(ValueError, match="concat|mult|add"):
        ptricks.init_qr_embedding(np.random.default_rng(0), n, d, c, operation="max")


def test_qr_table_sizes_round_up():
    p = ptricks.init_qr_embedding(np.random.default_rng(0), 103, 8, 4)
    assert tuple(p.weight_q.shape) == (26, 8) and tuple(p.weight_r.shape) == (4, 8)


def test_md_lookup_matches_cdlrm_tpu():
    jp = jtricks.init_md_embedding(np.random.default_rng(0), 50, 4, base_dim=16)
    pp = ptricks.init_md_embedding(np.random.default_rng(0), 50, 4, base_dim=16)
    np.testing.assert_array_equal(pp.weight.numpy(), np.asarray(jp.weight))
    np.testing.assert_array_equal(pp.proj.numpy(), np.asarray(jp.proj))
    for idx in (np.array([1, 2]), np.array([[1, 49], [0, 0]])):
        got = ptricks.md_lookup(pp, torch.from_numpy(idx)).numpy()
        assert got.shape == idx.shape + (16,)
        np.testing.assert_allclose(got, np.asarray(jtricks.md_lookup(jp, jnp.asarray(idx))),
                                   rtol=1e-5)
        np.testing.assert_allclose(got, pp.weight.numpy()[idx] @ pp.proj.numpy(), rtol=1e-5)
    # equal widths: no projection, in both
    p2 = ptricks.init_md_embedding(np.random.default_rng(0), 50, 16, base_dim=16)
    assert p2.proj is None and jtricks.init_md_embedding(
        np.random.default_rng(0), 50, 16, base_dim=16).proj is None
    assert ptricks.md_lookup(p2, torch.tensor([3])).shape == (1, 16)
    with pytest.raises(ValueError, match="> base dim"):
        ptricks.init_md_embedding(np.random.default_rng(0), 50, 32, base_dim=16)


def test_lookup_gradients_are_dense_table_gradients():
    """The gather's backward accumulates the dense [n, d] gradient that
    cdlrm_tpu's VJP builds, duplicates summed."""
    p = ptricks.init_qr_embedding(np.random.default_rng(0), 20, 4, 4, operation="add")
    p = p.with_leaves([w.requires_grad_() for w in p.leaves()])
    idx = torch.tensor([0, 5, 5, 19])
    ptricks.qr_lookup(p, idx).sum().backward()
    want_q = np.zeros((5, 4), np.float32)
    np.add.at(want_q, idx.numpy() // 4, 1.0)
    np.testing.assert_array_equal(p.weight_q.grad.numpy(), want_q)
    want_r = np.zeros((4, 4), np.float32)
    np.add.at(want_r, idx.numpy() % 4, 1.0)
    np.testing.assert_array_equal(p.weight_r.grad.numpy(), want_r)


# ------------------------------------------------- tables across packages


FLAGS = {
    "qr-mult": dict(qr_flag=True, qr_threshold=300, qr_collisions=4, qr_operation="mult"),
    "qr-add": dict(qr_flag=True, qr_threshold=300, qr_collisions=4, qr_operation="add"),
    # concat doubles the width, so every table must be a QR table
    "qr-concat": dict(qr_flag=True, qr_threshold=100, qr_collisions=4, qr_operation="concat",
                      arch_sparse_feature_size=4),
    "md": dict(md_flag=True, md_threshold=300, md_temperature=0.5),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_emb_tables_round_trip_across_packages(flags):
    """``emb_from_jax`` / ``emb_to_jax`` carry cdlrm_tpu's ``params["emb"]``
    list (plain arrays, QR and MD entries as plain dicts or tuples) into the
    port's per-table list and back, bit for bit."""
    jtr = JaxFullTable(_cfg(False, **FLAGS[flags]), _ds(3, 2))
    src = _jax_emb(jstep.unreplicate(jtr.params)["emb"])
    kinds = pemb.table_kinds(LN_EMB, **{k: v for k, v in FLAGS[flags].items()
                                        if k in ("qr_flag", "qr_threshold", "md_flag",
                                                 "md_threshold")})
    assert [("qr" if isinstance(e, dict) and "weight_q" in e else
             "md" if isinstance(e, dict) else "plain") for e in src] == kinds
    back = pemb.emb_to_jax(pemb.emb_from_jax(src))
    _assert_emb_close(back, src, atol=0, rtol=0)
    as_tuples = [tuple(e.values()) if isinstance(e, dict) else e for e in src]
    _assert_emb_close(pemb.emb_to_jax(pemb.emb_from_jax(as_tuples)), src, atol=0, rtol=0)


@pytest.mark.parametrize("pooled", [1, 3])
@pytest.mark.parametrize("flags", sorted(FLAGS))
def test_fulltable_tricks_train_like_cdlrm_tpu(flags, pooled):
    ds, test_ds = _ds(3, 12, pooled), _ds(9, 3, pooled, extra=7)
    jtr = JaxFullTable(_cfg(False, pooled, **FLAGS[flags]), ds, test_ds)
    ptr = FullTableDlrmTrainer(_cfg(True, pooled, **FLAGS[flags]), ds, test_ds, device="cpu")
    _assert_state_close(ptr, jtr, atol=0, rtol=0)  # the same draws
    compressed = [e for e in ptr.emb_entries if e is not None]
    assert compressed and ptr.tables.shape[0] == sum(
        int(n) for n, e in zip(LN_EMB, ptr.emb_entries) if e is None)
    if flags == "md":
        assert any(e.proj is not None for e in compressed)
    before = [w.clone() for e in compressed for w in e.leaves()]
    j_lines, p_lines = [], []
    jtr.train(max_steps=10, log_fn=j_lines.append)
    ptr.train(max_steps=10, log_fn=p_lines.append)
    assert jtr.global_step == ptr.global_step == 10
    assert [line.split("ms/it")[1] for line in p_lines] == [
        line.split("ms/it")[1] for line in j_lines]  # loss and accuracy, 5 digits
    _assert_state_close(ptr, jtr, **TOL)
    after = [w for e in compressed for w in e.leaves()]
    assert all(not torch.equal(a, b) for a, b in zip(after, before))  # every tensor trained
    j_acc, j_auc = jtr.evaluate(log_fn=lambda *_: None)
    p_acc, p_auc = ptr.evaluate(log_fn=lambda *_: None)
    assert p_acc == j_acc and abs(p_auc - j_auc) <= 1e-6


@pytest.mark.parametrize("flags", ["qr-mult", "qr-concat", "md"])
def test_fulltable_tricks_checkpoints_cross_packages(tmp_path, flags):
    """Each package's save loads into the other's trainer bit for bit
    (``fulltable_params.npz``: the bottom MLP, then per table ``weight_q,
    weight_r`` or ``weight[, proj]`` or the plain table, then the top MLP),
    and from the port's save both train on alike within 1e-5."""
    ds = _ds(4, 10)
    kw = FLAGS[flags]

    def leaves(tr):
        if isinstance(tr, FullTableDlrmTrainer):
            return params_to_jax({**tr.params, "emb": pemb.emb_leaves(tr.emb_tables())})
        import jax

        return [np.asarray(a) for a in jax.tree_util.tree_leaves(jstep.unreplicate(tr.params))]

    ptr = FullTableDlrmTrainer(_cfg(True, **kw), ds, device="cpu")
    ptr.train(max_steps=5, log_fn=lambda *_: None)
    ptr.save_checkpoint(str(tmp_path / "port"))
    saved = leaves(ptr)
    with np.load(str(tmp_path / "port" / "fulltable_params.npz")) as data:
        assert len(data.files) == len(saved)
    jtr = JaxFullTable(_cfg(False, numpy_rand_seed=9, **kw), ds)
    jtr.load_checkpoint(str(tmp_path / "port"))
    ptr = FullTableDlrmTrainer(_cfg(True, numpy_rand_seed=9, **kw), ds, device="cpu")
    ptr.load_checkpoint(str(tmp_path / "port"))
    assert jtr.global_step == ptr.global_step == 5
    assert len(leaves(jtr)) == len(leaves(ptr)) == len(saved)
    for a, b, c in zip(leaves(jtr), leaves(ptr), saved):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    jtr.train(max_steps=9, log_fn=lambda *_: None)
    ptr.train(max_steps=9, log_fn=lambda *_: None)
    for a, b in zip(leaves(jtr), leaves(ptr)):
        np.testing.assert_allclose(b, a, **TOL)
    # cdlrm_tpu writes, the port loads
    jtr.save_checkpoint(str(tmp_path / "jax"))
    fresh = FullTableDlrmTrainer(_cfg(True, **kw), ds, device="cpu")
    fresh.load_checkpoint(str(tmp_path / "jax"))
    assert fresh.global_step == 9
    for a, b in zip(leaves(jtr), leaves(fresh)):
        np.testing.assert_array_equal(b, a)
    # a model of another shape refuses the file
    high = {k: 10 ** 6 for k in ("qr_threshold", "md_threshold") if k in kw}
    plain = FullTableDlrmTrainer(_cfg(True, **{**kw, **high}), ds, device="cpu")
    assert all(e is None for e in plain.emb_entries)
    with pytest.raises(ValueError, match="leaves|checkpoint table"):
        plain.load_checkpoint(str(tmp_path / "jax"))


def test_tricks_with_adagrad_are_refused():
    """Config.finalize refuses it in both packages; the step does too."""
    from cdlrm_tpu_torch.train import step as tstep

    with pytest.raises(ValueError, match="plain embeddings only"):
        _cfg(True, optimizer="adagrad", **FLAGS["qr-mult"])
    ptr = FullTableDlrmTrainer(_cfg(True, **FLAGS["qr-mult"]), _ds(3, 2), device="cpu")
    step = tstep.make_fulltable_train_step(ptr.step_cfg._replace(optimizer="adagrad"))
    x, ls_i, mask, tgt = ptr._put(next(iter(_ds(3, 2).batches())))
    with pytest.raises(ValueError, match="plain embeddings only"):
        step(ptr.params, ptr.tables, ptr._offsets, x, ls_i, mask, tgt, None, None, 0.1, 0.1,
             entries=ptr.emb_entries)


# ---------------------------------------------------------------------- CLI


_CLI = [
    "--device", "cpu", "--data-generation", "random",
    "--arch-embedding-size", "500-200-800", "--arch-sparse-feature-size", "8",
    "--arch-mlp-bot", "13-16-8", "--arch-mlp-top", "8-1", "--mini-batch-size", "32",
    "--num-batches", "8", "--data-size", "256", "--loss-function", "bce",
    "--print-freq", "4", "--round-targets",
]


@pytest.mark.parametrize("extra,want", [
    (["--no-use-cache", "--qr-flag", "--qr-threshold", "300", "--qr-collisions", "4",
      "--num-indices-per-lookup", "1", "--num-indices-per-lookup-fixed"], "Epoch 0: 4/8"),
    (["--no-use-cache", "--md-flag", "--md-threshold", "300",
      "--num-indices-per-lookup", "3"], "Epoch 0: 4/8"),
    (["--md-flag", "--cache-size", "32", "--num-ways", "2", "--lookahead", "2",
      "--num-indices-per-lookup", "1", "--num-indices-per-lookup-fixed"], "Step 8:"),
    (["--wire-rows-bf16", "--wire-x-fp8", "--cache-size", "32", "--num-ways", "2",
      "--lookahead", "2", "--dedup-lookups", "on",
      "--num-indices-per-lookup", "1", "--num-indices-per-lookup-fixed"], "Step 8:"),
], ids=["fulltable-qr", "fulltable-md-multihot", "cached-md", "byte-lean-wires"])
def test_cli_runs_the_variants(capsys, extra, want):
    """tests/test_cli.py:90 and :117 on the port, and the cached variants."""
    assert cli.main(_CLI + extra) == 0
    out = capsys.readouterr().out
    assert want in out and "Test accuracy" in out


def test_cli_nepochs_and_profiling(tmp_path, capsys):
    """tests/test_cli.py:142 on the port: a multi-epoch stream under
    ``--enable-profiling`` leaves a Chrome trace in ``--profile-dir`` that
    holds the training's operators, the host threads' included."""
    trace_dir = str(tmp_path / "trace")
    rc = cli.main([
        "--device", "cpu", "--data-generation", "random", "--arch-embedding-size", "300-150",
        "--arch-sparse-feature-size", "8", "--arch-mlp-bot", "13-16-8", "--arch-mlp-top", "8-1",
        "--mini-batch-size", "32", "--data-size", "192", "--nepochs", "3", "--cache-size", "64",
        "--num-ways", "2", "--loss-function", "bce", "--lookahead", "3", "--print-freq", "6",
        "--num-indices-per-lookup", "1", "--num-indices-per-lookup-fixed", "--round-targets",
        "--enable-profiling", "--profile-dir", trace_dir,
    ])
    assert rc == 0
    assert "Step 18" in capsys.readouterr().out  # 3 epochs x 6 batches all trained
    path = os.path.join(trace_dir, TRACE_FILE)
    assert os.path.getsize(path) > 0
    with open(path) as f:
        names = {ev.get("name", "") for ev in json.load(f)["traceEvents"]}
    assert any("index_select" in n for n in names), "no row gather in the trace"
    assert any("addmm" in n or "mm" in n for n in names)


def test_cli_fulltable_profiling(tmp_path, capsys):
    trace_dir = str(tmp_path / "trace")
    assert cli.main(_CLI + ["--no-use-cache", "--enable-profiling", "--profile-dir",
                            trace_dir]) == 0
    assert "Test accuracy" in capsys.readouterr().out
    assert os.path.getsize(os.path.join(trace_dir, TRACE_FILE)) > 0
