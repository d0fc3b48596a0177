"""cdlrm_tpu_torch dense model against cdlrm_tpu's, on the same seeded numpy
inputs and weights.

Tolerances: float32 runs match to atol/rtol 1e-5 (the two frameworks sum in
different orders). With compute_dtype bfloat16 both round the same operands
to bf16 and sum in float32, but a last-bit difference in a float32 activation
can round it to a neighbouring bf16 value (a relative step of 2^-8) before
the next layer. The largest gap measured on these inputs is 1.9e-6; the bound
is 5e-3, one such step on values of order 1."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import jax.tree_util as jtu

from cdlrm_tpu.models import dlrm as jdlrm
from cdlrm_tpu.models import mlp as jmlp
from cdlrm_tpu.models.tricks import md_solver as jax_md_solver
from cdlrm_tpu_torch.models import dlrm, mlp
from cdlrm_tpu_torch.models.tricks import md_solver

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("cdtype", [None, "bfloat16"])
def test_apply_mlp_matches_jax(cdtype):
    rng = np.random.default_rng(0)
    sizes = [13, 64, 32, 16]
    j_params = jmlp.init_mlp(np.random.default_rng(7), sizes)
    t_params = mlp.init_mlp(np.random.default_rng(7), sizes)
    for (jw, jb), (tw, tb) in zip(j_params, t_params):
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())  # same draws
        np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    x = rng.random((64, 13)).astype(np.float32)
    want = np.asarray(jmlp.apply_mlp(
        j_params, jnp.asarray(x), sigmoid_layer=2,
        compute_dtype=None if cdtype is None else jnp.bfloat16,
    ))
    got = mlp.apply_mlp(
        t_params, torch.from_numpy(x), sigmoid_layer=2,
        compute_dtype=None if cdtype is None else torch.bfloat16,
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **(F32_TOL if cdtype is None else BF16_TOL))


@pytest.mark.parametrize("op,itself", [("dot", False), ("dot", True), ("cat", False)])
@pytest.mark.parametrize("cdtype", [None, "bfloat16"])
def test_dlrm_forward_matches_jax(op, itself, cdtype):
    rng = np.random.default_rng(3)
    t_count, d, b = 3, 16, 32
    ln_bot = [13, 32, d]
    ln_top = [jdlrm.derive_top_mlp_input_dim(t_count, d, op, itself), 8, 1]
    assert ln_top[0] == dlrm.derive_top_mlp_input_dim(t_count, d, op, itself)
    j_params = jdlrm.init_dlrm(np.random.default_rng(11), ln_bot, ln_top)
    t_params = dlrm.init_dlrm(np.random.default_rng(11), ln_bot, ln_top)
    x = rng.random((b, 13)).astype(np.float32)
    ly = rng.normal(size=(t_count, b, d)).astype(np.float32)
    jc = None if cdtype is None else jnp.bfloat16
    tc = None if cdtype is None else torch.bfloat16
    want = np.asarray(jdlrm.dlrm_forward(
        j_params, jnp.asarray(x), jnp.asarray(ly), op, itself, 0.02, jc))
    got = dlrm.dlrm_forward(
        t_params, torch.from_numpy(x), torch.from_numpy(ly), op, itself, 0.02, tc).numpy()
    assert got.shape == (b, 1) and got.dtype == np.float32
    assert got.min() >= 0.02 and got.max() <= 0.98  # loss_threshold clamp
    np.testing.assert_allclose(got, want, **(F32_TOL if cdtype is None else BF16_TOL))
    xb = rng.random((b, d)).astype(np.float32)  # a bottom-MLP output
    want_r = np.asarray(jdlrm.interact_features(
        jnp.asarray(xb), jnp.asarray(ly), op, itself, jc))
    got_r = dlrm.interact_features(
        torch.from_numpy(xb), torch.from_numpy(ly), op, itself, tc).numpy()
    np.testing.assert_allclose(got_r, want_r, **(F32_TOL if cdtype is None else BF16_TOL))


def test_params_from_jax_round_trips_init_dlrm():
    ln_bot, ln_top = [13, 32, 16], [22, 8, 1]
    tree = jdlrm.init_dlrm(np.random.default_rng(5), ln_bot, ln_top)
    leaves, _ = jtu.tree_flatten(tree)  # the dense_params.npz order
    from_leaves = dlrm.params_from_jax([np.asarray(l) for l in leaves], n_bot=2)
    from_tree = dlrm.params_from_jax(tree)
    ours = dlrm.init_dlrm(np.random.default_rng(5), ln_bot, ln_top)
    for got in (from_leaves, from_tree):
        assert [len(got["bot"]), len(got["top"])] == [2, 2]
        for key in ("bot", "top"):
            for (w, b), (jw, jb), (ow, ob) in zip(got[key], tree[key], ours[key]):
                np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
                np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
                np.testing.assert_array_equal(w.numpy(), ow.numpy())
                np.testing.assert_array_equal(b.numpy(), ob.numpy())
    with pytest.raises(ValueError):
        dlrm.params_from_jax([np.asarray(l) for l in leaves])  # no n_bot


@pytest.mark.parametrize("round_dim", [False, True])
def test_md_solver_matches_jax(round_dim):
    n = [1000, 20, 500000, 3000, 77]
    np.testing.assert_array_equal(
        md_solver(n, 0.3, d0=16, round_dim=round_dim),
        jax_md_solver(n, 0.3, d0=16, round_dim=round_dim),
    )
    np.testing.assert_array_equal(
        md_solver(n, 0.5, budget=4096, round_dim=round_dim),
        jax_md_solver(n, 0.5, budget=4096, round_dim=round_dim),
    )
