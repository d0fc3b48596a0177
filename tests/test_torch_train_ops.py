"""The training half of cdlrm_tpu_torch's ops and model against cdlrm_tpu,
on the same seeded numpy inputs: the loss and its gradients, the row add
(``scatter_add_rows``) and the gather's backward (``index_add_rows``), each
through the plain PyTorch version that the CPU path runs. The CUDA kernels
run only on the card (chip_smoke.py checks them there).

Tolerances: the row add on a distinct prefix is one float add per element,
so it is exact. The gather's backward sums duplicate slots; cdlrm_tpu's XLA
scatter and ``index_add_`` both add in index order on the CPU, and the
bound is 1e-6 all the same, since the order is not part of either contract.
The loss and its gradients differ by summation order only (1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cdlrm_tpu.models import dlrm as jdlrm
from cdlrm_tpu.ops.lookup import gather_rows as jax_gather_rows
from cdlrm_tpu.ops.scatter import scatter_add_rows as jax_scatter_add_rows
from cdlrm_tpu_torch.models import dlrm
from cdlrm_tpu_torch.ops.lookup import gather_rows, index_add_rows, index_add_rows_ref
from cdlrm_tpu_torch.ops.scatter import scatter_add_rows, scatter_add_rows_ref

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("loss_function", ["mse", "bce", "wbce"])
def test_compute_loss_and_grad_match_jax(loss_function):
    """Probabilities include values at and past the clip (0, 1, 1e-9) so
    that the _EPS guard is exercised."""
    rng = np.random.default_rng(3)
    z = rng.random((64, 1)).astype(np.float32)
    z[:4, 0] = [0.0, 1.0, 1e-9, 1.0 - 1e-9]
    t = (rng.random((64, 1)) < 0.4).astype(np.float32)
    weights = (0.3, 2.5)

    def jax_loss(zz):
        return jdlrm.compute_loss(zz, jnp.asarray(t), loss_function, weights)

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    got = dlrm.compute_loss(zt, torch.from_numpy(t), loss_function, weights)
    (got_g,) = torch.autograd.grad(got, zt)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)


def test_compute_loss_rejects_unknown():
    with pytest.raises(ValueError, match="unsupported loss"):
        dlrm.compute_loss(torch.zeros(4, 1), torch.zeros(4, 1), "hinge")


@pytest.mark.parametrize("r,d,u,nv", [(900, 128, 1024, 777), (2100, 16, 2048, 1500),
                                      (300, 16, 256, 0), (300, 16, 256, 256)])
def test_scatter_add_rows_ref_matches_pallas(r, d, u, nv):
    """Distinct valid prefix, trash-padded tail past nvalid: the rows past
    the prefix and the trash row stay untouched, whatever their deltas."""
    rng = np.random.default_rng(2)
    cache0 = rng.normal(size=(r, d)).astype(np.float32)
    slots = np.full(u, r - 1, np.int32)
    slots[:nv] = rng.permutation(r - 1)[:nv].astype(np.int32)
    delta = rng.normal(size=(u, d)).astype(np.float32)
    want = np.asarray(jax_scatter_add_rows(
        jnp.asarray(cache0), jnp.asarray(slots), jnp.asarray(delta), nv, interpret=True,
    ))
    for fn in (scatter_add_rows_ref, scatter_add_rows):
        cache = torch.from_numpy(cache0.copy())
        out = fn(cache, torch.from_numpy(slots), torch.from_numpy(delta),
                 torch.tensor(nv, dtype=torch.int64))
        assert out is cache  # in place
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(out.numpy()[r - 1], cache0[r - 1])


@pytest.mark.parametrize("r,d,n", [(1000, 128, 2048), (1500, 16, 1024)])
def test_gather_rows_grad_matches_jax_vjp(r, d, n):
    """The gradient of sum(gather_rows(cache, slots) * w) with respect to the
    cache: duplicates and untouched rows included."""
    rng = np.random.default_rng(5)
    cache = rng.normal(size=(r, d)).astype(np.float32)
    slots = rng.integers(0, r // 4, n).astype(np.int32)  # heavy duplication
    w = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda c: jnp.sum(jax_gather_rows(c, jnp.asarray(slots), True) * w)
    )(jnp.asarray(cache)))
    ct = torch.from_numpy(cache).requires_grad_()
    rows = gather_rows(ct, torch.from_numpy(slots))
    np.testing.assert_array_equal(rows.detach().numpy(), cache[slots])
    (got,) = torch.autograd.grad(torch.sum(rows * torch.from_numpy(w)), ct)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[r // 4:].any()  # rows no slot reads get no gradient


def test_index_add_rows_folds_the_scale():
    """``alpha * src`` is rounded to float32 before the add, as cdlrm_tpu's
    ``cache.at[slots].add(-lr * drows)`` rounds it: bit-equal to XLA."""
    rng = np.random.default_rng(7)
    out0 = rng.normal(size=(50, 8)).astype(np.float32)
    slots = rng.integers(0, 50, 400).astype(np.int32)
    src = rng.normal(size=(400, 8)).astype(np.float32)
    lr = float(np.float32(0.3))
    want = np.asarray(jnp.asarray(out0).at[slots].add(-jnp.float32(lr) * src))
    for fn in (index_add_rows_ref, index_add_rows):
        out = torch.from_numpy(out0.copy())
        assert fn(out, torch.from_numpy(slots), torch.from_numpy(src), -lr) is out
        np.testing.assert_allclose(out.numpy(), want, **TOL)


def test_new_wrappers_reject_bad_inputs():
    cache = torch.zeros((16, 8))
    slots = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        scatter_add_rows(cache, slots, torch.zeros((3, 8)), torch.tensor(3))
    with pytest.raises(ValueError):
        index_add_rows(cache, slots, torch.zeros((4, 7)))
    meta = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_add_rows(meta, slots.to("meta"), torch.zeros((4, 8), device="meta"),
                         torch.tensor(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        index_add_rows(meta, slots.to("meta"), torch.zeros((4, 8), device="meta"))
