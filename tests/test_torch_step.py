"""cdlrm_tpu_torch serving steps against cdlrm_tpu's, on the same wire.

The slot wire decodes exactly. The eval step's staged cache and the refill's
cache and evicted rows are exact: both packages move the same float32 rows.
The one designed difference is the trash row: cdlrm_tpu's XLA ``.at[].set``
also writes the padding past the valid prefix into it, while the port's row
set (like cdlrm_tpu's Pallas kernel) leaves it untouched; against the XLA
path the trash row is excluded, against the Pallas path (interpret mode) the
whole cache must match. Scores: float32 within 1e-5 (summation order);
bfloat16 within 5e-3 (see tests/test_torch_models.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cdlrm_tpu.cache.geometry import CacheGeometry
from cdlrm_tpu.models.dlrm import derive_top_mlp_input_dim, init_dlrm as jax_init_dlrm
from cdlrm_tpu.parallel.mesh import make_dp_mesh
from cdlrm_tpu.train import step as jstep
from cdlrm_tpu_torch.models.dlrm import init_dlrm
from cdlrm_tpu_torch.train import step as tstep

LN_EMB = [300, 1200, 2000]
DEN = 13


@pytest.mark.parametrize("bits", [9, 13, 17, 24])
def test_unpack_slots_matches_jax(bits):
    rng = np.random.default_rng(bits)
    t_count, n = 3, 200
    per_table = (1 << bits) - 2  # local ids below the all-ones sentinel
    offsets = np.array([0, per_table, 2 * per_table], np.int64)
    trash = 3 * per_table
    local = rng.integers(0, per_table, (t_count, n))
    local[:, ::2] = per_table - 1  # the largest id the width can carry
    slots = (local + offsets[:, None]).astype(np.int32)
    slots[rng.random((t_count, n)) < 0.2] = trash
    wire = tstep.pack_slots(slots, offsets, trash, bits)
    np.testing.assert_array_equal(wire, jstep.pack_slots(slots, offsets, trash, bits))
    want = np.asarray(jstep._unpack_slots(jnp.asarray(wire), offsets, trash, bits, n))
    got = tstep._unpack_slots(
        torch.from_numpy(wire), torch.from_numpy(offsets.astype(np.int32)), trash, bits, n
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, slots)
    assert tstep.wire_width(per_table - 1) == jstep.wire_width(per_table - 1) == bits


def _setup(d, b, pooled, cdtype, seed=0):
    """Geometry, both packages' params and a random starting cache."""
    rng = np.random.default_rng(seed)
    aux_cap = b * max(1, pooled)
    geo = CacheGeometry.build(LN_EMB, d, 64, 4, aux_cap)
    ln_bot = [DEN, 32, d]
    ln_top = [derive_top_mlp_input_dim(len(LN_EMB), d, "dot", False), 16, 1]
    j_params = jax_init_dlrm(np.random.default_rng(1), ln_bot, ln_top)
    t_params = init_dlrm(np.random.default_rng(1), ln_bot, ln_top)
    cache = rng.normal(size=(geo.total_rows, d)).astype(np.float32)
    kw = dict(interaction_op="dot", compute_dtype=cdtype, loss_threshold=0.0)
    return rng, geo, j_params, t_params, cache, kw


def _eval_inputs(rng, geo, b, pooled, n_miss):
    """One batch in the serving wire: resident hits, n_miss aux slots per
    table, masked bag positions on the trash row; packed slots."""
    t_count = geo.num_tables
    n = b * max(1, pooled)
    slots = np.empty((t_count, n), np.int32)
    aux_parts = []
    for t in range(t_count):
        res = geo.table_offsets[t] + rng.integers(0, geo.ways * geo.sets[t], n)
        miss_pos = rng.choice(n, n_miss, replace=False)
        aux = geo.aux_base(t) + np.arange(n_miss)
        res[miss_pos] = aux
        slots[t] = res
        aux_parts.append(aux.astype(np.int32))
    mask = None
    if pooled:
        mask = rng.random((t_count, b, pooled)) < 0.7
        mask[:, :, 0] = True
        slots[~mask.reshape(t_count, n)] = geo.trash_row
    aux_slots = np.concatenate(aux_parts)
    k = 1 << int(np.ceil(np.log2(aux_slots.size + 1)))
    aux_slots = np.concatenate([aux_slots, np.full(k - aux_slots.size, geo.trash_row, np.int32)])
    aux_rows = np.zeros((k, geo.dim), np.float32)
    aux_rows[: t_count * n_miss] = rng.normal(size=(t_count * n_miss, geo.dim))
    x = rng.random((b, DEN)).astype(np.float32)
    bits = jstep.wire_width(int((geo.ways * geo.sets + geo.aux_capacity).max()) - 1)
    wire = tstep.pack_slots(slots, geo.table_offsets, geo.trash_row, bits)
    return x, wire, mask, aux_slots, aux_rows, bits


@pytest.mark.parametrize("pooled", [0, 3])
@pytest.mark.parametrize("cdtype", [None, "bfloat16"])
@pytest.mark.parametrize("jax_pallas", [False, True])
def test_cached_eval_step_matches_jax(pooled, cdtype, jax_pallas):
    d, b = 16, 64
    rng, geo, j_params, t_params, cache0, kw = _setup(d, b, pooled, cdtype)
    x, wire, mask, aux_slots, aux_rows, bits = _eval_inputs(rng, geo, b, pooled, n_miss=9)
    mesh = make_dp_mesh(1)
    jcfg = jstep.StepConfig(wire_pack=True, wire_bits=bits, use_pallas_scatter=jax_pallas,
                            pallas_interpret=jax_pallas, refill_broadcast="off", **kw)
    j_eval = jstep.make_cached_eval_step(mesh, geo, jcfg, pooled)
    j_mask = np.zeros((geo.num_tables, b), bool) if mask is None else mask
    j_cache, j_scores = j_eval(
        jstep.replicate_for_mesh(j_params, mesh), jnp.asarray(cache0),
        jnp.asarray(x.astype(jnp.bfloat16) if cdtype else x), jnp.asarray(wire),
        jnp.asarray(j_mask), jnp.asarray(aux_slots), jnp.asarray(aux_rows),
    )
    t_eval = tstep.make_cached_eval_step(
        geo, tstep.StepConfig(wire_pack=True, wire_bits=bits, **kw), pooled)
    t_x = torch.from_numpy(x)
    t_cache, t_scores = t_eval(
        t_params, torch.from_numpy(cache0.copy()),
        t_x.to(torch.bfloat16) if cdtype else t_x, torch.from_numpy(wire),
        None if mask is None else torch.from_numpy(mask),
        torch.from_numpy(aux_slots), torch.from_numpy(aux_rows),
    )
    j_cache = np.asarray(j_cache)
    t_cache = t_cache.numpy()
    tr = geo.trash_row
    np.testing.assert_array_equal(t_cache[:tr], j_cache[:tr])
    np.testing.assert_array_equal(t_cache[tr], cache0[tr])
    if jax_pallas:
        np.testing.assert_array_equal(t_cache, j_cache)
    tol = dict(atol=1e-5, rtol=1e-5) if cdtype is None else dict(atol=5e-3, rtol=5e-3)
    assert t_scores.shape == (b, 1)
    np.testing.assert_allclose(t_scores.numpy(), np.asarray(j_scores), **tol)


@pytest.mark.parametrize("jax_pallas", [False, True])
def test_refill_step_matches_jax(jax_pallas):
    d = 16
    rng, geo, _, _, cache0, _ = _setup(d, 32, 0, None, seed=4)
    tr = geo.trash_row
    n_ins, n_ev = 200, 77
    ins = rng.permutation(tr)[:n_ins].astype(np.int32)
    ins_slots = np.concatenate([ins, np.full(256 - n_ins, tr, np.int32)])
    ins_rows = np.zeros((256, d), np.float32)
    ins_rows[:n_ins] = rng.normal(size=(n_ins, d))
    ev = ins[rng.permutation(n_ins)[:n_ev]]  # evicted rows are overwritten rows
    ev_slots = np.concatenate([ev, np.zeros(128 - n_ev, np.int32)])
    mesh = make_dp_mesh(1)
    jcfg = jstep.StepConfig(refill_broadcast="off", use_pallas_scatter=jax_pallas,
                            pallas_interpret=jax_pallas)
    j_cache, j_ev = jstep.make_refill_step(mesh, jcfg, trash_row=tr)(
        jnp.asarray(cache0), jnp.asarray(ins_slots), jnp.asarray(ins_rows),
        jnp.asarray(ev_slots),
    )
    t_cache, t_ev = tstep.make_refill_step(tstep.StepConfig(), trash_row=tr)(
        torch.from_numpy(cache0.copy()), torch.from_numpy(ins_slots),
        torch.from_numpy(ins_rows), torch.from_numpy(ev_slots),
    )
    np.testing.assert_array_equal(t_ev.numpy(), np.asarray(j_ev))
    np.testing.assert_array_equal(t_ev.numpy()[:n_ev], cache0[ev])  # pre-insert values
    j_cache = np.asarray(j_cache)
    np.testing.assert_array_equal(t_cache.numpy()[:tr], j_cache[:tr])
    np.testing.assert_array_equal(t_cache.numpy()[tr], cache0[tr])
    if jax_pallas:
        np.testing.assert_array_equal(t_cache.numpy(), j_cache)


def test_refill_step_refuses_unported_modes():
    """strict and delta are ported (tests/test_torch_dp.py): on one replica,
    without a group, their broadcasts are the identity and the step is the
    'off' one. A mode that does not exist is refused, as by cdlrm_tpu."""
    with pytest.raises(ValueError, match="unsupported refill_broadcast mode"):
        tstep.make_refill_step(tstep.StepConfig(refill_broadcast="lazy"), trash_row=0)
    cache0 = torch.arange(12.0).reshape(6, 2)
    ins = (torch.tensor([1, 5], dtype=torch.int32), torch.ones(2, 2),
           torch.tensor([1, 2], dtype=torch.int32))
    want = tstep.make_refill_step(tstep.StepConfig(refill_broadcast="off"), 5)(
        cache0.clone(), *ins)
    for mode in ("strict", "delta", True, False):
        got = tstep.make_refill_step(tstep.StepConfig(refill_broadcast=mode), 5)(
            cache0.clone(), *ins)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
