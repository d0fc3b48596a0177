"""cdlrm_tpu_torch row ops: the plain versions the CPU path runs against the
cdlrm_tpu Pallas kernels in interpret mode, on the same seeded inputs. Both
move rows without arithmetic, so every comparison is exact. The CUDA kernels
themselves run only on the card (chip_smoke.py checks them there)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cdlrm_tpu.ops.lookup import gather_rows as jax_gather_rows
from cdlrm_tpu.ops.scatter import scatter_set_rows as jax_scatter_set_rows
from cdlrm_tpu_torch.ops.lookup import gather_rows, gather_rows_ref
from cdlrm_tpu_torch.ops.scatter import scatter_set_rows, scatter_set_rows_ref


@pytest.mark.parametrize("r,d,n", [(1000, 128, 2048), (1500, 16, 1024)])
def test_gather_rows_ref_matches_pallas(r, d, n):
    rng = np.random.default_rng(0)
    cache = rng.normal(size=(r, d)).astype(np.float32)
    slots = rng.integers(0, r, n).astype(np.int32)  # duplicates included
    want = np.asarray(jax_gather_rows(jnp.asarray(cache), jnp.asarray(slots), True))
    got = gather_rows_ref(torch.from_numpy(cache), torch.from_numpy(slots)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for CPU tensors
    got_w = gather_rows(torch.from_numpy(cache), torch.from_numpy(slots)).numpy()
    np.testing.assert_array_equal(got_w, want)


@pytest.mark.parametrize("r,d,u,nv", [(900, 128, 1024, 777), (2100, 16, 2048, 1500),
                                      (300, 16, 256, 0), (300, 16, 256, 256)])
def test_scatter_set_rows_ref_matches_pallas(r, d, u, nv):
    """Distinct valid prefix, trash-padded tail past nvalid: the tail and the
    trash row stay untouched."""
    rng = np.random.default_rng(1)
    cache0 = rng.normal(size=(r, d)).astype(np.float32)
    slots = np.full(u, r - 1, np.int32)
    slots[:nv] = rng.permutation(r - 1)[:nv].astype(np.int32)
    rows = rng.normal(size=(u, d)).astype(np.float32)
    want = np.asarray(jax_scatter_set_rows(
        jnp.asarray(cache0), jnp.asarray(slots), jnp.asarray(rows), nv, interpret=True,
    ))
    for fn in (scatter_set_rows_ref, scatter_set_rows):
        cache = torch.from_numpy(cache0.copy())
        out = fn(cache, torch.from_numpy(slots), torch.from_numpy(rows),
                 torch.tensor(nv, dtype=torch.int64))
        assert out is cache  # in place
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(out.numpy()[r - 1], cache0[r - 1])


def test_wrappers_reject_bad_inputs():
    cache = torch.zeros((16, 8))
    slots = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_rows(cache[0], slots)
    with pytest.raises(ValueError):
        scatter_set_rows(cache, slots, torch.zeros((3, 8)), torch.tensor(3))
    # a device that is neither the CPU nor CUDA has no path: no silent fallback
    meta = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather_rows(meta, slots.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_set_rows(meta, slots.to("meta"), torch.zeros((4, 8), device="meta"),
                         torch.tensor(4, device="meta"))
