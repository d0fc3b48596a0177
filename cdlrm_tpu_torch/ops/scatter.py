"""Row set and row add on the embedding cache, the counterpart of
cdlrm_tpu/ops/scatter.py.

``scatter_set_rows(cache, slots, rows, nvalid)`` sets
``cache[slots[i]] = rows[i]`` and ``scatter_add_rows(cache, slots, delta,
nvalid)`` adds ``cache[slots[i]] += delta[i]``, both for ``i < nvalid``, in
place, and return the cache. On a CUDA tensor they launch the hand-written
kernels ``scatter_set_rows_kernel`` and ``scatter_add_rows_kernel``
(csrc/row_ops.cu), which replace the Pallas kernels at
cdlrm_tpu/ops/scatter.py:257 and :211; on a CPU tensor they run
:func:`scatter_set_rows_ref` and :func:`scatter_add_rows_ref`, the plain
PyTorch versions.

Contract (cdlrm_tpu/ops/scatter.py:20-25): ``slots[:nvalid]`` are distinct
in-range rows; positions past ``nvalid`` are trash-row padding and touch no
memory. ``nvalid`` is a one-element int64 tensor on the cache's device, read
by the kernel, so the caller never synchronises to count the valid prefix.
Distinct rows mean one writer per row: the row add needs no atomics and is
bit-exact against ``index_add_``.
"""

from __future__ import annotations

from typing import Union

import torch

from cdlrm_tpu_torch.ops import _build
from cdlrm_tpu_torch.utils import profiling


def scatter_set_rows_ref(
    cache: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
    nvalid: Union[int, torch.Tensor],
) -> torch.Tensor:
    """Plain version: ``index_copy_`` of the valid prefix (reads ``nvalid``
    on the host)."""
    nv = int(nvalid)
    return cache.index_copy_(0, slots[:nv].long(), rows[:nv])


def scatter_add_rows_ref(
    cache: torch.Tensor, slots: torch.Tensor, delta: torch.Tensor,
    nvalid: Union[int, torch.Tensor],
) -> torch.Tensor:
    """Plain version: ``index_add_`` of the valid prefix (reads ``nvalid``
    on the host)."""
    nv = int(nvalid)
    return cache.index_add_(0, slots[:nv].long(), delta[:nv])


def _launch(kernel: str, cache, slots, rows, nvalid) -> None:
    """Check a row-prefix kernel's operands and launch it on the cache's
    current stream (scatter_set_rows and scatter_add_rows share one C
    signature)."""
    _build.check_operands(
        kernel, {"cache": cache, "slots": slots, "rows": rows, "nvalid": nvalid},
        {"cache": torch.float32, "slots": torch.int32, "rows": torch.float32,
         "nvalid": torch.int64},
    )
    if nvalid.numel() != 1:
        raise TypeError(f"{kernel}: nvalid must be one element, got {tuple(nvalid.shape)}")
    lib = _build.library()
    err = getattr(lib, f"cdlrm_{kernel}")(
        cache.data_ptr(), slots.data_ptr(), rows.data_ptr(), nvalid.data_ptr(),
        slots.shape[0], cache.shape[1],
        torch.cuda.current_stream(cache.device).cuda_stream,
    )
    _build.check(lib, err, kernel)


def _check_shapes(cache, slots, rows) -> None:
    u = slots.shape[0]
    if cache.dim() != 2 or slots.dim() != 1 or tuple(rows.shape) != (u, cache.shape[1]):
        raise ValueError(
            f"cache {tuple(cache.shape)}, slots {tuple(slots.shape)}, rows "
            f"{tuple(rows.shape)}: need [R, D], [U], [U, D]"
        )


def scatter_set_rows(
    cache: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
    nvalid: torch.Tensor,
) -> torch.Tensor:
    """cache [R, D] float32 (updated in place), slots [U] int32, rows [U, D]
    float32, nvalid a one-element int64 tensor."""
    _check_shapes(cache, slots, rows)
    if cache.device.type == "cpu":
        return scatter_set_rows_ref(cache, slots, rows, nvalid)
    _launch("scatter_set_rows", cache, slots, rows, nvalid)
    profiling.count("launches.scatter_set_rows", 1)
    return cache


def scatter_add_rows(
    cache: torch.Tensor, slots: torch.Tensor, delta: torch.Tensor,
    nvalid: torch.Tensor,
) -> torch.Tensor:
    """cache [R, D] float32 (updated in place), slots [U] int32, delta
    [U, D] float32, nvalid a one-element int64 tensor."""
    _check_shapes(cache, slots, delta)
    if cache.device.type == "cpu":
        return scatter_add_rows_ref(cache, slots, delta, nvalid)
    _launch("scatter_add_rows", cache, slots, delta, nvalid)
    profiling.count("launches.scatter_add_rows", 1)
    return cache

