"""Row set on the embedding cache, the counterpart of
cdlrm_tpu/ops/scatter.py::scatter_set_rows.

``scatter_set_rows(cache, slots, rows, nvalid)`` sets
``cache[slots[i]] = rows[i]`` for ``i < nvalid``, in place, and returns the
cache. On a CUDA tensor it launches the hand-written kernel
``scatter_set_rows_kernel`` (csrc/row_ops.cu), which replaces the Pallas
kernel at cdlrm_tpu/ops/scatter.py:257; on a CPU tensor it runs
:func:`scatter_set_rows_ref`, the plain PyTorch version.

Contract (cdlrm_tpu/ops/scatter.py:20-25): ``slots[:nvalid]`` are distinct
in-range rows; positions past ``nvalid`` are trash-row padding and touch no
memory. ``nvalid`` is a one-element int64 tensor on the cache's device, read
by the kernel, so the caller never synchronises to count the valid prefix.

cdlrm_tpu's ``scatter_add_rows`` (scatter.py:211) is not ported yet: only
training reaches it (ROADMAP.md queue 2).
"""

from __future__ import annotations

from typing import Union

import torch

from cdlrm_tpu_torch.ops import _build


def scatter_set_rows_ref(
    cache: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
    nvalid: Union[int, torch.Tensor],
) -> torch.Tensor:
    """Plain version: ``index_copy_`` of the valid prefix (reads ``nvalid``
    on the host)."""
    nv = int(nvalid)
    return cache.index_copy_(0, slots[:nv].long(), rows[:nv])


def scatter_set_rows(
    cache: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor,
    nvalid: torch.Tensor,
) -> torch.Tensor:
    """cache [R, D] float32 (updated in place), slots [U] int32, rows [U, D]
    float32, nvalid a one-element int64 tensor."""
    u = slots.shape[0]
    if cache.dim() != 2 or slots.dim() != 1 or tuple(rows.shape) != (u, cache.shape[1]):
        raise ValueError(
            f"cache {tuple(cache.shape)}, slots {tuple(slots.shape)}, rows "
            f"{tuple(rows.shape)}: need [R, D], [U], [U, D]"
        )
    if cache.device.type == "cpu":
        return scatter_set_rows_ref(cache, slots, rows, nvalid)
    if cache.device.type != "cuda":
        raise ValueError(f"scatter_set_rows: unsupported device {cache.device}")
    if (cache.dtype, rows.dtype, slots.dtype) != (torch.float32, torch.float32, torch.int32):
        raise TypeError(
            "scatter_set_rows needs float32 cache and rows and int32 slots, got "
            f"{cache.dtype}, {rows.dtype}, {slots.dtype}"
        )
    if nvalid.dtype != torch.int64 or nvalid.numel() != 1:
        raise TypeError(f"nvalid must be one int64 element, got {nvalid.dtype} {tuple(nvalid.shape)}")
    if not (slots.device == rows.device == nvalid.device == cache.device):
        raise ValueError("cache, slots, rows and nvalid must share one device")
    if not (cache.is_contiguous() and slots.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter_set_rows needs contiguous cache, slots and rows")
    lib = _build.library()
    err = lib.cdlrm_scatter_set_rows(
        cache.data_ptr(), slots.data_ptr(), rows.data_ptr(), nvalid.data_ptr(),
        u, cache.shape[1], torch.cuda.current_stream(cache.device).cuda_stream,
    )
    _build.check(lib, err, "scatter_set_rows")
    scatter_set_rows.launches += 1
    return cache


# kernel launches since the last reset (see gather_rows.launches)
scatter_set_rows.launches = 0
