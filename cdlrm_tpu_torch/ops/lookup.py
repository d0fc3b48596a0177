"""Row gather on the embedding cache, the counterpart of cdlrm_tpu/ops/lookup.py.

``gather_rows(cache, slots)`` returns ``cache[slots]`` ([N, D]). On a CUDA
tensor it launches the hand-written kernel ``gather_rows_kernel``
(csrc/row_ops.cu), which replaces the Pallas kernel at
cdlrm_tpu/ops/lookup.py:70; on a CPU tensor it runs :func:`gather_rows_ref`,
the plain PyTorch version the tests and the card check compare against.

Contract: every slot lies in [0, R). The kernel does not check it (an
out-of-range slot reads out of bounds, where XLA clamped); the host probe
emits only in-range rows. Forward only: training's gradient, an
``autograd.Function`` whose backward is a kernel, comes with the training
port (ROADMAP.md queue 2).
"""

from __future__ import annotations

import torch

from cdlrm_tpu_torch.ops import _build


def gather_rows_ref(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_select`` over rows."""
    return cache.index_select(0, slots)


def gather_rows(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """cache [R, D] float32, slots [N] int32 -> [N, D]."""
    if cache.dim() != 2 or slots.dim() != 1:
        raise ValueError(f"cache {tuple(cache.shape)} must be [R, D], slots {tuple(slots.shape)} [N]")
    if cache.device.type == "cpu":
        return gather_rows_ref(cache, slots)
    if cache.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {cache.device}")
    if cache.dtype != torch.float32 or slots.dtype != torch.int32:
        raise TypeError(f"gather_rows needs float32 cache and int32 slots, got {cache.dtype}, {slots.dtype}")
    if slots.device != cache.device:
        raise ValueError(f"slots on {slots.device}, cache on {cache.device}")
    if not (cache.is_contiguous() and slots.is_contiguous()):
        raise ValueError("gather_rows needs contiguous cache and slots")
    if cache.requires_grad:
        raise RuntimeError("gather_rows is forward only: no autograd yet")
    n, d = slots.shape[0], cache.shape[1]
    out = torch.empty((n, d), dtype=cache.dtype, device=cache.device)
    lib = _build.library()
    err = lib.cdlrm_gather_rows(
        cache.data_ptr(), slots.data_ptr(), out.data_ptr(), n, d,
        torch.cuda.current_stream(cache.device).cuda_stream,
    )
    _build.check(lib, err, "gather_rows")
    gather_rows.launches += 1
    return out


# kernel launches since the last reset (a process-wide count, as the kernel
# is): a run can show that its main path went through the kernel
gather_rows.launches = 0
