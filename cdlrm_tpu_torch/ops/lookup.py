"""Row gather on the embedding cache and its gradient, the counterpart of
cdlrm_tpu/ops/lookup.py.

``gather_rows(cache, slots)`` returns ``cache[slots]`` ([N, D]). On a CUDA
tensor it launches the hand-written kernel ``gather_rows_kernel``
(csrc/row_ops.cu), which replaces the Pallas kernel at
cdlrm_tpu/ops/lookup.py:70; on a CPU tensor it runs :func:`gather_rows_ref`,
the plain PyTorch version the tests and the card check compare against.

It is a ``torch.autograd.Function``, as cdlrm_tpu's is a custom VJP
(lookup.py:89-105): the gradient with respect to ``cache`` is
``zeros.index_add_(0, slots, g)``, duplicates summed. That backward is
:func:`index_add_rows`, a second hand-written kernel
(``index_add_rows_kernel``); with ``alpha = -lr_embeds`` the same kernel
applies the plain wire's sparse SGD update straight into the cache.

Contract: every slot lies in [0, R). The kernels do not check it (an
out-of-range slot reads or writes out of bounds, where XLA clamped); the
host probe emits only in-range rows.
"""

from __future__ import annotations

import torch

from cdlrm_tpu_torch.ops import _build
from cdlrm_tpu_torch.utils import profiling


def gather_rows_ref(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Plain version: ``index_select`` over rows."""
    return cache.index_select(0, slots)


def index_add_rows_ref(
    out: torch.Tensor, slots: torch.Tensor, src: torch.Tensor, alpha: float = 1.0
) -> torch.Tensor:
    """Plain version: ``index_add_`` of ``alpha * src`` (the product rounded
    to float32 first, as the kernel and cdlrm_tpu round it)."""
    return out.index_add_(0, slots, src if alpha == 1.0 else src * alpha)


def _gather_forward(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    if cache.dim() != 2 or slots.dim() != 1:
        raise ValueError(f"cache {tuple(cache.shape)} must be [R, D], slots {tuple(slots.shape)} [N]")
    if cache.device.type == "cpu":
        return gather_rows_ref(cache, slots)
    _build.check_operands("gather_rows", {"cache": cache, "slots": slots},
                          {"cache": torch.float32, "slots": torch.int32})
    n, d = slots.shape[0], cache.shape[1]
    out = torch.empty((n, d), dtype=cache.dtype, device=cache.device)
    lib = _build.library()
    err = lib.cdlrm_gather_rows(
        cache.data_ptr(), slots.data_ptr(), out.data_ptr(), n, d,
        torch.cuda.current_stream(cache.device).cuda_stream,
    )
    _build.check(lib, err, "gather_rows")
    profiling.count("launches.gather_rows", 1)
    return out


def index_add_rows(
    out: torch.Tensor, slots: torch.Tensor, src: torch.Tensor, alpha: float = 1.0
) -> torch.Tensor:
    """``out[slots[i]] += alpha * src[i]`` for every i, duplicates summed,
    in place; returns ``out``. out [R, D] float32, slots [N] int32, src
    [N, D] float32."""
    n = slots.shape[0]
    if out.dim() != 2 or slots.dim() != 1 or tuple(src.shape) != (n, out.shape[1]):
        raise ValueError(
            f"out {tuple(out.shape)}, slots {tuple(slots.shape)}, src "
            f"{tuple(src.shape)}: need [R, D], [N], [N, D]"
        )
    if out.device.type == "cpu":
        return index_add_rows_ref(out, slots, src, alpha)
    _build.check_operands(
        "index_add_rows", {"out": out, "slots": slots, "src": src},
        {"out": torch.float32, "slots": torch.int32, "src": torch.float32},
    )
    lib = _build.library()
    err = lib.cdlrm_index_add_rows(
        out.data_ptr(), slots.data_ptr(), src.data_ptr(), n, out.shape[1],
        alpha, torch.cuda.current_stream(out.device).cuda_stream,
    )
    _build.check(lib, err, "index_add_rows")
    profiling.count("launches.index_add_rows", 1)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cache, slots):
        ctx.save_for_backward(slots)
        ctx.num_rows = cache.shape[0]
        return _gather_forward(cache, slots)

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        dcache = torch.zeros((ctx.num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
        return index_add_rows(dcache, slots, g.contiguous()), None


def gather_rows(cache: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """cache [R, D] float32, slots [N] int32 -> [N, D], differentiable with
    respect to ``cache``."""
    return _GatherRows.apply(cache, slots)

