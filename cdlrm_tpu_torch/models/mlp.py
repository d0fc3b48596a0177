"""Functional MLP, the counterpart of cdlrm_tpu/models/mlp.py.

Weights ~ N(0, sqrt(2/(fan_in+fan_out))), biases ~ N(0, sqrt(1/fan_out)),
drawn from the caller's numpy generator in the same order as cdlrm_tpu, so
one seed gives both packages the same weights. W is stored ``[in, out]``
(x @ W + b), cdlrm_tpu's layout, not torch's ``[out, in]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MLPParams = List[Tuple[torch.Tensor, torch.Tensor]]


def init_mlp(
    rng: np.random.Generator, layer_sizes: Sequence[int],
    device: Optional[torch.device] = None,
) -> MLPParams:
    """Initialize an MLP for sizes [d0, d1, ..., dk] (k linear layers)."""
    params: MLPParams = []
    for n, m in zip(layer_sizes[:-1], layer_sizes[1:]):
        std_w = np.sqrt(2.0 / (m + n))
        std_b = np.sqrt(1.0 / m)
        w = rng.normal(0.0, std_w, size=(int(n), int(m))).astype(np.float32)
        b = rng.normal(0.0, std_b, size=(int(m),)).astype(np.float32)
        params.append(
            (torch.from_numpy(w).to(device), torch.from_numpy(b).to(device))
        )
    return params


def cast_matmul(
    a: torch.Tensor, b: torch.Tensor, compute_dtype: Optional[torch.dtype]
) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``compute_dtype`` and a float32
    result: jnp.dot(..., preferred_element_type=f32). A product of two bf16
    values is exact in float32, so upcasting the rounded operands and
    multiplying in float32 computes the same sum as a bf16 GEMM with f32
    accumulation, up to summation order. Float32 matmuls must run in full
    float32 (torch.backends.cuda.matmul.allow_tf32 False, torch's default)."""
    if compute_dtype is not None:
        a = a.to(compute_dtype).float()
        b = b.to(compute_dtype).float()
    return torch.matmul(a, b)


def apply_mlp(
    params: MLPParams,
    x: torch.Tensor,
    sigmoid_layer: int = -1,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Forward through the MLP; layer ``sigmoid_layer`` ends in a sigmoid,
    every other layer in a ReLU (cdlrm_tpu apply_mlp)."""
    for i, (w, b) in enumerate(params):
        x = cast_matmul(x, w, compute_dtype) + b.float()
        x = torch.sigmoid(x) if i == sigmoid_layer else torch.relu(x)
    return x
