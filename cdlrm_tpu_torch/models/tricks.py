"""Embedding compression tricks, the counterpart of cdlrm_tpu/models/tricks.py:
quotient-remainder (QR) and mixed-dimension (MD) tables for the full-table
trainer, and :func:`md_solver`, which ``Config.finalize`` uses to size
mixed-dimension tables.

- QR: two tables ``[ceil(n/c), d]`` and ``[c, d]`` indexed by quotient and
  remainder, combined by mult, add or concat (width ``2d``).
- MD: a table of the width the alpha-power rule gives it and a linear
  projection ``[d_t, D]`` to the base width, applied row by row before
  pooling; no projection where ``d_t == D``.

The parameters are drawn from the caller's numpy generator in cdlrm_tpu's
order (``weight_q`` then ``weight_r``; ``weight`` then the xavier ``proj``),
so one seed gives both packages the same values. Every row lookup goes
through ``gather_rows`` (ops/lookup.py), whose backward accumulates the
dense ``[n, d]`` table gradient that cdlrm_tpu's VJP builds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from cdlrm_tpu_torch.ops.lookup import gather_rows


@dataclasses.dataclass
class QRParams:
    weight_q: torch.Tensor  # [ceil(n / num_collisions), d]
    weight_r: torch.Tensor  # [num_collisions, d]
    num_collisions: int
    operation: str  # "mult" | "add" | "concat"

    def leaves(self) -> list:
        """The tensors in cdlrm_tpu's ``tree_flatten`` order."""
        return [self.weight_q, self.weight_r]

    def with_leaves(self, leaves) -> "QRParams":
        return QRParams(leaves[0], leaves[1], self.num_collisions, self.operation)


@dataclasses.dataclass
class MDParams:
    weight: torch.Tensor  # [n, d_small]
    proj: Optional[torch.Tensor]  # [d_small, base_dim], None when d_small == base_dim

    def leaves(self) -> list:
        """The tensors in cdlrm_tpu's ``tree_flatten`` order (a ``proj`` of
        None is no leaf)."""
        return [self.weight] if self.proj is None else [self.weight, self.proj]

    def with_leaves(self, leaves) -> "MDParams":
        return MDParams(leaves[0], None if self.proj is None else leaves[1])


def init_qr_embedding(
    rng: np.random.Generator, n: int, d: int, num_collisions: int,
    operation: str = "mult", device: Optional[torch.device] = None,
) -> QRParams:
    """cdlrm_tpu init_qr_embedding: both tables uniform(-sqrt(1/n),
    sqrt(1/n)), the quotient table drawn first."""
    if operation not in ("concat", "mult", "add"):
        raise ValueError(f"qr operation must be concat|mult|add, got {operation!r}")
    nq = int(np.ceil(n / num_collisions))
    bound = np.sqrt(1.0 / n)
    wq = rng.uniform(-bound, bound, size=(nq, d)).astype(np.float32)
    wr = rng.uniform(-bound, bound, size=(num_collisions, d)).astype(np.float32)
    return QRParams(torch.from_numpy(wq).to(device), torch.from_numpy(wr).to(device),
                    int(num_collisions), operation)


def _row_ids(idx: torch.Tensor) -> torch.Tensor:
    return idx.reshape(-1).to(torch.int32)


def qr_lookup(p: QRParams, idx: torch.Tensor) -> torch.Tensor:
    """Rows for any integer index tensor: [*idx.shape, d] (``2d`` for
    concat)."""
    eq = gather_rows(p.weight_q, _row_ids(torch.div(idx, p.num_collisions, rounding_mode="floor")))
    er = gather_rows(p.weight_r, _row_ids(idx % p.num_collisions))
    if p.operation == "concat":
        out = torch.cat([eq, er], dim=-1)
    elif p.operation == "add":
        out = eq + er
    else:
        out = eq * er
    return out.reshape(*idx.shape, out.shape[-1])


def xavier_uniform(rng: np.random.Generator, shape) -> np.ndarray:
    fan_in, fan_out = shape[0], shape[1]
    a = np.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-a, a, size=shape).astype(np.float32)


def init_md_embedding(
    rng: np.random.Generator, n: int, d: int, base_dim: int,
    device: Optional[torch.device] = None,
) -> MDParams:
    """cdlrm_tpu init_md_embedding: the table uniform(-sqrt(1/n), sqrt(1/n)),
    then a xavier-uniform projection unless ``d == base_dim``."""
    if d > base_dim:
        raise ValueError(f"md embedding dim {d} > base dim {base_dim}")
    bound = np.sqrt(1.0 / n)
    w = rng.uniform(-bound, bound, size=(int(n), int(d))).astype(np.float32)
    proj = None
    if d != base_dim:
        proj = torch.from_numpy(xavier_uniform(rng, (int(d), int(base_dim)))).to(device)
    return MDParams(torch.from_numpy(w).to(device), proj)


def md_lookup(p: MDParams, idx: torch.Tensor) -> torch.Tensor:
    """Rows for any integer index tensor, projected to the base width in
    float32: [*idx.shape, base_dim]."""
    rows = gather_rows(p.weight, _row_ids(idx))
    if p.proj is not None:
        rows = torch.matmul(rows, p.proj)
    return rows.reshape(*idx.shape, rows.shape[-1])


def md_solver(
    n: Sequence[int],
    alpha: float,
    d0: Optional[float] = None,
    budget: Optional[float] = None,
    round_dim: bool = True,
    k: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Mixed-dimension assignment with the alpha-power temperature heuristic.
    Returns int dims aligned to the input order of ``n`` (cdlrm_tpu md_solver,
    with its documented fix of the reference's sorted-order bug)."""
    n = np.asarray(n, dtype=np.float64)
    k = np.ones_like(n) if k is None else np.asarray(k, dtype=np.float64)
    order = np.argsort(n)
    ns = (n / k)[order]
    if d0 is not None:
        lamb = d0 * (ns[0] ** alpha)
    elif budget is not None:
        lamb = budget / np.sum(ns ** (1 - alpha))
    else:
        raise ValueError("must specify either d0 or budget")
    d = lamb * (ns ** (-alpha))
    if d0 is not None:
        d[0] = d0
    d = np.maximum(np.round(d), 1.0)
    if round_dim:
        d = 2.0 ** np.round(np.log2(d))
    out = np.empty_like(d)
    out[order] = d
    return out.astype(np.int64)
