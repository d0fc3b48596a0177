"""Embedding compression tricks, the counterpart of cdlrm_tpu/models/tricks.py.

Only :func:`md_solver` is here so far: ``Config.finalize`` needs it to size
mixed-dimension tables. The QR and MD lookups come with the full-table path
(ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


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
