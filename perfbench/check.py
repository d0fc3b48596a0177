"""The numbers that decide ``correct``, each against the cell's limit
(``limits/<cell>.json``).

Training cells, over the first three steps (the reference follows them from
the seed; see reference/dlrm.py):

- ``loss_gap``: the widest relative gap of a step's loss;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer got it (the state before step 1 less the state
  after it, over the learning rate) of the program and of the reference,
  over the reference's norm of that leaf or of the median leaf, whichever is
  larger. A leaf is a dense weight or bias, or one table's touched rows;
- ``change_gap``: the same of the parameters' change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's. From step 2 on a probability can sit within a float32
  step of the loss's 1e-7 clip; where two float32 computations round it to
  the two sides, one example's gradient is in one and not the other, and
  this number (and the later losses) swing by that example's share;
- ``rows_off``: touched rows whose value before step 1 is not the
  reference's initial row, bit for bit (the refill's inserts, the probe's
  slots, the program's initial tables).

Cached training cells, at the refill of the second window (harness.py
``WritebackCheck``), bit for bit:

- ``writeback_off``: sampled evicted rows whose master row, behind the
  eviction fence, is not the row that the cache held just before the refill
  (the refill's evict gather, the writeback queue, the masters' overlay);
- ``insert_off``: sampled inserted rows whose cache row just after the
  refill is not the reference's initial row of that id (the prefetcher's
  gather, the staging, the refill's insert scatter).

Either reads not-a-number, and fails, where the refill or the fence never
came.

Scoring cells: ``score_gap``, the widest gap of a sampled example's score.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

def _leaves(state) -> List[np.ndarray]:
    dense, rows = state
    return [np.asarray(a, np.float64) for a in dense] + [np.asarray(r, np.float64) for r in rows]


def _norm_gaps(prog: List[float], ref: List[float], keep=None) -> np.ndarray:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's; the leaves left out read 0."""
    ref = np.asarray(ref)
    prog = np.asarray(prog)
    floor = np.median(ref)
    scale = np.maximum(ref, floor)
    gaps = np.abs(prog - ref) / np.where(scale > 0, scale, 1.0)
    return gaps if keep is None else np.where(keep, gaps, 0.0)


def train_numbers(prog: Dict, ref: Dict, lr: float, lr_emb: float, n_dense: int,
                  worst: Dict = None) -> Dict[str, float]:
    """``prog`` and ``ref``: ``loss`` (three floats) and ``state`` (three
    (dense, rows) pairs: before step 1, after step 1, after step 3), rows
    in the reference's id order. ``worst``, where given, gets the index of
    each norm gap's worst leaf (dense leaves first, then the tables)."""
    lp, lr_ = np.asarray(prog["loss"], np.float64), np.asarray(ref["loss"], np.float64)
    loss_gap = float(np.max(np.abs(lp - lr_) / np.abs(lr_)))
    p0, p1, p3 = (_leaves(s) for s in prog["state"])
    r0, r1, r3 = (_leaves(s) for s in ref["state"])
    rates = [lr] * n_dense + [lr_emb] * (len(p0) - n_dense)
    # the first step touches only batch 1's rows: the other rows' gradient
    # is zero on both sides, so the norm over all touched rows is the same
    g_prog = [float(np.linalg.norm((a - b) / k)) for a, b, k in zip(p0, p1, rates)]
    g_ref = [float(np.linalg.norm((a - b) / k)) for a, b, k in zip(r0, r1, rates)]
    c_prog = [float(np.linalg.norm(a - b)) for a, b in zip(p3, p0)]
    c_ref = [float(np.linalg.norm(a - b)) for a, b in zip(r3, r0)]
    moved = np.asarray(g_ref) >= 1e-3 * np.median(g_ref)
    grad_gaps = _norm_gaps(g_prog, g_ref)
    change_gaps = _norm_gaps(c_prog, c_ref, keep=moved)
    if worst is not None:
        worst.update(grad_leaf=int(np.argmax(grad_gaps)), change_leaf=int(np.argmax(change_gaps)))
    rows_off = 0
    for a, b in zip(prog["state"][0][1], ref["state"][0][1]):
        rows_off += int(np.any(np.asarray(a, np.float32) != np.asarray(b, np.float32), axis=1).sum())
    return {
        "loss_gap": loss_gap,
        "grad_gap": float(grad_gaps.max()),
        "change_gap": float(change_gaps.max()),
        "rows_off": float(rows_off),
    }


def _rows_off(a: np.ndarray, b: np.ndarray) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.uint32)
    b = np.ascontiguousarray(b, np.float32).view(np.uint32)
    return int(np.any(a != b, axis=1).sum())


def writeback_numbers(wb, ref_inserted) -> Dict[str, float]:
    """``wb``: the program's side (harness.WritebackCheck.readings), or None;
    ``ref_inserted``: the reference's initial rows of its inserted ids."""
    if wb is None:
        return {"writeback_off": float("nan"), "insert_off": float("nan")}
    return {"writeback_off": float(_rows_off(wb["evicted_master"], wb["evicted_cache"])),
            "insert_off": float(_rows_off(wb["inserted"][2], ref_inserted))}


def score_numbers(prog: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, float]:
    gap = max(float(np.max(np.abs(np.asarray(a, np.float64) - b))) for a, b in zip(prog, ref))
    return {"score_gap": gap}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (an exact comparison's limit is 0),
    and none missing or not a number."""
    return all(
        name in numbers and np.isfinite(numbers[name]) and numbers[name] <= limit
        for name, limit in limits.items()
    )
