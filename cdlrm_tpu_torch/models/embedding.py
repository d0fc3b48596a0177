"""Full-table embeddings (the uncached path), the counterpart of
cdlrm_tpu/models/embedding.py: tables initialized uniform(-sqrt(1/n),
sqrt(1/n)) from the same numpy draws, and summed bag pooling.

The tables are held as ONE float32 tensor ``[sum(n), D]``, table t's rows
starting at ``offsets[t]``, so that one row gather serves every table's
lookups: lookups ``[T, B]`` (single-index) or ``[T, B, P]`` with a
``[T, B, P]`` bool mask (padded multi-hot bags, a masked sum over P) become
global rows ``ls_i + offsets``. cdlrm_tpu keeps a list of per-table arrays;
:func:`init_embedding_tables` draws them in its order and
``cdlrm_tpu_torch.train.fulltable`` maps checkpoints to and from that list.

Plain tables only: the full-table trainer refuses QR and mixed-dimension
tables (cdlrm_tpu/models/tricks.py; ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cdlrm_tpu_torch.ops.lookup import gather_rows


def init_embedding_table(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """uniform(-sqrt(1/n), sqrt(1/n)) init, float32 [n, d] (cdlrm_tpu
    init_embedding_table, the same draw)."""
    bound = np.sqrt(1.0 / n)
    return rng.uniform(-bound, bound, size=(int(n), int(d))).astype(np.float32)


def init_embedding_tables(
    rng: np.random.Generator,
    ln_emb: Sequence[int],
    m_spa: int,
    device: Optional[torch.device] = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """Every plain table drawn in cdlrm_tpu's order (init_embedding_tables
    without QR or MD tables), into one ``[sum(ln_emb), m_spa]`` float32
    tensor on ``device``. Returns (tables, offsets int64 [T])."""
    ln = np.asarray(ln_emb, dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(ln)[:-1]]).astype(np.int64)
    tables = torch.empty((int(ln.sum()), int(m_spa)), dtype=torch.float32, device=device)
    # table by table, so the host never holds more than one table's draw
    for off, n in zip(offsets, ln):
        tables[off: off + n].copy_(torch.from_numpy(init_embedding_table(rng, n, m_spa)))
    return tables, offsets


def global_rows(ls_i: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Table-local ids [T, B] or [T, B, P] -> int32 rows [T*B(*P)] of the
    flat table (``offsets``: an int64 [T] tensor on ls_i's device)."""
    shape = (-1,) + (1,) * (ls_i.dim() - 1)
    return (ls_i + offsets.view(shape)).reshape(-1).to(torch.int32)


def pool(rows: torch.Tensor, ls_mask, t_count: int, b: int, d: int,
         pooled_width: int) -> torch.Tensor:
    """Looked-up rows [T*B(*P), D] -> per-table bag outputs [T, B, D]: a
    masked sum over P for multi-hot bags (``pooled_width`` P > 0)."""
    if pooled_width > 0:
        r = rows.reshape(t_count, b, pooled_width, d)
        return torch.sum(r * ls_mask[..., None].to(r.dtype), dim=2)
    return rows.reshape(t_count, b, d)


def embedding_forward(
    tables: torch.Tensor, offsets: torch.Tensor, ls_i: torch.Tensor,
    ls_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pooled lookups ly [T, B, D] (cdlrm_tpu embedding_forward): one
    ``gather_rows`` over the flat tables."""
    t_count, b = ls_i.shape[:2]
    rows = gather_rows(tables, global_rows(ls_i, offsets))
    pw = ls_i.shape[2] if ls_i.dim() == 3 else 0
    return pool(rows, ls_mask, t_count, b, tables.shape[1], pw)
