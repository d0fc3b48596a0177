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

With ``qr_flag`` or ``md_flag`` the tables above the flag's threshold are
compressed (models/tricks.py): they are held apart as :class:`QRParams` or
:class:`MDParams` entries, the flat tensor holds the plain tables only, and
``offsets`` has one start per plain table (:func:`init_embedding_tables`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from cdlrm_tpu_torch.models import tricks
from cdlrm_tpu_torch.ops.lookup import gather_rows


def init_embedding_table(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """uniform(-sqrt(1/n), sqrt(1/n)) init, float32 [n, d] (cdlrm_tpu
    init_embedding_table, the same draw)."""
    bound = np.sqrt(1.0 / n)
    return rng.uniform(-bound, bound, size=(int(n), int(d))).astype(np.float32)


def table_kinds(
    ln_emb: Sequence[int], qr_flag: bool = False, qr_threshold: int = 200,
    md_flag: bool = False, md_threshold: int = 200,
) -> List[str]:
    """Per table "qr", "md" or "plain", by cdlrm_tpu's rule
    (init_embedding_tables, embedding.py:63-73): QR above ``qr_threshold``
    rows, else MD above ``md_threshold``, else plain."""
    return ["qr" if qr_flag and int(n) > qr_threshold
            else "md" if md_flag and int(n) > md_threshold else "plain"
            for n in ln_emb]


def init_embedding_tables(
    rng: np.random.Generator,
    ln_emb: Sequence[int],
    m_spa: Union[int, Sequence[int]],
    device: Optional[torch.device] = None,
    qr_flag: bool = False,
    qr_collisions: int = 4,
    qr_threshold: int = 200,
    qr_operation: str = "mult",
    md_flag: bool = False,
    md_threshold: int = 200,
) -> Tuple[torch.Tensor, np.ndarray, list]:
    """Every table drawn in cdlrm_tpu's order (init_embedding_tables). With
    ``md_flag``, ``m_spa`` is the per-table width vector of ``md_solver`` and
    the base width its maximum. Returns (tables, offsets, entries):
    ``tables`` the plain tables as one ``[sum(n_plain), base]`` float32
    tensor on ``device``, ``offsets`` int64 [T_plain] their starts, and
    ``entries`` one item per table: None for a plain table, else its
    ``tricks.QRParams`` or ``tricks.MDParams``."""
    ln = [int(n) for n in ln_emb]
    dims = ([int(m_spa)] * len(ln) if isinstance(m_spa, (int, np.integer))
            else [int(d) for d in m_spa])
    base = max(dims)
    kinds = table_kinds(ln, qr_flag, qr_threshold, md_flag, md_threshold)
    plain_n = np.asarray([n for n, k in zip(ln, kinds) if k == "plain"], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(plain_n)[:-1]]).astype(np.int64)
    width = base if md_flag else dims[0]
    tables = torch.empty((int(plain_n.sum()), width), dtype=torch.float32, device=device)
    entries: list = []
    starts = iter(offsets)
    # table by table, so the host never holds more than one table's draw
    for n, d, kind in zip(ln, dims, kinds):
        if kind == "qr":
            entries.append(tricks.init_qr_embedding(rng, n, d, qr_collisions, qr_operation, device))
        elif kind == "md":
            entries.append(tricks.init_md_embedding(rng, n, d, base, device))
        else:
            off = int(next(starts))
            tables[off: off + n].copy_(torch.from_numpy(init_embedding_table(rng, n, width)))
            entries.append(None)
    return tables, offsets, entries


def emb_leaves(table_views: Sequence) -> list:
    """The leaves of cdlrm_tpu's ``params["emb"]`` list in ``tree_flatten``
    order, from a per-table list of plain [n, D] tensors and
    ``tricks.QRParams`` / ``tricks.MDParams`` entries: a plain table is one
    leaf, a QR table ``weight_q, weight_r``, an MD table ``weight`` and, when
    it has one, ``proj``."""
    out = []
    for e in table_views:
        out += [e] if isinstance(e, torch.Tensor) else e.leaves()
    return out


def emb_to_jax(table_views: Sequence) -> list:
    """The port's per-table list -> cdlrm_tpu's ``params["emb"]`` list as
    numpy arrays and plain dicts: a plain table is its [n, D] array, a QR
    table ``{"weight_q", "weight_r", "num_collisions", "operation"}``, an MD
    table ``{"weight", "proj"}`` (``proj`` None without a projection); the
    fields of cdlrm_tpu's ``QRParams`` and ``MDParams``."""
    def host(t):
        return None if t is None else t.detach().to("cpu", copy=True).numpy()

    out = []
    for e in table_views:
        if isinstance(e, tricks.QRParams):
            out.append(dict(weight_q=host(e.weight_q), weight_r=host(e.weight_r),
                            num_collisions=e.num_collisions, operation=e.operation))
        elif isinstance(e, tricks.MDParams):
            out.append(dict(weight=host(e.weight), proj=host(e.proj)))
        else:
            out.append(host(e))
    return out


def emb_from_jax(emb: Sequence, device: Optional[torch.device] = None) -> list:
    """The inverse of :func:`emb_to_jax`: cdlrm_tpu's ``params["emb"]`` list,
    each entry a numpy-convertible [n, D] array or a dict (or tuple, in field
    order) of a ``QRParams``' or ``MDParams``' fields, -> the per-table list
    of tensors and ``tricks`` entries on ``device``."""
    def dev(a):
        return None if a is None else torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    out = []
    for e in emb:
        if isinstance(e, (tuple, list)):
            keys = (("weight_q", "weight_r", "num_collisions", "operation") if len(e) == 4
                    else ("weight", "proj"))
            e = dict(zip(keys, e))
        if isinstance(e, dict) and "weight_q" in e:
            out.append(tricks.QRParams(dev(e["weight_q"]), dev(e["weight_r"]),
                                       int(e["num_collisions"]), str(e["operation"])))
        elif isinstance(e, dict):
            out.append(tricks.MDParams(dev(e["weight"]), dev(e.get("proj"))))
        else:
            out.append(dev(e))
    return out


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


def lookup_rows(entries: Optional[Sequence], plain_rows, ls_i: torch.Tensor) -> torch.Tensor:
    """Every table's looked-up rows, [T * B(*P), D], in table order.
    ``plain_rows(ids)`` returns the rows [T_plain * B(*P), D] of the plain
    tables' lookups ``ids`` [T_plain, B(, P)], table-major; ``entries`` is
    the per-table list of :func:`init_embedding_tables` (None: every table is
    plain)."""
    if entries is None or all(e is None for e in entries):
        return plain_rows(ls_i)
    plain = [t for t, e in enumerate(entries) if e is None]
    per_table: list = [None] * len(entries)
    if plain:
        rows = plain_rows(ls_i[plain])
        rows = rows.reshape(len(plain), -1, rows.shape[-1])
        for i, t in enumerate(plain):
            per_table[t] = rows[i]
    for t, e in enumerate(entries):
        if isinstance(e, tricks.QRParams):
            per_table[t] = tricks.qr_lookup(e, ls_i[t].reshape(-1))
        elif e is not None:
            per_table[t] = tricks.md_lookup(e, ls_i[t].reshape(-1))
    return torch.cat(per_table, dim=0)


def embedding_forward(
    tables: torch.Tensor, offsets: torch.Tensor, ls_i: torch.Tensor,
    ls_mask: Optional[torch.Tensor] = None, entries: Optional[Sequence] = None,
) -> torch.Tensor:
    """Pooled lookups ly [T, B, D] (cdlrm_tpu embedding_forward): one
    ``gather_rows`` over the flat plain tables, and each compressed table's
    lookup (``entries``, see :func:`lookup_rows`)."""
    t_count, b = ls_i.shape[:2]
    rows = lookup_rows(entries, lambda ids: gather_rows(tables, global_rows(ids, offsets)), ls_i)
    pw = ls_i.shape[2] if ls_i.dim() == 3 else 0
    return pool(rows, ls_mask, t_count, b, rows.shape[1], pw)
