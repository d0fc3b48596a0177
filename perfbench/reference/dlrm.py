"""The plain DLRM reference: the published model (bottom MLP, dot
interaction of the bottom output and one row per table, top MLP ending in a
sigmoid, mean binary cross-entropy) and plain SGD on the dense weights and
on the rows that the batches touch, in plain PyTorch with no kernel, cache
or batching of the program's.

It imports nothing of the program. What the program derived from the seed,
its initial weights, tables and procedural master rows, it works out again
from the seed by the procedure that each configuration file names under
``init`` (the draws that cdlrm_tpu_torch documents in models/mlp.py,
models/embedding.py and cache/master.py).

Precision: the reference computes in float32 with TF32 off (``fp32``,
:data:`REFERENCE`), the precision that both configurations state, so that
the loss's clip at 1e-7 falls where the program's does (in float64 a
probability between 1 - 1.19e-7 and 1 - 1e-7 escapes the clip that float32
rounds it into, and one example's gradient then differs whole); ``tf32`` is
the control, the same arithmetic with TF32 matrix products; ``fp64`` reads
how far float32's own rounding goes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

VIRTUAL_BLOCK_ROWS = 65536
VIRTUAL_PHI = 0x9E3779B1
EPS = 1e-7  # the log terms read the probabilities clipped to [EPS, 1 - EPS]
REFERENCE = "fp32"


def mlp_sizes(spec: str) -> List[int]:
    return [int(v) for v in spec.split("-")]


def top_sizes(num_tables: int, bot_out: int, top: str) -> List[int]:
    nf = num_tables + 1
    return [nf * (nf - 1) // 2 + bot_out] + mlp_sizes(top)


def init_mlp(rng: np.random.Generator, sizes: Sequence[int]) -> list:
    """Weights [in, out] ~ N(0, sqrt(2/(in+out))), biases ~ N(0, sqrt(1/out)),
    layer by layer from one generator."""
    out = []
    for n, m in zip(sizes[:-1], sizes[1:]):
        w = rng.normal(0.0, np.sqrt(2.0 / (m + n)), size=(int(n), int(m))).astype(np.float32)
        b = rng.normal(0.0, np.sqrt(1.0 / m), size=(int(m),)).astype(np.float32)
        out += [w, b]
    return out


@dataclass
class Model:
    """Dense leaves (bottom W, b, ..., then top W, b, ...) and, per table,
    the sorted ids that the batches touch with their rows."""

    dense: List[np.ndarray]
    n_bot: int
    ids: List[np.ndarray]
    rows: List[np.ndarray]


def initial_model(cfg: dict, seed: int, ids: List[np.ndarray]) -> Model:
    """The initial model of the program run with ``cfg`` (a configuration
    file's ``config``) and ``seed``, restricted to the sorted ``ids`` of
    each table."""
    ln_emb = [int(n) for n in cfg["ln_emb"]]
    dim = int(cfg["arch_sparse_feature_size"])
    bot = mlp_sizes(cfg["arch_mlp_bot"])
    top = top_sizes(len(ln_emb), bot[-1], cfg["arch_mlp_top"])
    rng = np.random.default_rng(seed)
    init = cfg.get("master_init", "uniform") if cfg.get("use_cache", True) else "fulltable"
    rows: List[np.ndarray] = []
    if init == "virtual":
        # procedural masters, drawn before the dense weights
        fast = np.random.Generator(np.random.SFC64(int(rng.integers(2**31))))
        block = fast.random((VIRTUAL_BLOCK_ROWS, dim), dtype=np.float32) * 2.0 - 1.0
        for t, (n, idx) in enumerate(zip(ln_emb, ids)):
            pos = (idx.astype(np.int64) + t * VIRTUAL_PHI) % VIRTUAL_BLOCK_ROWS
            rows.append(block[pos] * np.float32(np.sqrt(1.0 / n)))
        dense = init_mlp(rng, bot) + init_mlp(rng, top)
    elif init == "fulltable":
        # the dense weights, then every table whole, uniform(+-sqrt(1/n)),
        # drawn in row blocks that keep only the touched rows
        dense = init_mlp(rng, bot) + init_mlp(rng, top)
        chunk = 1 << 20
        for n, idx in zip(ln_emb, ids):
            bound = np.sqrt(1.0 / n)
            out = np.empty((idx.size, dim), np.float32)
            for start in range(0, n, chunk):
                stop = min(n, start + chunk)
                block = rng.uniform(-bound, bound, size=(stop - start, dim))
                lo, hi = np.searchsorted(idx, [start, stop])
                out[lo:hi] = block[idx[lo:hi] - start].astype(np.float32)
            rows.append(out)
    else:
        raise ValueError(f"the reference does not know the init {init!r}")
    return Model(dense, len(bot) - 1, [np.asarray(i) for i in ids], rows)


@contextlib.contextmanager
def precision(mode: str):
    """float64; float32 with TF32 matrix products (the control); float32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield torch.float64 if mode == "fp64" else torch.float32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def forward(dense: list, n_bot: int, x: torch.Tensor, emb: List[torch.Tensor]) -> torch.Tensor:
    """Probabilities [B, 1]: ``emb`` holds one [B, D] row block per table."""
    h = x
    for i in range(n_bot):
        h = torch.relu(h @ dense[2 * i] + dense[2 * i + 1])
    feats = torch.stack([h] + emb, dim=1)  # [B, F, D]
    z = feats @ feats.transpose(1, 2)
    nf = feats.shape[1]
    li, lj = np.tril_indices(nf, k=-1)
    r = torch.cat([h, z[:, li, lj]], dim=1)
    n_top = len(dense) // 2 - n_bot
    for i in range(n_top):
        w, b = dense[2 * (n_bot + i)], dense[2 * (n_bot + i) + 1]
        r = r @ w + b
        r = torch.sigmoid(r) if i == n_top - 1 else torch.relu(r)
    return r


def bce(p: torch.Tensor, y: torch.Tensor, half: bool = False) -> torch.Tensor:
    """Mean binary cross-entropy; ``half`` is a planted fault: the mean over
    the first half of the batch alone."""
    if half:
        p, y = p[: p.shape[0] // 2], y[: y.shape[0] // 2]
    pc = torch.clamp(p, EPS, 1.0 - EPS)
    return torch.mean(-(y * torch.log(pc) + (1.0 - y) * torch.log(1.0 - pc)))


class Runner:
    """The model on a device in one precision; steps and scores batches."""

    def __init__(self, model: Model, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.n_bot = model.n_bot
        self.ids = model.ids
        self.dense = [torch.tensor(a, dtype=dtype, device=device) for a in model.dense]
        self.rows = [torch.tensor(r, dtype=dtype, device=device) for r in model.rows]

    def _lookup(self, ls_i: np.ndarray) -> List[torch.Tensor]:
        pos = []
        for t, ids in enumerate(self.ids):
            p = np.searchsorted(ids, ls_i[t])
            if not np.array_equal(ids[np.minimum(p, ids.size - 1)], ls_i[t]):
                raise ValueError(f"table {t}: an id outside the reference's rows")
            pos.append(torch.from_numpy(p).to(self.device))
        return pos

    def step(self, batch, lr: float, lr_emb: float, half: bool = False) -> float:
        """One SGD step on ``batch`` (x, ls_i, _, y); returns the loss."""
        pos = self._lookup(batch.ls_i)
        dense = [p.detach().requires_grad_() for p in self.dense]
        rows = [r.detach().requires_grad_() for r in self.rows]
        x = torch.tensor(batch.x, dtype=self.dtype, device=self.device)
        y = torch.tensor(batch.y, dtype=self.dtype, device=self.device)
        p = forward(dense, self.n_bot, x, [r[i] for r, i in zip(rows, pos)])
        loss = bce(p, y, half)
        grads = torch.autograd.grad(loss, dense + rows)
        with torch.no_grad():
            self.dense = [w - lr * g for w, g in zip(dense, grads[: len(dense)])]
            self.rows = [r - lr_emb * g for r, g in zip(rows, grads[len(dense):])]
        return float(loss.detach())

    @torch.no_grad()
    def score(self, batch) -> np.ndarray:
        pos = self._lookup(batch.ls_i)
        x = torch.tensor(batch.x, dtype=self.dtype, device=self.device)
        p = forward(self.dense, self.n_bot, x, [r[i] for r, i in zip(self.rows, pos)])
        return p.double().cpu().numpy()[:, 0]

    def state(self):
        """(dense leaves, rows per table) as float64 numpy copies."""
        return ([a.double().cpu().numpy() for a in self.dense],
                [r.double().cpu().numpy() for r in self.rows])


def touched_ids(batches: Sequence, num_tables: int) -> List[np.ndarray]:
    """Per table, the sorted unique ids of ``batches``."""
    return [np.unique(np.concatenate([b.ls_i[t] for b in batches])) for t in range(num_tables)]


def three_steps(cfg: dict, seed: int, batches: Sequence, device: torch.device,
                mode: str = REFERENCE, half: bool = False, ids: Optional[list] = None) -> Dict:
    """The first three steps from the seed's initial model: each step's loss
    and the state before step 1, after step 1 and after step 3."""
    num_tables = len(cfg["ln_emb"])
    ids = ids if ids is not None else touched_ids(batches[:3], num_tables)
    model = initial_model(cfg, seed, ids)
    with precision(mode) as dtype:
        run = Runner(model, device, dtype)
        states, losses = [run.state()], []
        for k in range(3):
            losses.append(run.step(batches[k], cfg["learning_rate"], cfg["lr_embeds"], half))
            if k in (0, 2):
                states.append(run.state())
    return {"ids": ids, "loss": losses, "state": states}


def seed_scores(cfg: dict, seed: int, eval_batches: Sequence, device: torch.device,
                mode: str = REFERENCE) -> List[np.ndarray]:
    """Scores of ``eval_batches`` by the seed's initial model."""
    ids = touched_ids(eval_batches, len(cfg["ln_emb"]))
    model = initial_model(cfg, seed, ids)
    with precision(mode) as dtype:
        run = Runner(model, device, dtype)
        return [run.score(b) for b in eval_batches]


def initial_rows(cfg: dict, seed: int, tables: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The seed's initial rows [n, D] of the ids ``ids`` of tables
    ``tables``, in their order."""
    tables, ids = np.asarray(tables, np.int64), np.asarray(ids, np.int64)
    per_table = [np.unique(ids[tables == t]) for t in range(len(cfg["ln_emb"]))]
    model = initial_model(cfg, seed, per_table)
    out = np.empty((ids.size, int(cfg["arch_sparse_feature_size"])), np.float32)
    for t, uniq in enumerate(per_table):
        sel = tables == t
        if sel.any():
            out[sel] = model.rows[t][np.searchsorted(uniq, ids[sel])]
    return out
