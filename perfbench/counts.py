"""The yardstick's arithmetic: the published peaks of the card, the model
FLOPs of a trained or scored example, and the embedding-row bytes that a
step's ids need, from a configuration's widths and the window's ids alone,
whatever kernels the program runs them in.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def mlp_macs(sizes: Sequence[int]) -> int:
    return sum(int(a) * int(b) for a, b in zip(sizes[:-1], sizes[1:]))


def forward_macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward pass: both MLPs and the dot
    interaction's needed pairs (the lower triangle, each pair once)."""
    bot = [int(v) for v in cfg["arch_mlp_bot"].split("-")]
    dim = int(cfg["arch_sparse_feature_size"])
    nf = len(cfg["ln_emb"]) + 1
    pairs = nf * (nf - 1) // 2
    top = [pairs + bot[-1]] + [int(v) for v in cfg["arch_mlp_top"].split("-")]
    return mlp_macs(bot) + pairs * dim + mlp_macs(top)


def train_flops_per_example(cfg: dict) -> int:
    """Three times the forward pass's FLOPs (forward, and the backward's
    two products), two FLOPs a multiply-add."""
    return 3 * 2 * forward_macs(cfg)


def matmul_precision(cfg: dict) -> str:
    """The precision the step's matrix products run in: float32 operands
    without TF32 (the program's default), or bfloat16 operands."""
    return "bfloat16" if cfg.get("compute_dtype") == "bfloat16" else "float32"


def train_row_bytes(ls_i: np.ndarray, dim: int) -> int:
    """One training step's least embedding-row traffic for ids [T, B]: the
    forward reads each distinct row once and writes each lookup's row; the
    backward reads each lookup's gradient row, and the update reads and
    writes each distinct row once. Float32 rows."""
    n = int(ls_i.size)
    u = sum(int(np.unique(ls_i[t]).size) for t in range(ls_i.shape[0]))
    return (2 * n + 3 * u) * dim * 4


def refill_row_bytes(inserted: int, evicted: int, dim: int) -> int:
    """A refill's least row traffic: each inserted row read from the staged
    rows and written into the cache, each evicted row read from the cache
    and written out. Float32 rows."""
    return 2 * (int(inserted) + int(evicted)) * dim * 4
