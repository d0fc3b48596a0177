"""Dense DLRM stack, the counterpart of cdlrm_tpu/models/dlrm.py: bottom
MLP -> feature interaction -> top MLP, with the loss_threshold clamp.

Parameters are a plain dict ``{"bot": [(W, b), ...], "top": [...]}`` of
tensors (with ``"md_proj"`` [T, D, D] beside them for cached mixed-dimension
tables), the same tree cdlrm_tpu keeps, so a cdlrm_tpu checkpoint's leaves
map onto it one to one (:func:`params_from_jax`). :func:`compute_loss` is
cdlrm_tpu's formula, clip included.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from cdlrm_tpu_torch.models.mlp import MLPParams, apply_mlp, cast_matmul, init_mlp

DLRMParams = Dict[str, MLPParams]


def derive_top_mlp_input_dim(
    num_sparse: int, bot_out: int, interaction_op: str, interaction_itself: bool
) -> int:
    """First dim of the top MLP (cdlrm_tpu derive_top_mlp_input_dim)."""
    num_fea = num_sparse + 1
    if interaction_op == "dot":
        if interaction_itself:
            return (num_fea * (num_fea + 1)) // 2 + bot_out
        return (num_fea * (num_fea - 1)) // 2 + bot_out
    if interaction_op == "cat":
        return num_fea * bot_out
    raise ValueError(f"unsupported interaction op: {interaction_op}")


def init_dlrm(
    rng: np.random.Generator,
    ln_bot: Sequence[int],
    ln_top: Sequence[int],
    device: Optional[torch.device] = None,
) -> DLRMParams:
    """Bottom MLP then top MLP, from the same numpy draws as cdlrm_tpu."""
    return {"bot": init_mlp(rng, ln_bot, device), "top": init_mlp(rng, ln_top, device)}


def map_params(fn, params: dict) -> dict:
    """Apply ``fn`` to every tensor of a parameter dict: the (W, b) pairs of
    ``bot`` and ``top`` and, where present, the cached mixed-dimension
    projections ``md_proj`` [T, D, D]. Returns a new dict."""
    return {
        k: fn(v) if k == "md_proj" else [(fn(w), fn(b)) for w, b in v]
        for k, v in params.items()
    }


def param_leaves(params: dict) -> list:
    """The leaves of a parameter dict in ``jax.tree_util.tree_flatten`` order
    (sorted keys): every bottom (W, b), then the embedding leaves under
    ``"emb"`` and the projections ``"md_proj"`` where present, then every top
    (W, b). For the dense parameters alone, :func:`dense_from_leaves` is the
    inverse."""
    leaves = [a for pair in params["bot"] for a in pair] + list(params.get("emb", []))
    if "md_proj" in params:
        leaves.append(params["md_proj"])
    return leaves + [a for pair in params["top"] for a in pair]


def dense_from_leaves(leaves: Sequence, like: dict) -> dict:
    """A parameter dict shaped like ``like`` from :func:`param_leaves`-ordered
    leaves."""
    it = iter(leaves)
    out = {"bot": [(next(it), next(it)) for _ in like["bot"]]}
    if "md_proj" in like:
        out["md_proj"] = next(it)
    out["top"] = [(next(it), next(it)) for _ in like["top"]]
    return out


def params_from_jax(
    src: Union[dict, Sequence[np.ndarray]],
    n_bot: Optional[int] = None,
    device: Optional[torch.device] = None,
    n_emb: int = 0,
    md_proj: bool = False,
) -> DLRMParams:
    """cdlrm_tpu parameters -> this package's parameter dict.

    ``src`` is either the pytree ``{"bot": [(W, b), ...], "top": [...]}``
    of numpy-convertible arrays, with the full-table trainer's ``"emb"``
    leaves or the cached mixed-dimension trainer's ``"md_proj"`` [T, D, D]
    beside them, or its leaves in the order ``jax.tree_util.tree_flatten``
    gives them: sorted keys, so every bottom (W, b) pair, then every
    embedding leaf, then ``md_proj``, then every top pair. That is the order
    in which cdlrm_tpu writes ``dense_params.npz`` and
    ``fulltable_params.npz`` (``leaf_0``, ``leaf_1``, ...); a leaf list needs
    ``n_bot``, the number of bottom layers, ``n_emb``, the number of
    embedding leaves (0 for the dense parameters alone), and ``md_proj``,
    whether the projections ride. The embedding leaves come back as a flat
    list under ``"emb"`` when there are any (a plain table is one leaf, a
    QR table two, an MD table one or two: models/embedding.py maps them to
    and from the trainer's tables)."""
    if isinstance(src, dict):
        n_bot, n_emb, md_proj = len(src["bot"]), len(src.get("emb", [])), "md_proj" in src
        leaves = param_leaves(src)
    else:
        leaves = list(src)
        if n_bot is None:
            raise ValueError("a leaf list needs n_bot (bottom layer count)")
    n_dense = len(leaves) - n_emb - int(md_proj)
    if n_dense % 2 or n_dense // 2 <= n_bot:
        raise ValueError(
            f"{len(leaves)} leaves cannot hold {n_bot} bottom layers, {n_emb} "
            "embedding leaves and a top MLP"
        )
    tensors = [
        torch.from_numpy(np.array(a, dtype=np.float32)).to(device) for a in leaves
    ]
    mid = 2 * n_bot + n_emb + int(md_proj)
    dense = tensors[: 2 * n_bot] + tensors[mid:]
    pairs = list(zip(dense[0::2], dense[1::2]))
    out = {"bot": pairs[:n_bot], "top": pairs[n_bot:]}
    if n_emb:
        out["emb"] = tensors[2 * n_bot: 2 * n_bot + n_emb]
    if md_proj:
        out["md_proj"] = tensors[mid - 1]
    return out


def params_to_jax(params: dict) -> List[np.ndarray]:
    """The inverse of :func:`params_from_jax`: the leaves of ``{"bot",
    ["emb",] ["md_proj",] "top"}`` as float32 numpy copies on the host, in
    ``jax.tree_util.tree_flatten`` order (every bottom (W, b), then every
    embedding leaf, then the projections, then every top (W, b)): the
    ``leaf_i`` layout of cdlrm_tpu's ``dense_params.npz``, ``dense_acc.npz``
    and ``fulltable_*.npz``. The copies are taken now, so a later in-place
    update does not reach them."""
    return [t.detach().to("cpu", copy=True).numpy() for t in param_leaves(params)]


@functools.lru_cache(maxsize=None)
def _tril_flat_index(nf: int, itself: bool, device: torch.device) -> torch.Tensor:
    """Flat [nf*nf] positions of np.tril_indices(nf, k=0 if itself else -1):
    cdlrm_tpu's lower-triangle order (dlrm.py:79-80)."""
    li, lj = np.tril_indices(nf, k=0 if itself else -1)
    return torch.from_numpy(li * nf + lj).to(device)


def interact_features(
    x: torch.Tensor,
    ly: torch.Tensor,
    interaction_op: str = "dot",
    interaction_itself: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x: [B, D] dense feature; ly: [T, B, D] embedding lookups."""
    b, d = x.shape
    t = ly.shape[0]
    if interaction_op == "cat":
        return torch.cat([x, ly.permute(1, 0, 2).reshape(b, t * d)], dim=1)
    if interaction_op != "dot":
        raise ValueError(f"unsupported interaction op: {interaction_op}")
    feats = torch.cat([x[None], ly], dim=0).permute(1, 0, 2)  # [B, F, D]
    z = cast_matmul(feats, feats.transpose(1, 2), compute_dtype)  # [B, F, F]
    nf = t + 1
    idx = _tril_flat_index(nf, bool(interaction_itself), z.device)
    return torch.cat([x, z.reshape(b, nf * nf)[:, idx]], dim=1)


def dlrm_forward(
    params: DLRMParams,
    dense_x: torch.Tensor,
    ly: torch.Tensor,
    interaction_op: str = "dot",
    interaction_itself: bool = False,
    loss_threshold: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Full dense stack; ``ly`` is [T, B, D] pooled embedding outputs.
    Returns probabilities [B, 1] in float32."""
    x = apply_mlp(params["bot"], dense_x, sigmoid_layer=-1, compute_dtype=compute_dtype)
    r = interact_features(x, ly, interaction_op, interaction_itself, compute_dtype)
    p = apply_mlp(
        params["top"], r, sigmoid_layer=len(params["top"]) - 1,
        compute_dtype=compute_dtype,
    )
    if 0.0 < loss_threshold < 1.0:
        p = torch.clamp(p, loss_threshold, 1.0 - loss_threshold)
    return p


_EPS = 1e-7  # numeric guard for log() on unclamped sigmoid outputs


def compute_loss(
    z: torch.Tensor,
    t: torch.Tensor,
    loss_function: str = "mse",
    loss_weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Mean loss over the batch (cdlrm_tpu compute_loss, dlrm.py:110-129):
    mse, bce or wbce. The log terms read ``z`` clipped to [_EPS, 1 - _EPS],
    written out rather than taken from ``binary_cross_entropy``, whose clamp
    differs."""
    t = t.to(z.dtype)
    if loss_function == "mse":
        return torch.mean((z - t) ** 2)
    zc = torch.clamp(z, _EPS, 1.0 - _EPS)
    bce = -(t * torch.log(zc) + (1.0 - t) * torch.log(1.0 - zc))
    if loss_function == "bce":
        return torch.mean(bce)
    if loss_function == "wbce":
        w = torch.as_tensor(loss_weights, dtype=z.dtype, device=z.device)
        per_example_w = w[t.to(torch.int64).reshape(-1)].reshape(t.shape)
        return torch.mean(per_example_w * bce)
    raise ValueError(f"unsupported loss function: {loss_function}")
