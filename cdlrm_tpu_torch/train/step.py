"""Device steps, the counterpart of cdlrm_tpu/train/step.py: the cached
train step (the plain wire and the packed, unpacked and sorted unpacked
dedup wires; SGD, with or without the hot tier, and AdaGrad on the dedup
wires), scan blocks of it with the block-coalesced update, the cached eval
step, the refill step, the touched-row aggregate step, the full-table train
and eval steps, and the wires they read.

Each step is a plain function over one rank's tensors on its device. PyTorch
runs eagerly, so there is no jit and no ``lax.scan``: a scan block is a loop
of single steps (with the block-coalesced update, one flush after it), and
the cache is updated in place where cdlrm_tpu donates it. On a CUDA device
the row moves run the hand-written kernels (ops/lookup.py, ops/scatter.py);
on the CPU their plain versions.

Data parallelism is one process per device (parallel/mesh.py): a step built
with a :class:`DpGroup` of more than one rank runs on the rank's batch slice
and its own cache replica, and where cdlrm_tpu's ``shard_map`` body calls
``psum``/``pmax``/``pmean`` it calls the group's collectives, in the same
order on every rank. Without a group (one replica) no collective exists.

cdlrm_tpu's ``use_pallas_lookup``, ``use_pallas_scatter`` and
``pallas_interpret`` choose between XLA ops and Pallas kernels on the TPU;
here the hand-written kernel is the only path on the card, so the port has no
such switches and ignores those config fields.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cdlrm_tpu_torch.cache.geometry import CacheGeometry
from cdlrm_tpu_torch.models.dlrm import (
    compute_loss, dense_from_leaves, dlrm_forward, param_leaves,
)
from cdlrm_tpu_torch.models.embedding import embedding_forward, global_rows, lookup_rows
from cdlrm_tpu_torch.models.embedding import pool as _pool
from cdlrm_tpu_torch.models.mlp import cast_matmul
from cdlrm_tpu_torch.ops.lookup import gather_rows, index_add_rows
from cdlrm_tpu_torch.ops.scatter import scatter_add_rows, scatter_set_rows
from cdlrm_tpu_torch.parallel.mesh import DpGroup


class StepConfig(NamedTuple):
    """The cdlrm_tpu StepConfig fields that the port reads, under the same
    names."""

    interaction_op: str = "dot"
    interaction_itself: bool = False
    loss_function: str = "mse"
    loss_weights: Tuple[float, ...] = (1.0, 1.0)
    loss_threshold: float = 0.0
    # how the touched rows' replicas combine at an aggregate step:
    # sum | mean (/ world size) | max (make_aggregate_step)
    table_agg_op: str = "mean"
    # leave the bias gradients out of the dense-gradient mean, so that biases
    # diverge between replicas as in the reference (cdlrm_tpu
    # _sync_dense_grads, step.py:460-487)
    strict_bias_divergence: bool = False
    # 'off': the refill has no collective (one replica). 'strict': evicted
    # rows and then the whole cache are broadcast from rank 0. 'delta': the
    # evicted rows only; the insert buffer is the same on every rank, so the
    # trajectory equals strict's when table_agg_freq divides lookahead
    # (Config.finalize falls back to strict otherwise)
    refill_broadcast: str = "off"
    compute_dtype: Optional[str] = None  # None/'float32' | 'bfloat16'
    # slots arrive as a [T, BYTES] uint8 bitstream of wire_bits-wide
    # table-local ids (pack_slots), unpacked on the device
    wire_pack: bool = False
    wire_bits: int = 24  # == WIRE_MAX_BITS
    # dedup wire: per lookup a table-local first-seen rank into a per-step
    # unique-slot list, bit-packed with wire_pack (host_cache.probe_dedup),
    # else raw int32 ranks and global rows (probe_dedup_raw); the step
    # gathers each unique row once and scatters one summed update per row
    dedup: bool = False
    inv_bits: int = 13  # rank wire width: >= wire_width(lookups_per_table-1)
    uniq_bits: int = 24  # unique-list wire width (== wire_bits)
    # "sgd" | "adagrad": element-wise AdaGrad with torch.optim.Adagrad
    # semantics on the dense MLPs and row-wise AdaGrad (torchrec semantics)
    # on the embedding rows, the state of each cache row held beside it on
    # the device (cdlrm_tpu StepConfig.optimizer, step.py:116-133); needs
    # the dedup wire
    optimizer: str = "sgd"
    adagrad_eps: float = 1e-10  # torch.optim.Adagrad's default
    # the refill gathers the evicted slots' row-wise state and sets the
    # inserted slots' state from the host store, where plain AdaGrad resets
    # it to 0 (Config.adagrad_master_state)
    adagrad_master_state: bool = False
    # block-coalesced update (scan blocks on the unpacked dedup wire):
    # per-lookup gradients accumulate in a pending buffer in block-union row
    # space and the cache takes one row add per block (make_cached_train_step)
    block_coalesce: bool = False
    # refill insert rows and per-batch miss rows arrive as bfloat16 and are
    # widened before they are set into the float32 cache; evicted rows are
    # rounded to bfloat16 on the device before they leave it
    # (Config.wire_rows_bf16)
    wire_rows_bf16: bool = False
    # cached mixed-dimension tables: the cache holds zero-padded [., D] rows
    # and each table's pooled output goes through its projection
    # ``params["md_proj"][t]`` [D, D] (_apply_md_proj). ``md_train_mask`` [T]
    # is 0.0 for a table of full width, whose projection is a frozen
    # identity, else 1.0
    md_proj: bool = False
    md_train_mask: Tuple[float, ...] = ()
    # the sorted unpacked dedup wire (Config.sorted_dedup_wire): the unique
    # list holds ascending slots from position 0, trash padding at its tail,
    # and masked lanes rank to its last position (_decode_dedup_raw)
    sorted_wire: bool = False
    # the hot tier (Config.hot_tier_rows): ``hot_rows`` = H > 0 adds the
    # per-window input ``hot_slots`` [H] (sorted, the last position the trash
    # row) and splits the sparse SGD update into one H-row add of the hot
    # lookups' summed gradients and one add of the cold lookups, compacted to
    # ``cold_bucket`` lanes, a bound of every batch's cold count that the
    # window's shadow stats give (_hot_cold_update; cdlrm_tpu step.py:138-154)
    hot_rows: int = 0
    cold_bucket: int = 0

    @property
    def cdtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


# Wire format (cdlrm_tpu/train/step.py:192-231): per table, an LSB-first
# bitstream of WIRE_BITS-wide table-local slot ids; all-ones is the sentinel
# for trash-row positions.
WIRE_MAX_BITS = 24


def wire_width(max_local_slot: int) -> int:
    """Smallest bit width whose all-ones sentinel exceeds every local slot
    (>= 9, <= WIRE_MAX_BITS or the caller disables packing)."""
    return max(9, int(max_local_slot + 1).bit_length())


def wire_bytes(n: int, bits: int) -> int:
    """Bytes per table for an n-lookup bitstream (+4 so the 4-byte windows of
    the unpack never read out of bounds)."""
    return (n * bits + 7) // 8 + 4


def pack_slots(
    slots: np.ndarray, table_offsets: np.ndarray, trash_row: int,
    bits: int = WIRE_MAX_BITS,
) -> np.ndarray:
    """Host side (numpy; the native probe emits this directly): global int32
    slot ids [T, N] -> bitstream [T, wire_bytes(N, bits)]."""
    t_count, n = slots.shape
    sent = (1 << bits) - 1
    local = slots.astype(np.int64) - table_offsets[:, None]
    local = np.where(slots == trash_row, sent, local).astype(np.uint32)
    out = np.zeros((t_count, wire_bytes(n, bits)), np.uint8)
    pos = np.arange(n, dtype=np.int64) * bits
    for k in range(bits):
        p = pos + k
        byte, sh = p >> 3, (p & 7).astype(np.uint8)
        # bits >= 9 => within one k the byte indices are strictly increasing
        bit = ((local >> k) & 1).astype(np.uint8)
        out[:, byte] |= bit << sh
    return out


def _unpack_raw(wire: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Bitstream [T, BYTES] uint8 -> raw int32 values [T, n]: each value reads
    a 4-byte little-endian window (bits <= 24 plus a shift <= 7 fits 31 bits).
    The all-ones value at ``bits`` is the caller's sentinel."""
    bitpos = torch.arange(n, dtype=torch.int64, device=wire.device) * bits
    byte = bitpos >> 3
    sh = bitpos & 7
    w = wire.to(torch.int64)
    window = (
        w[:, byte]
        | (w[:, byte + 1] << 8)
        | (w[:, byte + 2] << 16)
        | (w[:, byte + 3] << 24)
    )
    return ((window >> sh) & ((1 << bits) - 1)).to(torch.int32)


def _unpack_slots(
    wire: torch.Tensor, table_offsets: torch.Tensor, trash_row: int, bits: int,
    n: int,
) -> torch.Tensor:
    """Bitstream [T, BYTES] -> global int32 slots [T, n] (sentinel -> trash);
    ``table_offsets`` is an int32 [T] tensor on the wire's device."""
    local = _unpack_raw(wire, bits, n)
    trash = torch.full_like(local, trash_row)
    return torch.where(local == (1 << bits) - 1, trash, local + table_offsets[:, None])


def _decode_dedup(
    inv_wire: torch.Tensor, uniq_wire: torch.Tensor, uniq_counts: torch.Tensor,
    table_offsets: torch.Tensor, trash_row: int, inv_bits: int, uniq_bits: int,
    n: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode the packed dedup wire (cdlrm_tpu _decode_dedup, step.py:262).

    inv_wire [T, IB]: table-local first-seen ranks (sentinel = masked).
    uniq_wire [UB_BYTES] (flat): position 0 is the reserved trash rank
    (sentinel-coded), then each table's local unique slot ids tightly
    concatenated, then sentinel padding to the bucket.
    Returns (uniq_slots [Ub] int32 global rows, ginv [T*n] int32 ranks into
    uniq_slots; masked positions -> 0, the trash rank)."""
    t_count = inv_wire.shape[0]
    ub = ((uniq_wire.shape[0] - 4) * 8) // uniq_bits  # exact: bits >= 9
    cum = torch.cumsum(uniq_counts.to(torch.int64), 0)
    # unique list: element j>=1 holds data position j-1; its table is the
    # first t with cum[t] > j-1
    vals = _unpack_raw(uniq_wire[None, :], uniq_bits, ub)[0]
    pos = torch.arange(ub, dtype=torch.int64, device=uniq_wire.device) - 1
    tbl = torch.searchsorted(cum, pos, right=True).clamp_(0, t_count - 1)
    uniq_slots = torch.where(
        vals == (1 << uniq_bits) - 1, trash_row, vals + table_offsets[tbl]
    )
    # inverse: local rank -> 1 + rank_offset[t] (+1 for the trash rank)
    inv = _unpack_raw(inv_wire, inv_bits, n)
    base = torch.cat([cum.new_zeros(1), cum[:-1]])[:, None]
    ginv = torch.where(inv == (1 << inv_bits) - 1, 0, inv + 1 + base)
    return uniq_slots.to(torch.int32), ginv.reshape(-1).to(torch.int32)


def _decode_dedup_raw(
    inv: torch.Tensor, uniq_slots: torch.Tensor, uniq_counts: torch.Tensor,
    sorted_wire: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode the unpacked dedup wire (cdlrm_tpu _decode_dedup_raw,
    step.py:304-328; host_cache.probe_dedup_raw): ``inv`` int32 [T, n]
    table-local ranks (-1 = masked), ``uniq_slots`` int32 [Ub] global cache
    rows. Default layout: position 0 the reserved trash rank, then each
    table's unique rows, then trash-row padding; masked positions rank to 0.
    ``sorted_wire``: no reserved head, the ascending unique rows from
    position 0 (the table blocks are disjoint and ascending, so the ranks
    keep their per-table offsets), trash padding at the tail, which the
    host's bucket guard keeps at least one long; masked positions rank to
    the last position. Returns (uniq_slots, ginv [T*n] int32 ranks into
    uniq_slots)."""
    cum = torch.cumsum(uniq_counts.to(torch.int64), 0)
    base = torch.cat([cum.new_zeros(1), cum[:-1]])[:, None]
    if sorted_wire:
        ginv = torch.where(inv < 0, uniq_slots.shape[0] - 1, inv + base)
    else:
        ginv = torch.where(inv < 0, 0, inv + 1 + base)
    return uniq_slots, ginv.reshape(-1).to(torch.int32)


class _TableOffsets:
    """The geometry's table offsets as an int32 [T] tensor, one per device,
    built on first use."""

    def __init__(self, geo: CacheGeometry):
        self.geo = geo
        self.per_device: Dict[torch.device, torch.Tensor] = {}

    def __call__(self, device: torch.device) -> torch.Tensor:
        offs = self.per_device.get(device)
        if offs is None:
            offs = self.per_device[device] = torch.as_tensor(
                self.geo.table_offsets, dtype=torch.int32, device=device
            )
        return offs


def _upcast_x(x: torch.Tensor, cdtype: Optional[torch.dtype]) -> torch.Tensor:
    """Dense features shipped as float8_e4m3fn (Config.wire_x_fp8) are
    widened once at step entry, to the compute dtype (float32 when none);
    cdlrm_tpu ``_upcast_x``, step.py:338."""
    if x.dtype == torch.float8_e4m3fn:
        return x.to(cdtype if cdtype is not None else torch.float32)
    return x


def _stage_aux(cache, aux_slots, aux_rows, trash_row: int) -> None:
    """Set the batch's miss rows into the aux region. The valid prefix is
    counted on the device: the aux bucket is padded with the trash row,
    which no miss is ever staged into. Rows of the bfloat16 row wire are
    widened first (exact): the kernel takes float32 rows."""
    nv_aux = (aux_slots != trash_row).sum()
    scatter_set_rows(cache, aux_slots, aux_rows.to(torch.float32), nv_aux)


def _apply_md_proj(ly: torch.Tensor, proj: torch.Tensor,
                   cdtype: Optional[torch.dtype]) -> torch.Tensor:
    """The per-table projection of cached mixed-dimension tables, after
    pooling (cdlrm_tpu ``_apply_md_proj``, step.py:443): one batched
    [T, B, D] x [T, D, D] product, operands rounded to the compute dtype,
    float32 sums, the result rounded to the compute dtype. It is small next
    to the MLPs. The pad rows of each projection are zero, so the padded
    columns of a cache row contribute nothing and their gradient is exactly
    zero: the zero-padded cache layout stays as it is under SGD."""
    out = cast_matmul(ly, proj, cdtype)
    return out if cdtype is None else out.to(cdtype).float()


def _value_and_grad(cfg: StepConfig, pooled_width: int, params, leaf, expand, x,
                    ls_mask, targets, t_count: int, b_loc: int):
    """Loss, probabilities, and the gradients with respect to the dense
    parameters and ``leaf`` (jax.value_and_grad over (params, rows),
    cdlrm_tpu step.py:675-677). ``leaf`` is one tensor or a list of them
    (its gradient comes back alike); ``expand`` maps it to the per-lookup
    rows [T*B(*P), D]. The dense gradients come in :func:`param_leaves` order
    (with ``md_proj``'s between the bottom and the top MLP's)."""
    flat = [p.detach().requires_grad_() for p in param_leaves(params)]
    live = dense_from_leaves(flat, params)
    rows = expand(leaf)
    ly = _pool(rows, ls_mask, t_count, b_loc, rows.shape[-1], pooled_width)
    if cfg.md_proj:
        ly = _apply_md_proj(ly, live["md_proj"], cfg.cdtype)
    p = dlrm_forward(
        live, x, ly, cfg.interaction_op, cfg.interaction_itself,
        cfg.loss_threshold, cfg.cdtype,
    )
    loss = compute_loss(p, targets, cfg.loss_function, cfg.loss_weights)
    many = isinstance(leaf, (list, tuple))
    grads = torch.autograd.grad(loss, flat + (list(leaf) if many else [leaf]))
    dleaf = grads[len(flat):]
    return loss.detach(), p.detach(), grads[:len(flat)], (list(dleaf) if many else dleaf[0])


def _dense_adagrad(params, dflat, lr, dense_acc, eps: float):
    """Element-wise AdaGrad with torch.optim.Adagrad semantics (cdlrm_tpu
    ``_dense_adagrad``, step.py:350-360): ``a += g * g``, then ``w -= lr * g
    / (sqrt(a) + eps)``, eps outside the sqrt, in cdlrm_tpu's order of
    float32 operations. ``dflat`` holds the gradients in the order of the
    (W, b) pairs of ``params["bot"]`` then ``params["top"]``; ``dense_acc``
    has the shape of ``params``. Returns (params, dense_acc), both new."""
    it = iter(dflat)
    new_p, new_a = {}, {}
    for key in ("bot", "top"):
        new_p[key], new_a[key] = [], []
        for (w, b), (aw, ab) in zip(params[key], dense_acc[key]):
            gw, gb = next(it), next(it)
            aw, ab = aw + gw * gw, ab + gb * gb
            new_p[key].append((w - lr * gw / (torch.sqrt(aw) + eps),
                               b - lr * gb / (torch.sqrt(ab) + eps)))
            new_a[key].append((aw, ab))
    return new_p, new_a


def _rowwise_adagrad_scale(d_rows, acc_rows, lr_embeds: float, eps: float):
    """Row-wise AdaGrad on embedding rows (cdlrm_tpu
    ``_rowwise_adagrad_scale``, step.py:363-372; torchrec semantics): the
    state gains ``mean(g^2)`` per row, and the delta is ``(-lr / (sqrt(acc)
    + eps)) * g``. ``d_rows`` [U, D], ``acc_rows`` [U]. Returns (delta [U,
    D], new acc_rows [U]); a row with an exactly-zero gradient keeps its
    state and gets a zero delta."""
    acc_rows = acc_rows + torch.mean(d_rows * d_rows, dim=1)
    denom = torch.sqrt(acc_rows) + eps
    # a true division, as jnp's: ``float / tensor`` would multiply by the
    # reciprocal, one more rounding
    scale = torch.div(denom.new_full((), -lr_embeds), denom)
    return scale[:, None] * d_rows, acc_rows


@functools.lru_cache(maxsize=None)
def _md_mask(mask: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """``md_train_mask`` as a [T, 1, 1] float32 tensor on ``device``, copied
    there once."""
    return torch.tensor(mask, dtype=torch.float32, device=device)[:, None, None]


def _mean_over_ranks(group: DpGroup, grads, sums=(), skip=()):
    """One collective for a step: the mean over the ranks of every tensor of
    ``grads`` (but those at the positions in ``skip``, which stay local) and
    the sum of the scalars ``sums``, all on one flat float32 buffer with the
    scalars in its tail. Returns (grads, sums) as views of the reduced
    buffer, the same bits on every rank."""
    kept = [i for i in range(len(grads)) if i not in skip]
    flat = torch.cat([grads[i].reshape(-1) for i in kept]
                     + [v.reshape(1).to(torch.float32) for v in sums])
    group.all_reduce_sum(flat)
    n_sums = len(sums)
    body = flat[: flat.shape[0] - n_sums] / group.world_size
    out, pos = list(grads), 0
    for i in kept:
        n = grads[i].numel()
        out[i] = body[pos: pos + n].view(grads[i].shape)
        pos += n
    tail = flat[flat.shape[0] - n_sums:]
    return out, [tail[i] for i in range(n_sums)]


def _finish(cfg: StepConfig, params, dflat, p, loss, targets, lr, b_loc: int,
            dense_acc=None, group: Optional[DpGroup] = None,
            extra: Optional[list] = None):
    """The dense update, SGD or AdaGrad, and the step's metrics (cdlrm_tpu
    ``finish``, step.py:613-628). Returns (params, dense_acc, loss_sum,
    correct); ``dense_acc`` stays None under SGD.

    With a ``group`` of more than one rank the dense gradients become their
    mean over the ranks (cdlrm_tpu ``_sync_dense_grads``: ``md_proj``
    included, the biases left local under ``strict_bias_divergence``) and
    ``loss_sum`` and ``correct`` their sums, in one collective
    (:func:`_mean_over_ranks`); the tensors of the list ``extra`` (the
    full-table step's embedding gradients) are replaced in place by their
    means, taken in the same collective."""
    # torch.round, like jnp.round, rounds half to even
    correct = (torch.round(p) == targets).to(torch.float32).sum()
    loss_sum = loss * b_loc
    if group is not None and not group.single:
        n_dense = len(dflat)
        # the biases are the one-dimensional leaves (weights have two
        # dimensions, md_proj three)
        skip = ({i for i, g in enumerate(dflat) if g.dim() == 1}
                if cfg.strict_bias_divergence else ())
        synced, (loss_sum, correct) = _mean_over_ranks(
            group, list(dflat) + (extra or []), (loss_sum, correct), skip)
        dflat = synced[:n_dense]
        if extra:
            extra[:] = synced[n_dense:]
    if cfg.optimizer == "adagrad":
        params, dense_acc = _dense_adagrad(params, dflat, lr, dense_acc, cfg.adagrad_eps)
    else:
        dflat = list(dflat)
        if cfg.md_proj:
            # the identity projections of full-width tables stay frozen
            # (cdlrm_tpu _sync_dense_grads' md_mask, step.py:480-483)
            i = 2 * len(params["bot"])
            dflat[i] = dflat[i] * _md_mask(cfg.md_train_mask, dflat[i].device)
        params = dense_from_leaves(
            [w - lr * g for w, g in zip(param_leaves(params), dflat)], params
        )
    return params, dense_acc, loss_sum, correct


def _check_optimizer(cfg: StepConfig) -> None:
    if cfg.optimizer not in ("sgd", "adagrad"):
        raise ValueError(f"optimizer must be sgd|adagrad, got {cfg.optimizer!r}")
    if cfg.optimizer == "adagrad" and cfg.md_proj:
        # Config.finalize refuses it too: AdaGrad supports plain tables only
        raise ValueError("optimizer='adagrad' does not support md_proj")


def _mark_touched(touched: Optional[torch.Tensor], slots: torch.Tensor, trash_row: int) -> None:
    """Set the step's slots in the rank's touched-row mask ``[R]`` uint8 and
    clear the trash row (cdlrm_tpu step.py:702-704, :827-831, :896-900). On
    the dedup wires ``slots`` is the unique bucket, whose padding is the
    trash row. No mask (one replica): nothing to do."""
    if touched is None:
        return
    touched[slots.long()] = 1
    touched[trash_row] = 0


def _hot_cold_update(cache: torch.Tensor, touched: Optional[torch.Tensor],
                     flat_slots: torch.Tensor, drows: torch.Tensor, hot_slots: torch.Tensor,
                     lr_embeds: float, cfg: StepConfig, trash_row: int) -> None:
    """Hot-tier sparse SGD (cdlrm_tpu ``_hot_cold_update``, step.py:375-440):
    the sums of ``index_add_rows(cache, flat_slots, drows, -lr_embeds)`` in
    two row adds, H hot rows and ``cold_bucket`` cold lanes, in place.
    ``flat_slots`` [N] int32 is each lookup's cache row, ``drows`` [N, D] its
    gradient, ``hot_slots`` [H] int32 the window's sorted hot list, whose last
    position is the trash row (masked lanes are hot and carry zero gradient).
    The touched mask, when tracked, gains the rows that a hot or a cold lane
    updated, as ``.max`` does in cdlrm_tpu.

    Every add goes through ``index_add_rows``, the atomic kernel: the hot
    segment sum and the cold add have duplicate targets by nature, and so
    may the H-row apply. The host pads a short hot list with rows that
    descend from the trash row (CachedDlrmTrainer._apply_window_stats); past
    the last table's aux region they reach its way rows, where a selected
    hot row can sit twice in the list. ``scatter_add_rows`` assumes distinct
    rows and adds without atomics, so a repeated row could lose its real
    update in a read-modify-write race; a per-window host check would buy
    the distinct kernel at the price of a second code path for the same
    bytes. A repeated row's second position receives no lane (the search
    finds the first), so it adds exactly -0.0 in any order."""
    h = cfg.hot_rows
    n = flat_slots.shape[0]
    k = min(cfg.cold_bucket, n)  # a power-of-two bucket may round past N
    dev = cache.device
    flat_slots = flat_slots.contiguous()
    drows = drows.contiguous()
    zero = drows.new_zeros(())
    pos = torch.searchsorted(hot_slots, flat_slots).clamp_(max=h - 1)
    is_hot = hot_slots[pos] == flat_slots
    # trash-targeted lanes carry zero gradient: spread them over the H rows
    # (adding +0.0) rather than chain every one onto the trash position
    use_hot = is_hot & (flat_slots != trash_row)
    lanes = torch.arange(n, dtype=torch.int64, device=dev)
    hot_pos = torch.where(use_hot, pos, lanes % h).to(torch.int32)
    d_hot = torch.zeros((h, cache.shape[1]), dtype=torch.float32, device=dev)
    index_add_rows(d_hot, hot_pos, torch.where(use_hot[:, None], drows, zero))
    index_add_rows(cache, hot_slots, d_hot, alpha=-lr_embeds)
    # cold: a stable sort puts the cold lanes first in lane order (on an
    # integer view: no bool sort on the card); the bucket bounds their count,
    # and padding lanes add -0.0 to spread rows
    cold_idx = torch.argsort(is_hot.to(torch.int32), stable=True)[:k]
    cold_ok = ~is_hot[cold_idx]
    spread = (torch.arange(k, dtype=torch.int64, device=dev) % cache.shape[0]).to(torch.int32)
    cold_slots = torch.where(cold_ok, flat_slots[cold_idx], spread)
    cold_g = torch.where(cold_ok[:, None], gather_rows(drows, cold_idx.to(torch.int32)), zero)
    index_add_rows(cache, cold_slots, cold_g, alpha=-lr_embeds)
    if touched is not None:
        # ones only, at the used hot positions' rows and the valid cold lanes'
        # (the rest at the trash row, cleared after): duplicate indices then
        # never write a 0 over a 1
        hot_used = torch.zeros(h + 1, dtype=torch.uint8, device=dev)
        hot_used[torch.where(use_hot, pos, h)] = 1
        _mark_touched(touched, torch.cat([
            torch.where(hot_used[:h].bool(), hot_slots, trash_row),
            torch.where(cold_ok, cold_slots, trash_row),
        ]), trash_row)


def make_cached_train_step(
    geo: CacheGeometry, cfg: StepConfig, pooled_width: int = 0, block: int = 1,
    group: Optional[DpGroup] = None,
) -> Callable:
    """The cached train step of one rank (cdlrm_tpu make_cached_train_step,
    step.py:524; SGD, or AdaGrad on the dedup wire).

    Plain wire (``cfg.dedup`` off, ``body`` step.py:632)::

        step(params, cache, x, slots, ls_mask, aux_slots, aux_rows, targets,
             lr, lr_embeds) -> (params, cache, loss_sum, correct)

    Dedup wire (``body_dedup`` step.py:711), packed (``cfg.wire_pack``: a
    bitstream of ranks and of table-local unique ids) or unpacked (int32
    ranks and global unique rows)::

        step(params, cache, x, inv_wire, ls_mask, uniq_wire, uniq_counts,
             aux_slots, aux_rows, targets, lr, lr_embeds)
             -> (params, cache, loss_sum, correct)

    ``block`` > 1 is a scan block (cdlrm_tpu's ``lax.scan`` over ``block``
    steps): the per-batch inputs come flat, batch-major, and the step loops
    over them; ``loss_sum`` and ``correct`` come back stacked [block]::

        step(params, cache, *per_batch_inputs, lr, lr_embeds)
             -> (params, cache, loss_sum [block], correct [block])

    With ``cfg.block_coalesce`` (unpacked dedup wire, ``body_coalesce``
    step.py:841 and the flush :926-970) each batch's inputs carry its
    block-rank row ``uniq_blk`` after ``uniq_counts``
    (``CachedDlrmTrainer.interleave_block_inputs``), and the block's sorted
    union ``blk_slots`` [Pb] (trash-padded) and ``blk_counts`` [1] (its
    valid length) follow them::

        step(params, cache, *per_batch_inputs, blk_slots, blk_counts, lr,
             lr_embeds) -> (params, cache, loss_sum [block], correct [block])

    With ``cfg.hot_rows`` > 0 (SGD, single steps or scan blocks of either
    wire; cdlrm_tpu step.py:908-909) the window's hot list ``hot_slots`` [H]
    int32 rides after the per-batch inputs, before ``lr``, and the sparse
    update is :func:`_hot_cold_update`'s::

        step(params, cache, *per_batch_inputs, hot_slots, lr, lr_embeds)
             -> (params, cache, loss_sum, correct)

    With ``cfg.sorted_wire`` the unpacked dedup wire's unique list is
    ascending (:func:`_decode_dedup_raw`); the signature is the dedup wire's.

    With ``cfg.optimizer == 'adagrad'`` (dedup wire only, single steps or
    scan blocks) the optimizer state rides after the per-batch inputs,
    ``dense_acc`` (shaped like ``params``) and ``embed_acc`` ([R] float32,
    one row-wise accumulator per cache row), and comes back updated, as in
    cdlrm_tpu (step.py:555-558)::

        step(params, cache, *per_batch_inputs, dense_acc, embed_acc, lr,
             lr_embeds) -> (params, cache, dense_acc, embed_acc, loss_sum,
                            correct)

    ``params`` (and ``dense_acc``) come back as new dicts; the cache and
    ``embed_acc`` are updated in place, where cdlrm_tpu donates them;
    ``loss_sum`` and ``correct`` are device tensors, read by the caller when
    it needs them. ``lr`` and ``lr_embeds`` are Python floats already rounded
    to float32.

    Every form takes the keyword ``touched``: the rank's ``[R]`` uint8
    touched-row mask, set in place at the step's slots for the next aggregate
    step (cdlrm_tpu's ``track_touched``); None, the default, tracks nothing,
    as on one replica. With a ``group`` of more than one rank the inputs are
    the rank's slice of the batch, the dense gradients are averaged over the
    ranks and ``loss_sum`` and ``correct`` are summed over them, in one
    collective a step (:func:`_finish`); one replica has no collective."""
    _check_optimizer(cfg)
    adagrad = cfg.optimizer == "adagrad"
    if adagrad and not cfg.dedup:
        raise ValueError(
            "optimizer='adagrad' requires the dedup wire (duplicate-slot "
            "lookups must be coalesced before the row-wise state update); "
            "set dedup_lookups='on'"
        )
    hot = cfg.hot_rows > 0
    if adagrad and hot:
        raise ValueError("optimizer='adagrad' is incompatible with the hot tier")
    if cfg.block_coalesce:
        if block <= 1:
            raise ValueError("block_coalesce requires a scan block (block > 1)")
        if not cfg.dedup or cfg.wire_pack:
            raise ValueError("block_coalesce requires the UNPACKED dedup wire")
        if adagrad:
            raise ValueError("block_coalesce requires optimizer='sgd'")
        if hot:
            raise ValueError("block_coalesce is incompatible with the hot tier")
    trash = geo.trash_row
    offsets = _TableOffsets(geo)

    value_and_grad = functools.partial(_value_and_grad, cfg, pooled_width)

    def body(params, cache, x, slots, ls_mask, aux_slots, aux_rows, targets, *tail,
             touched=None):
        if hot:
            hot_slots, lr, lr_embeds = tail
        else:
            lr, lr_embeds = tail
        x = _upcast_x(x, cfg.cdtype)
        b_loc = targets.shape[0]
        if cfg.wire_pack:
            n_lk = b_loc * max(1, pooled_width)
            slots = _unpack_slots(slots, offsets(slots.device), trash, cfg.wire_bits, n_lk)
        targets = targets.to(torch.float32)
        t_count = slots.shape[0]
        _stage_aux(cache, aux_slots, aux_rows, trash)
        flat_slots = slots.reshape(-1)
        rows = gather_rows(cache, flat_slots).requires_grad_()
        loss, p, dflat, drows = value_and_grad(
            params, rows, lambda r: r, x, ls_mask, targets, t_count, b_loc
        )
        if hot:
            _hot_cold_update(cache, touched, flat_slots, drows, hot_slots, lr_embeds, cfg,
                             trash)
        else:
            # sparse SGD: the atomic row add sums duplicate slots (DESIGN.md
            # D3). Masked multi-hot lanes all carry slot=trash with exactly
            # zero gradient: spread them across rows (-0.0 is the float
            # identity) rather than chain every one of them onto the trash
            # row's atomics
            upd_slots = flat_slots
            if pooled_width > 0:
                spread = (
                    torch.arange(flat_slots.shape[0], dtype=torch.int64, device=cache.device)
                    % cache.shape[0]
                ).to(torch.int32)
                upd_slots = torch.where(flat_slots == trash, spread, flat_slots)
            index_add_rows(cache, upd_slots, drows.contiguous(), alpha=-lr_embeds)
            _mark_touched(touched, flat_slots, trash)
        params, _, loss_sum, correct = _finish(
            cfg, params, dflat, p, loss, targets, lr, b_loc, group=group)
        return params, cache, loss_sum, correct

    def decode(inv_wire, uniq_wire, uniq_counts, n_lk):
        if cfg.wire_pack:
            return _decode_dedup(
                inv_wire, uniq_wire, uniq_counts, offsets(inv_wire.device), trash,
                cfg.inv_bits, cfg.uniq_bits, n_lk,
            )
        return _decode_dedup_raw(inv_wire, uniq_wire, uniq_counts, cfg.sorted_wire)

    def body_dedup(params, cache, x, inv_wire, ls_mask, uniq_wire, uniq_counts,
                   aux_slots, aux_rows, targets, *tail, touched=None):
        dense_acc = None
        if hot:
            hot_slots, lr, lr_embeds = tail
        elif adagrad:
            dense_acc, embed_acc, lr, lr_embeds = tail
        else:
            lr, lr_embeds = tail
        x = _upcast_x(x, cfg.cdtype)
        b_loc = targets.shape[0]
        n_lk = b_loc * max(1, pooled_width)
        targets = targets.to(torch.float32)
        t_count = inv_wire.shape[0]
        _stage_aux(cache, aux_slots, aux_rows, trash)
        uniq_slots, ginv = decode(inv_wire, uniq_wire, uniq_counts, n_lk)
        if hot:
            # the hot tier differentiates with respect to the expanded rows:
            # per-lookup gradients, split hot and cold by each lookup's
            # resolved row (cdlrm_tpu step.py:762-776)
            rows_exp = gather_rows(gather_rows(cache, uniq_slots), ginv).requires_grad_()
            loss, p, dflat, drows = value_and_grad(
                params, rows_exp, lambda r: r, x, ls_mask, targets, t_count, b_loc
            )
            _hot_cold_update(cache, touched, uniq_slots[ginv.long()], drows, hot_slots,
                             lr_embeds, cfg, trash)
        else:
            rows_u = gather_rows(cache, uniq_slots).requires_grad_()  # [Ub, D]
            # the expand's backward (gather_rows' index_add_rows) segment-sums
            # duplicate-lookup gradients into [Ub, D], as the take's
            # transpose does in cdlrm_tpu (step.py:779-787)
            loss, p, dflat, d_rows_u = value_and_grad(
                params, rows_u, lambda r: gather_rows(r, ginv), x, ls_mask, targets,
                t_count, b_loc,
            )
            if adagrad:
                # the row-wise state rides along at the same unique slots
                # (cdlrm_tpu step.py:789-803). The bucket repeats the trash
                # row in its padding (and at position 0 of the default
                # layout); those lanes carry exactly zero gradients, so each
                # duplicate writes the same value, the trash row's state
                # unchanged (+ mean(0^2))
                u_idx = uniq_slots.long()
                delta, acc_rows = _rowwise_adagrad_scale(
                    d_rows_u, embed_acc[u_idx], lr_embeds, cfg.adagrad_eps
                )
                embed_acc[u_idx] = acc_rows
            else:
                delta = -lr_embeds * d_rows_u
            # valid unique rows are a prefix of the bucket, the count on the
            # device: [trash, uniq..., trash-pad] (position 0's delta is the
            # masked lanes' gradient, exactly zero), or on the sorted wire
            # [uniq..., trash-pad] (cdlrm_tpu step.py:812-818)
            nv = uniq_counts.sum() + (0 if cfg.sorted_wire else 1)
            scatter_add_rows(cache, uniq_slots, delta, nv)
            _mark_touched(touched, uniq_slots, trash)
        params, dense_acc, loss_sum, correct = _finish(
            cfg, params, dflat, p, loss, targets, lr, b_loc, dense_acc, group
        )
        if adagrad:
            return params, cache, dense_acc, embed_acc, loss_sum, correct
        return params, cache, loss_sum, correct

    def body_coalesce(params, cache, pend, x, inv_wire, ls_mask, uniq_wire,
                      uniq_counts, uniq_blk, aux_slots, aux_rows, targets, lr,
                      lr_embeds, touched=None):
        """One step of a coalesced block: the forward reads the effective
        weight w_eff = cache - lr * pending, the per-lookup gradients go into
        the pending buffer, and the cache is written only by the aux staging;
        the block's flush applies the pending rows."""
        x = _upcast_x(x, cfg.cdtype)
        b_loc = targets.shape[0]
        targets = targets.to(torch.float32)
        t_count = inv_wire.shape[0]
        p_trash = pend.shape[0] - 1  # host contract: the last pending row
        _stage_aux(cache, aux_slots, aux_rows, trash)
        uniq_slots, ginv = _decode_dedup_raw(inv_wire, uniq_wire, uniq_counts, cfg.sorted_wire)
        rows_u = gather_rows(cache, uniq_slots)  # [Ub, D]
        # the block's not yet flushed updates live in pending; pad, aux and
        # trash ranks read the pending trash row, which stays exactly +0.0
        w_eff = rows_u - lr_embeds * gather_rows(pend, uniq_blk)
        # the leaf is the expanded [N, D] rows, as cdlrm_tpu differentiates
        # (step.py:883-887): the per-lookup gradient goes straight into
        # pending, with no [Ub, D] segment sum
        rows_exp = gather_rows(w_eff, ginv).requires_grad_()
        loss, p, dflat, drows = value_and_grad(
            params, rows_exp, lambda r: r, x, ls_mask, targets, t_count, b_loc
        )
        blk_rank = uniq_blk[ginv.long()]  # [N] per-lookup block ranks
        # aux, trash and masked lanes carry rank p_trash: zero their
        # gradients so the pending trash row stays +0.0. Every such lane's
        # add lands on that one row
        d_eff = drows * (blk_rank != p_trash)[:, None].to(drows.dtype)
        index_add_rows(pend, blk_rank, d_eff)
        _mark_touched(touched, uniq_slots, trash)
        params, _, loss_sum, correct = _finish(
            cfg, params, dflat, p, loss, targets, lr, b_loc, group=group)
        return params, cache, pend, loss_sum, correct

    if cfg.block_coalesce:
        n_in = 9  # the dedup wire's 8 per-batch inputs + uniq_blk

        def coalesced_block(params, cache, *rest, touched=None):
            *flat, blk_slots, blk_counts, lr, lr_embeds = rest
            if len(flat) != block * n_in:
                raise ValueError(f"{len(flat)} block inputs, want {block} x {n_in}")
            pend = torch.zeros((blk_slots.shape[0], cache.shape[1]), dtype=torch.float32,
                               device=cache.device)
            losses, corrs = [], []
            for j in range(block):
                params, cache, pend, loss_sum, correct = body_coalesce(
                    params, cache, pend, *flat[j * n_in: (j + 1) * n_in], lr, lr_embeds,
                    touched=touched,
                )
                losses.append(loss_sum)
                corrs.append(correct)
            # the flush: one row add of the sorted union's distinct prefix
            # (cdlrm_tpu's Pallas branch, step.py:953-961). Rows past it are
            # never touched, where cdlrm_tpu's XLA form adds -0.0 to spread
            # rows (:962-969): value-identical
            scatter_add_rows(cache, blk_slots, -lr_embeds * pend,
                             blk_counts[:1].to(torch.int64))
            return params, cache, torch.stack(losses), torch.stack(corrs)

        return coalesced_block
    single = body_dedup if cfg.dedup else body
    if block == 1:
        return single
    n_in = 8 if cfg.dedup else 6

    n_state = 2 if adagrad else 0
    n_extra = n_state + (1 if hot else 0)

    def scanned(params, cache, *rest, touched=None):
        # after the per-batch inputs: the window's hot list, the same for
        # every step, or the optimizer state, carried through the block as
        # cdlrm_tpu's scan carries it (step.py:1009-1043)
        flat, extra, (lr, lr_embeds) = rest[: -2 - n_extra], rest[-2 - n_extra: -2], rest[-2:]
        hot_in, state = extra[: len(extra) - n_state], extra[len(extra) - n_state:]
        if len(flat) != block * n_in:
            raise ValueError(f"{len(flat)} block inputs, want {block} x {n_in}")
        losses, corrs = [], []
        for j in range(block):
            params, cache, *out = single(
                params, cache, *flat[j * n_in: (j + 1) * n_in], *hot_in, *state, lr, lr_embeds,
                touched=touched,
            )
            *state, loss_sum, correct = out
            losses.append(loss_sum)
            corrs.append(correct)
        return (params, cache, *state, torch.stack(losses), torch.stack(corrs))

    return scanned


def make_cached_eval_step(
    geo: CacheGeometry, cfg: StepConfig, pooled_width: int = 0
) -> Callable:
    """Forward-only cached step (cdlrm_tpu make_cached_eval_step):
    ``step(params, cache, x, slots, ls_mask, aux_slots, aux_rows) ->
    (cache, scores [B, 1])``.

    It stages the batch's miss rows into the aux region, gathers every
    lookup's row, sums pooled bags under their mask, and runs the dense
    forward. The cache is updated in place, where cdlrm_tpu donates it
    (step.py:1171): the aux region is the only part written, and every batch
    overwrites it anyway. ``ls_mask`` is read only for pooled bags."""
    cdtype = cfg.cdtype
    offsets = _TableOffsets(geo)

    def step(params, cache, x, slots, ls_mask, aux_slots, aux_rows):
        x = _upcast_x(x, cdtype)
        b_loc = x.shape[0]
        if cfg.wire_pack:
            n_lk = b_loc * max(1, pooled_width)
            slots = _unpack_slots(slots, offsets(slots.device), geo.trash_row,
                                  cfg.wire_bits, n_lk)
        t_count = slots.shape[0]
        _stage_aux(cache, aux_slots, aux_rows, geo.trash_row)
        rows = gather_rows(cache, slots.reshape(-1))
        ly = _pool(rows, ls_mask, t_count, b_loc, cache.shape[-1], pooled_width)
        if cfg.md_proj:
            ly = _apply_md_proj(ly, params["md_proj"], cdtype)
        p = dlrm_forward(
            params, x, ly, cfg.interaction_op, cfg.interaction_itself,
            cfg.loss_threshold, cdtype,
        )
        return cache, p

    return step


def make_refill_step(cfg: StepConfig, trash_row: int,
                     group: Optional[DpGroup] = None) -> Callable:
    """Refill (cdlrm_tpu make_refill_step, step.py:1174-1292)::

        SGD:          step(cache, insert_slots, insert_rows, evict_slots)
                          -> (cache, evicted [E, D])
        AdaGrad:      step(..., evict_slots, accum) -> (cache, accum, evicted)
        master state: step(..., evict_slots, accum, insert_acc)
                          -> (cache, accum, evicted, ev_acc [E])

    The evicted rows (and, with ``adagrad_master_state``, their row-wise
    state) are gathered before the insert, so they carry the values to write
    back; then the insert sets its rows in place, and the inserted slots'
    state becomes ``insert_acc`` (the ids' state from the host store), or 0
    under plain AdaGrad, where an inserted slot holds a fresh id. With
    ``cfg.wire_rows_bf16`` the insert rows arrive as bfloat16 and the
    evicted rows leave as bfloat16 (cdlrm_tpu step.py:1223-1240). Both slot
    buffers are padded to a power-of-two bucket on the host: insert padding
    targets the trash row (outside the rows' valid prefix, so never written;
    its state is set to the padding's 0, which it already holds), evict
    padding reads row 0 and is discarded by the caller. ``accum`` is updated
    in place.

    ``cfg.refill_broadcast`` (``True`` reads as strict, ``False`` as off)
    with a ``group`` of more than one rank: under ``strict`` and ``delta``
    the evicted rows, and their state under the master state, become rank
    0's before the bfloat16 cast, so every rank writes the same values back
    to its masters; under ``strict`` the whole cache, and ``accum`` under
    AdaGrad, become rank 0's after the insert (the reference's whole-cache
    broadcast). ``delta`` relies on the insert buffer being the same on
    every rank. ``off`` has no collective; one replica needs none."""
    mode = {True: "strict", False: "off"}.get(cfg.refill_broadcast, cfg.refill_broadcast)
    if mode not in ("strict", "delta", "off"):
        raise ValueError(f"unsupported refill_broadcast mode: {mode!r}")
    if group is None or group.single:
        mode = "off"  # every refill collective is the identity
    _check_optimizer(cfg)
    adagrad = cfg.optimizer == "adagrad"
    master_state = adagrad and cfg.adagrad_master_state

    def step(cache, insert_slots, insert_rows, evict_slots, accum=None, insert_acc=None):
        evicted = gather_rows(cache, evict_slots)
        ev_acc = accum[evict_slots.long()] if master_state else None
        if mode != "off":
            group.broadcast_from0(evicted)
            if master_state:
                group.broadcast_from0(ev_acc)
        if cfg.wire_rows_bf16:
            # the writeback's device-to-host copy moves half the bytes; the
            # evicted accumulators stay float32
            evicted = evicted.to(torch.bfloat16)
        # inserts never target the trash row, so the valid prefix is
        # countable on the device (cdlrm_tpu step.py:1229-1237). Rows of the
        # bfloat16 row wire are widened first: the kernel takes float32 rows
        nv_ins = (insert_slots != trash_row).sum()
        scatter_set_rows(cache, insert_slots, insert_rows.to(torch.float32), nv_ins)
        if master_state:
            accum[insert_slots.long()] = insert_acc
        elif adagrad:
            accum[insert_slots.long()] = 0.0
        if mode == "strict":
            group.broadcast_from0(cache)
            if adagrad:
                group.broadcast_from0(accum)
        if master_state:
            return cache, accum, evicted, ev_acc
        if adagrad:
            return cache, accum, evicted
        return cache, evicted

    return step


def union_slots(flags: torch.Tensor, k: int, trash_row: int):
    """Compact a ``[R]`` bool mask to its set rows in ascending order, as an
    int32 ``[k]`` list padded with ``trash_row``, and their count (an int64
    tensor on the device, at most k): ``jnp.nonzero(size=k, fill_value=...)``
    with a static shape, so the host never waits for the device. Row i of the
    mask goes to position (number of set rows before it); every other row,
    and anything past the bucket, to a spare last position that is cut off."""
    n_rows = flags.shape[0]
    pos = torch.cumsum(flags, 0) - 1
    dest = torch.where(flags & (pos < k), pos, k)
    idx = torch.full((k + 1,), trash_row, dtype=torch.int32, device=flags.device)
    idx.scatter_(0, dest, torch.arange(n_rows, dtype=torch.int32, device=flags.device))
    return idx[:k].contiguous(), flags.sum().clamp(max=k)


def make_aggregate_step(cfg: StepConfig, group: DpGroup, union_bucket: Optional[int] = None,
                        trash_row: int = 0) -> Callable:
    """The periodic touched-row aggregation (cdlrm_tpu make_aggregate_step,
    step.py:1295-1409)::

        SGD:     step(cache, touched) -> (cache, touched)
        AdaGrad: step(cache, touched, accum) -> (cache, touched, accum)

    The union of the rows that any rank touched since the last aggregation
    (the maximum of the ranks' ``[R]`` uint8 masks) takes, on every rank,
    the combination of all ranks' current values: ``sum``, ``mean`` (the sum
    over the world size: every rank contributes, touched or not) or ``max``
    (``cfg.table_agg_op``). Rows outside the union keep the rank's own
    value. Under AdaGrad the row-wise state combines with the same op at the
    same rows. All three tensors are updated in place and the mask comes
    back cleared.

    ``union_bucket`` = k selects the sparse exchange: the union is compacted
    to a ``[k]`` slot list in ascending order, padded with the trash row,
    and only those rows ride the collective. The list has a static shape
    (:func:`union_slots`), so the host never waits for the device, and every
    rank builds the same list from the same union. The rows are read with ``gather_rows`` and written
    back with ``scatter_set_rows``, whose valid prefix is the union count, a
    device int64 tensor: the padding is never written. The caller keeps the
    union within the bucket (CachedDlrmTrainer picks it from the exact
    bound). ``union_bucket=None`` is the dense form: one masked all-reduce
    of the whole ``[R, D]`` cache, cheaper in bytes when the bound nears R."""
    op = cfg.table_agg_op
    if op not in ("sum", "mean", "max"):
        raise ValueError(f"unsupported table_agg_op: {op}")
    adagrad = cfg.optimizer == "adagrad"

    def combine(t):
        if op == "max":
            return group.all_reduce_max(t)
        group.all_reduce_sum(t)
        return t / group.world_size if op == "mean" else t

    def union_of(touched):
        return group.all_reduce_max(touched.clone())

    if union_bucket is not None:
        k = int(union_bucket)

        def step(cache, touched, accum=None):
            idx, count = union_slots(union_of(touched) != 0, k, trash_row)
            agg_rows = combine(gather_rows(cache, idx))
            scatter_set_rows(cache, idx, agg_rows, count)
            touched.zero_()
            if adagrad:
                # the padding repeats the trash row: every copy writes the
                # same combined value of its (meaningless) state
                at = idx.long()
                accum[at] = combine(accum[at])
                return cache, touched, accum
            return cache, touched

        return step

    fill = float("-inf") if op == "max" else 0.0

    def step_dense(cache, touched, accum=None):
        flags = union_of(touched) != 0
        mask = flags[:, None]
        agg = combine(torch.where(mask, cache, fill))
        cache.copy_(torch.where(mask, agg, cache))
        touched.zero_()
        if adagrad:
            acc_agg = combine(torch.where(flags, accum, fill))
            accum.copy_(torch.where(flags, acc_agg, accum))
            return cache, touched, accum
        return cache, touched

    return step_dense


# --------------------------------------------------------------------------
# full-table (uncached) steps: small configs, tests, and the oracle
# --------------------------------------------------------------------------


def make_fulltable_train_step(cfg: StepConfig, pooled: bool = False,
                              group: Optional[DpGroup] = None) -> Callable:
    """Train step with the full embedding tables on the device (cdlrm_tpu
    make_fulltable_train_step, step.py:1417)::

        SGD:     step(params, tables, offsets, x, ls_i, ls_mask, targets, lr,
                      lr_embeds, entries=None, global_ids=None)
                      -> (params, tables, loss_sum, correct)
        AdaGrad: step(params, tables, offsets, x, ls_i, ls_mask, targets,
                      dense_acc, emb_acc, lr, lr_embeds)
                      -> (params, tables, dense_acc, emb_acc, loss_sum, correct)

    ``tables`` is the flat ``[sum(n), D]`` float32 tensor of
    models/embedding.py, updated in place; ``offsets`` its int64 [T] table
    starts on the device; ``ls_i`` table-local ids [T, B] (or [T, B, P] with
    ``ls_mask`` when ``pooled``). cdlrm_tpu differentiates every table
    whole, a dense ``[n, D]`` gradient per table, and applies ``w - lr * g``
    to every row. The step here gathers each distinct row of the batch once
    (the leaf), expands it to the lookups with ``gather_rows`` (whose
    backward, ``index_add_rows``, sums each row's lookup gradients in lookup
    order, as the dense gradient's scatter does), and adds ``-lr * g`` to
    those rows only with ``scatter_add_rows``: the same one subtraction of a
    summed gradient per row, and rows the batch does not touch stay as they
    are, as ``w - lr * 0`` leaves them.

    With QR or mixed-dimension tables (SGD only) ``entries`` is the
    per-table list of models/embedding.py::init_embedding_tables: None for a
    plain table, whose rows live in ``tables`` (``offsets`` then has one
    start per plain table) and keep the distinct-row update above, else the
    table's ``QRParams`` or ``MDParams``. A compressed table's tensors are
    small by construction and take cdlrm_tpu's own update: each lookup goes
    through ``gather_rows``, whose backward accumulates the dense ``[n, d]``
    gradient, and ``w -= lr_embeds * g`` is applied to the whole tensor, in
    place; an MD projection trains with ``lr_embeds`` too, as a leaf of
    cdlrm_tpu's ``params["emb"]`` does.

    AdaGrad holds one flat ``[sum(n)]`` row-wise accumulator ``emb_acc``
    (updated in place) beside the dense ``dense_acc``, and scales the
    distinct rows' gradients with ``_rowwise_adagrad_scale`` before the same
    row add. cdlrm_tpu scales every row of each table, but an untouched row
    has g = 0: its state stays ``acc + 0`` and its delta is 0, so the two
    agree.

    With a ``group`` of more than one rank (fully synchronous data
    parallelism, cdlrm_tpu step.py:1420-1425: dense and embedding gradients
    are both averaged) ``x``, ``ls_i``, ``ls_mask`` and ``targets`` are the
    rank's slice of the batch and ``global_ids`` the whole batch's ids
    ``[T, B_glob(, P)]``, which every rank streams. The distinct rows of the
    whole batch are therefore the same sorted list on every rank without
    talking; the rank's gradient is segment-summed into that ``[U_glob, D]``
    leaf by the expand's backward (``index_add_rows``), and one collective
    takes the mean of it, of the compressed tables' tensors and of the dense
    gradients, and the metrics' sums (:func:`_finish`). Every rank then
    applies the same update to its replica of the tables."""
    _check_optimizer(cfg)
    adagrad = cfg.optimizer == "adagrad"
    many = group is not None and not group.single

    def step(params, tables, offsets, x, ls_i, ls_mask, targets, *tail, entries=None,
             global_ids=None):
        if adagrad:
            dense_acc, emb_acc, lr, lr_embeds = tail
        else:
            (lr, lr_embeds), dense_acc = tail, None
        compressed = [e for e in entries or () if e is not None]
        if compressed and adagrad:
            raise ValueError("optimizer='adagrad' supports plain embeddings only")
        t_count, b_loc = ls_i.shape[:2]
        # bags are pooled where the lookups have a P axis, as cdlrm_tpu's
        # embedding_forward decides by the index rank
        pooled_width = ls_i.shape[2] if pooled and ls_i.dim() == 3 else 0
        targets = targets.to(torch.float32)
        if many and global_ids is None:
            raise ValueError("a data-parallel full-table step needs global_ids")
        plain = [t for t, e in enumerate(entries) if e is None] if compressed else None
        plain_ids = ls_i if plain is None else ls_i[plain]
        leaves = []
        if plain_ids.shape[0]:
            # torch.unique waits for the device (its output size is data
            # dependent): acceptable for the full-table trainer, an oracle
            # and a small-config path, not for the cached hot loop
            if many:
                all_ids = global_ids if plain is None else global_ids[plain]
                uniq = torch.unique(global_rows(all_ids, offsets))  # sorted
                inv = torch.searchsorted(uniq, global_rows(plain_ids, offsets))
            else:
                uniq, inv = torch.unique(global_rows(plain_ids, offsets), return_inverse=True)
            inv = inv.to(torch.int32)
            leaves.append(gather_rows(tables, uniq).requires_grad_())  # rows_u [U, D]
        n_plain = len(leaves)
        leaves += [w.detach().requires_grad_() for e in compressed for w in e.leaves()]

        def expand(lv):
            if not compressed:
                return gather_rows(lv[0], inv)
            it = iter(lv[n_plain:])
            live = [e if e is None else e.with_leaves([next(it) for _ in e.leaves()])
                    for e in entries]
            return lookup_rows(live, lambda _ids: gather_rows(lv[0], inv), ls_i)

        loss, p, dflat, dleaves = _value_and_grad(
            cfg, pooled_width, params, leaves, expand, x, ls_mask, targets, t_count, b_loc,
        )
        # the dense update first: with more than one rank its collective
        # also averages the embedding gradients, in place in ``dleaves``
        params, dense_acc, loss_sum, correct = _finish(
            cfg, params, dflat, p, loss, targets, lr, b_loc, dense_acc, group, dleaves
        )
        if n_plain:
            d_rows_u = dleaves[0]
            if adagrad:
                u_idx = uniq.long()
                delta, acc_rows = _rowwise_adagrad_scale(
                    d_rows_u, emb_acc[u_idx], lr_embeds, cfg.adagrad_eps
                )
                emb_acc[u_idx] = acc_rows
            else:
                delta = -lr_embeds * d_rows_u
            nv = torch.full((1,), uniq.shape[0], dtype=torch.int64, device=tables.device)
            scatter_add_rows(tables, uniq, delta, nv)
        grads = iter(dleaves[n_plain:])
        for e in compressed:
            for w in e.leaves():
                w.sub_(lr_embeds * next(grads))
        if adagrad:
            return params, tables, dense_acc, emb_acc, loss_sum, correct
        return params, tables, loss_sum, correct

    return step


def make_fulltable_eval_step(cfg: StepConfig, pooled: bool = False) -> Callable:
    """Forward-only full-table step (cdlrm_tpu make_fulltable_eval_step,
    step.py:1504): ``step(params, tables, offsets, x, ls_i, ls_mask,
    entries=None) -> scores [B, 1]``; ``entries`` as for the train step."""

    def step(params, tables, offsets, x, ls_i, ls_mask, entries=None):
        ly = embedding_forward(tables, offsets, ls_i, ls_mask if pooled else None, entries)
        return dlrm_forward(
            params, x, ly, cfg.interaction_op, cfg.interaction_itself,
            cfg.loss_threshold, cfg.cdtype,
        )

    return step
