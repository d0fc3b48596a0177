"""Device steps of the cached serving path, the counterpart of
cdlrm_tpu/train/step.py: the cached eval step, the refill step, and the
slot wire they read.

Each step is a plain function over tensors on one device. PyTorch runs
eagerly, so there is no jit; the cache is updated in place where cdlrm_tpu
donates it. On a CUDA device the row moves run the hand-written kernels
(ops/lookup.py, ops/scatter.py); on the CPU their plain versions.

cdlrm_tpu's ``use_pallas_lookup``, ``use_pallas_scatter`` and
``pallas_interpret`` choose between XLA ops and Pallas kernels on the TPU;
here the hand-written kernel is the only path on the card, so the port has no
such switches and ignores those config fields.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from cdlrm_tpu.cache.geometry import CacheGeometry
from cdlrm_tpu_torch.models.dlrm import dlrm_forward
from cdlrm_tpu_torch.ops.lookup import gather_rows
from cdlrm_tpu_torch.ops.scatter import scatter_set_rows


class StepConfig(NamedTuple):
    """The cdlrm_tpu StepConfig fields that the serving path reads, under the
    same names."""

    interaction_op: str = "dot"
    interaction_itself: bool = False
    loss_threshold: float = 0.0
    # one device: the refill has no collective ('off'); 'strict' and 'delta'
    # broadcast between replicas and come with multi-GPU data parallelism
    refill_broadcast: str = "off"
    compute_dtype: Optional[str] = None  # None/'float32' | 'bfloat16'
    # slots arrive as a [T, BYTES] uint8 bitstream of wire_bits-wide
    # table-local ids (pack_slots), unpacked on the device
    wire_pack: bool = False
    wire_bits: int = 24  # == WIRE_MAX_BITS
    optimizer: str = "sgd"

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
    offsets: dict = {}  # device -> int32 [T] table offsets, built once

    def step(params, cache, x, slots, ls_mask, aux_slots, aux_rows):
        b_loc = x.shape[0]
        if cfg.wire_pack:
            offs = offsets.get(slots.device)
            if offs is None:
                offs = offsets[slots.device] = torch.as_tensor(
                    geo.table_offsets, dtype=torch.int32, device=slots.device
                )
            n_lk = b_loc * max(1, pooled_width)
            slots = _unpack_slots(slots, offs, geo.trash_row, cfg.wire_bits, n_lk)
        t_count = slots.shape[0]
        d = cache.shape[-1]
        # valid prefix counted on the device: the aux bucket is padded with
        # the trash row, which no miss is ever staged into
        nv_aux = (aux_slots != geo.trash_row).sum()
        scatter_set_rows(cache, aux_slots, aux_rows, nv_aux)
        rows = gather_rows(cache, slots.reshape(-1))
        if pooled_width > 0:
            r = rows.reshape(t_count, b_loc, pooled_width, d)
            ly = torch.sum(r * ls_mask[..., None].to(r.dtype), dim=2)
        else:
            ly = rows.reshape(t_count, b_loc, d)
        p = dlrm_forward(
            params, x, ly, cfg.interaction_op, cfg.interaction_itself,
            cfg.loss_threshold, cdtype,
        )
        return cache, p

    return step


def make_refill_step(cfg: StepConfig, trash_row: int) -> Callable:
    """Refill (cdlrm_tpu make_refill_step, ``off`` mode with SGD):
    ``step(cache, insert_slots, insert_rows, evict_slots) -> (cache,
    evicted [E, D])``. The evicted rows are gathered before the insert, so
    they carry the values to write back; then the insert sets its rows in
    place. Both slot buffers are padded to a power-of-two bucket on the host:
    insert padding targets the trash row (outside the valid prefix, so never
    written), evict padding reads row 0 and is discarded by the caller."""
    if cfg.refill_broadcast not in ("off", False):
        raise NotImplementedError(
            f"refill_broadcast={cfg.refill_broadcast!r} broadcasts between "
            "replicas: multi-GPU data parallelism, ROADMAP.md queue 1"
        )
    if cfg.optimizer != "sgd":
        raise NotImplementedError(
            f"optimizer={cfg.optimizer!r}: the refill of row-wise AdaGrad "
            "state comes with the AdaGrad port, ROADMAP.md queue 1"
        )

    def step(cache, insert_slots, insert_rows, evict_slots):
        evicted = gather_rows(cache, evict_slots)
        # inserts never target the trash row, so the valid prefix is
        # countable on the device (cdlrm_tpu step.py:1229-1237)
        nv_ins = (insert_slots != trash_row).sum()
        scatter_set_rows(cache, insert_slots, insert_rows, nv_ins)
        return cache, evicted

    return step
