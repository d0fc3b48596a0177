"""The data-parallel process group, the counterpart of
cdlrm_tpu/parallel/mesh.py.

cdlrm_tpu is a single controller over a 1-D ``'dp'`` mesh, and its
collectives are ``psum``/``pmax`` inside ``shard_map``. Here data parallelism
is one process per device on ``torch.distributed``: every rank streams the
same index stream, keeps the same cache metadata, holds one full cache
replica on its own device and feeds the slice ``[r*b_loc, (r+1)*b_loc)`` of
every batch. What cdlrm_tpu keeps as one flat ``[ndev*R, ...]`` array is
simply the rank's own ``[R, ...]`` tensor. So this module is a small
process-group helper, not a sharding library: :class:`DpGroup` carries the
rank, the world size and the group, and offers the three collectives the
steps use on device tensors (sum, max, broadcast from rank 0) plus two host
gathers: to rank 0 for the checkpoint, and to every rank for the multi-host
row exchanges (parallel/multihost.py).

The backend is explicit, never found by catching a failure: ``nccl`` when
each rank has its own CUDA device, ``gloo`` for CPU tensors, and ``gloo``
for CUDA tensors only when the caller asks for it by name (ranks that share
one card cannot form an NCCL group). gloo reduces and broadcasts CUDA
tensors by staging them through the host, and has neither a bool nor a
bfloat16 reduction: masks travel as uint8. A world size of 1 needs no
process group and creates none.
"""

from __future__ import annotations

import datetime
import gc
import sys
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class DpGroup:
    """One rank's view of the data-parallel group. With ``world_size == 1``
    there is no process group and every collective is the identity."""

    def __init__(self, rank: int = 0, world_size: int = 1, group=None,
                 backend: Optional[str] = None, host_group=None):
        self.rank = rank
        self.world_size = world_size
        self.group = group
        self.backend = backend
        # the group that moves CPU tensors (checkpoint blocks): the group
        # itself on gloo, a gloo group beside an NCCL one
        self.host_group = host_group if host_group is not None else group

    @property
    def single(self) -> bool:
        return self.world_size == 1

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns ``t``."""
        if not self.single:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Element-wise maximum of ``t`` over the ranks, in place."""
        if not self.single:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast_from0(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` becomes rank 0's, in place."""
        if not self.single:
            dist.broadcast(t, src=0, group=self.group)
        return t

    def gather_batch_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-sized row blocks ``[n, ...]`` in rank order,
        ``[world_size*n, ...]`` on every rank. A sum of zero-padded blocks:
        gloo gathers no CUDA tensors, and ``x + 0`` is exact."""
        if self.single:
            return local
        n = local.shape[0]
        out = local.new_zeros((self.world_size * n,) + tuple(local.shape[1:]))
        out[self.rank * n: (self.rank + 1) * n] = local
        return self.all_reduce_sum(out)

    def gather_host_to0(self, block: np.ndarray) -> Optional[List[np.ndarray]]:
        """Rank 0 gets every rank's equal-shaped numpy ``block`` in rank
        order (its own first); the other ranks get None. The blocks travel
        over the host group as CPU tensors."""
        if self.single:
            return [block]
        # bool has no gloo transport: masks go as uint8
        as_bool = block.dtype == np.bool_
        src = torch.from_numpy(np.ascontiguousarray(block.view(np.uint8) if as_bool else block))
        out = [torch.empty_like(src) for _ in range(self.world_size)] if self.rank == 0 else None
        dist.gather(src, out, dst=0, group=self.host_group)
        if out is None:
            return None
        return [t.numpy().view(np.bool_) if as_bool else t.numpy() for t in out]

    def all_gather_host(self, block: np.ndarray) -> np.ndarray:
        """Every rank's equal-shaped numpy ``block``, stacked ``[world, ...]``
        in rank order, on every rank (cdlrm_tpu's
        ``multihost_utils.process_allgather``). The blocks travel over the
        host group as CPU tensors; with one rank it is ``block[None]``."""
        if self.single:
            return np.ascontiguousarray(block)[None]
        as_bool = block.dtype == np.bool_
        src = torch.from_numpy(np.ascontiguousarray(block.view(np.uint8) if as_bool else block))
        out = torch.empty((self.world_size,) + tuple(src.shape), dtype=src.dtype)
        dist.all_gather(list(out.unbind(0)), src, group=self.host_group)
        got = out.numpy()
        return got.view(np.bool_) if as_bool else got

    def barrier(self) -> None:
        if not self.single:
            dist.barrier(group=self.host_group)


def make_dp_mesh(world_size: int = 1, rank: Optional[int] = None, *,
                 init_method: Optional[str] = None, backend: Optional[str] = None,
                 device=None, timeout_s: float = 1800.0) -> DpGroup:
    """The group of a ``world_size``-way data-parallel run.

    ``world_size == 1``: a :class:`DpGroup` without a process group; nothing
    of ``torch.distributed`` is touched. Otherwise the default process group
    is wrapped when the caller (or a launcher) has already initialized it,
    else it is joined here as ``rank`` through ``init_method`` (a
    ``file://`` path or ``tcp://host:port``; ``env://`` with a launcher's
    variables). ``backend`` defaults by the device the rank trains on:
    ``nccl`` for a CUDA device, ``gloo`` for the CPU; ``gloo`` with a CUDA
    device must be asked for by name."""
    if world_size <= 1:
        return DpGroup()
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"the process group has {dist.get_world_size()} ranks, config "
                f"world_size={world_size}"
            )
        backend = dist.get_backend()
    else:
        if rank is None or init_method is None:
            raise ValueError(
                f"world_size={world_size} runs one process per device: join the "
                "process group first (make_dp_mesh(world_size, rank, init_method=...), "
                "or python -m cdlrm_tpu_torch.cli --world-size N, which spawns the ranks)"
            )
        if backend is None:
            backend = "nccl" if torch.device(device or "cpu").type == "cuda" else "gloo"
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
    host_group = None
    if backend == "nccl":
        # NCCL moves no CPU tensors: the checkpoint's blocks and the barrier
        # go through a gloo group over the same ranks
        host_group = dist.new_group(backend="gloo")
    return DpGroup(dist.get_rank(), world_size, dist.group.WORLD, backend, host_group)


def destroy_dp_mesh(group: DpGroup) -> None:
    """Leave the process group that :func:`make_dp_mesh` joined, and stop
    its backend's threads.

    ``destroy_process_group`` unregisters the group, but a gloo group's
    threads (``pt_gloo_runloop``, ``gloo_tcp_loop``) run for as long as its
    Python object lives, and a closed trainer in a reference cycle keeps it
    alive through ``group``. A process that exits with those threads running
    can abort in the interpreter's teardown ("terminate called without an
    active exception", SIGABRT) after its work is done. So ``group`` drops
    its handles and the cycles are collected here: with no trainer of the
    group still in use, the threads are joined before this returns."""
    if not group.single and dist.is_initialized():
        dist.destroy_process_group()
    group.group = group.host_group = None
    gc.collect()


def report_failure(rank: int) -> None:
    """Write the exception being handled to stderr with the time it was
    caught (``rank R failed at T``, seconds since the epoch), flushed. A
    failing rank does this before it leaves the group: once it has left, its
    peers fail on the closed connections, and their errors, or a launcher
    ending the run, can come before any later report of its own. The times
    order the ranks' reports."""
    traceback.print_exc()
    print(f"rank {rank} failed at {time.time():.6f}", file=sys.stderr)
    sys.stderr.flush()


def local_replica_ids(group: DpGroup) -> List[int]:
    """The global replica positions this process feeds: its own rank."""
    return [group.rank]


def local_batch_rows(arr, group: DpGroup, axis: int = 0):
    """This rank's slice of a batch-major array (numpy or tensor) whose
    ``axis`` holds ``world_size * b_loc`` rows."""
    if group.single:
        return arr
    b_loc = arr.shape[axis] // group.world_size
    index = [slice(None)] * axis + [slice(group.rank * b_loc, (group.rank + 1) * b_loc)]
    return arr[tuple(index)]
