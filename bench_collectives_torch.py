#!/usr/bin/env python3
"""Collective bytes per call of cdlrm_tpu_torch's data-parallel steps.

The port's counterpart of bench_collectives.py. The reference reads the
bytes from compiled HLO over an 8-device virtual mesh; the port has no HLO,
so the bytes are counted where they leave a rank: at each call of the
``DpGroup`` collectives the steps make (parallel/mesh.py), by the method
called, through a counting wrapper around the group that the step factories
receive. A call counts the bytes of the tensor it reduces or broadcasts
(``all_reduce_sum``, ``all_reduce_max``, ``broadcast_from0``), or of what it
gathers (``gather_batch_rows``, ``all_gather_host``, ``gather_host_to0``):
per rank, the counterpart of the HLO's shard-local result shapes.

The reference's per-rank shapes: 26 tables x 4,096 sets x 4 ways, dim 32,
50,000 ids a table, a batch of 64 a rank (so ``aux_capacity`` 64), 4,096
inserts and 2,048 evicts, a union bucket of 32,768. Each world size runs as
that many processes, one gloo rank each, and each rank calls:

  refill_strict, refill_delta      ``make_refill_step`` (evicted rows, then
                                   the whole cache under strict);
  aggregate_sparse, _dense         ``make_aggregate_step`` with the union
                                   bucket, and without (the masked cache);
  train                            ``make_cached_train_step`` (the
                                   dense-gradient mean with the loss and
                                   accuracy sums in one buffer);
  aggregate_sparse_adagrad         the sparse aggregate with the row-wise
                                   AdaGrad state riding along.

Run from the repository root:

    python3 bench_collectives_torch.py                  # ranks on cuda:0
    python3 bench_collectives_torch.py --backend cpu    # ranks on the CPU

On the card every rank shares ``cuda:0`` and the group is gloo by name; the
bytes come from shapes, so they are the CPU run's. Without a card and
without ``--backend cpu`` it exits 1. It prints one JSON line per
measurement (the reference's ``step`` names and keys, with ``world``), then a
line of ratios (COLLECTIVES_r04.json's) with the ``backend``, the ``device``
(the card's name and power limit) and the kernels' ``launches``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

import bench_torch

TABLES, DIM, SETS, WAYS, IDS = 26, 32, 4096, 4, 50_000
BATCH = 64  # a rank's batch: the reference's global 512 over 8 devices
INSERTS, EVICTS = 4096, 2048
UNION_BUCKET = 1 << 15


class CountingGroup:
    """A ``DpGroup`` that adds the bytes of each collective call to
    ``bytes[method]``; everything else is the group's."""

    def __init__(self, group):
        self._group = group
        self.bytes = {}

    def __getattr__(self, name):
        return getattr(self._group, name)

    def _count(self, op: str, nbytes: int) -> None:
        self.bytes[op] = self.bytes.get(op, 0) + int(nbytes)

    def take(self) -> dict:
        """The counts since the last take, and a fresh start."""
        out, self.bytes = self.bytes, {}
        return out

    def all_reduce_sum(self, t):
        self._count("all_reduce_sum", t.numel() * t.element_size())
        return self._group.all_reduce_sum(t)

    def all_reduce_max(self, t):
        self._count("all_reduce_max", t.numel() * t.element_size())
        return self._group.all_reduce_max(t)

    def broadcast_from0(self, t):
        self._count("broadcast_from0", t.numel() * t.element_size())
        return self._group.broadcast_from0(t)

    def gather_batch_rows(self, local):
        out = self._group.gather_batch_rows(local)
        self._count("gather_batch_rows", out.numel() * out.element_size())
        return out

    def all_gather_host(self, block):
        out = self._group.all_gather_host(block)
        self._count("all_gather_host", out.nbytes)
        return out

    def gather_host_to0(self, block):
        self._count("gather_host_to0", block.nbytes * self._group.world_size)
        return self._group.gather_host_to0(block)


def measure(group: CountingGroup, dev) -> list:
    """One call of each step on this rank; returns the measurements."""
    import torch

    from cdlrm_tpu_torch.cache.geometry import CacheGeometry
    from cdlrm_tpu_torch.models.dlrm import derive_top_mlp_input_dim, init_dlrm
    from cdlrm_tpu_torch.train import step as step_lib

    geo = CacheGeometry.build([IDS] * TABLES, DIM, SETS, WAYS, aux_capacity=BATCH)
    rows = geo.total_rows
    rng = np.random.default_rng(0)
    ln_bot = [13, 64, DIM]
    ln_top = [derive_top_mlp_input_dim(TABLES, DIM, "dot", False), 64, 1]
    params = init_dlrm(rng, ln_bot, ln_top, device=dev)
    scfg = step_lib.StepConfig(loss_function="bce")
    results = []

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def zeros_cache():
        return torch.zeros((rows, DIM), dtype=torch.float32, device=dev)

    ins_slots = tensor(rng.integers(0, rows - 1, INSERTS).astype(np.int32))
    ins_rows = torch.zeros((INSERTS, DIM), dtype=torch.float32, device=dev)
    ev_slots = tensor(rng.integers(0, rows - 1, EVICTS).astype(np.int32))
    for mode in ("strict", "delta"):
        refill = step_lib.make_refill_step(scfg._replace(refill_broadcast=mode), geo.trash_row,
                                           group=group)
        group.take()
        refill(zeros_cache(), ins_slots, ins_rows, ev_slots)
        byt = group.take()
        results.append({"step": f"refill_{mode}", "collective_bytes": byt,
                        "total": sum(byt.values()), "inserts": INSERTS, "evicts": EVICTS,
                        "cache_rows": int(rows)})

    for name, bucket in (("sparse", UNION_BUCKET), ("dense", None)):
        agg = step_lib.make_aggregate_step(scfg, group, union_bucket=bucket,
                                           trash_row=geo.trash_row)
        group.take()
        agg(zeros_cache(), torch.zeros(rows, dtype=torch.uint8, device=dev))
        byt = group.take()
        results.append({"step": f"aggregate_{name}", "collective_bytes": byt,
                        "total": sum(byt.values()), "union_bucket": bucket,
                        "cache_rows": int(rows)})

    train = step_lib.make_cached_train_step(geo, scfg, group=group)
    slots = np.stack([rng.integers(0, geo.ways * geo.sets[t], BATCH).astype(np.int32)
                      + geo.table_offsets[t].astype(np.int32) for t in range(TABLES)])
    group.take()
    train(params, zeros_cache(), tensor(rng.random((BATCH, 13)).astype(np.float32)),
          tensor(slots), torch.zeros(slots.shape, dtype=torch.bool, device=dev),
          tensor(np.full(BATCH, geo.trash_row, np.int32)),
          torch.zeros((BATCH, DIM), dtype=torch.float32, device=dev),
          tensor(np.round(rng.random((BATCH, 1))).astype(np.float32)), 0.1, 0.3,
          touched=torch.zeros(rows, dtype=torch.uint8, device=dev))
    byt = group.take()
    results.append({"step": "train", "collective_bytes": byt, "total": sum(byt.values()),
                    "global_batch": BATCH * group.world_size, "batch_per_rank": BATCH})

    agg = step_lib.make_aggregate_step(scfg._replace(optimizer="adagrad", dedup=True), group,
                                       union_bucket=UNION_BUCKET, trash_row=geo.trash_row)
    group.take()
    agg(zeros_cache(), torch.zeros(rows, dtype=torch.uint8, device=dev),
        torch.zeros(rows, dtype=torch.float32, device=dev))
    byt = group.take()
    results.append({"step": "aggregate_sparse_adagrad", "collective_bytes": byt,
                    "total": sum(byt.values()), "union_bucket": UNION_BUCKET})
    return results


def rank_main(rank: int, world: int, rdzv: str, backend: str, out: str) -> int:
    """One rank: join the gloo group, measure, write this rank's results
    and kernel launches to ``out``, leave the group."""
    import torch

    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure

    dev = torch.device("cuda", 0) if backend == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(1)
    group = make_dp_mesh(world, rank, init_method="file://" + rdzv, backend="gloo",
                         device=dev, timeout_s=300)
    try:
        bench_torch.reset_launches()
        results = measure(CountingGroup(group), dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    except BaseException:
        report_failure(rank)  # before the peers fail on the closed connections
        raise
    finally:
        destroy_dp_mesh(group)
    with open(out, "w") as f:
        json.dump({"results": results, "launches": bench_torch.read_launches()}, f)
    print(f"rank {rank}: {len(results)} measurements")
    return 0


def ratios(lines: list) -> dict:
    """COLLECTIVES_r04.json's ratios from one world's measurements."""
    total = {r["step"]: r["total"] for r in lines}
    return {
        "refill_strict_over_delta": round(total["refill_strict"] / total["refill_delta"], 1),
        "aggregate_dense_over_sparse": round(
            total["aggregate_dense"] / total["aggregate_sparse"], 1),
        "adagrad_aggregate_overhead_frac": round(
            (total["aggregate_sparse_adagrad"] - total["aggregate_sparse"])
            / total["aggregate_sparse"], 4),
    }


def run(env: dict, backend: str = "cuda", worlds=(2, 4), timeout_s: float = 600.0) -> dict:
    """Every measurement at each world size; returns ``{"lines": [...],
    "ratios": {...}, ...}``. The ranks of a world are processes of this
    script; each rank's counts must equal rank 0's."""
    import torch

    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_collectives_torch: no CUDA device; pass --backend cpu "
                           "for the ranks on the CPU")
    device = bench_torch.card_line() if backend == "cuda" else None
    lines, launches = [], dict.fromkeys(bench_torch.KERNELS, 0)
    for world in worlds:
        with tempfile.TemporaryDirectory(prefix="cdlrm_coll_") as tmp:
            outs = [os.path.join(tmp, f"out{r}.json") for r in range(world)]
            bench_torch.launch_ranks(
                [[os.path.abspath(__file__), "--rank", str(r), "--world", str(world),
                  "--rdzv", os.path.join(tmp, "rdzv"), "--backend", backend, "--out", outs[r]]
                 for r in range(world)], tmp, timeout_s)
            ranks = []
            for path in outs:
                with open(path) as f:
                    ranks.append(json.load(f))
        for r, got in enumerate(ranks):
            assert got["results"] == ranks[0]["results"], f"rank {r} counted other bytes"
            for name in launches:
                launches[name] += got["launches"][name]
        lines += [dict(rec, world=world) for rec in ranks[0]["results"]]
    per_world = {w: ratios([ln for ln in lines if ln["world"] == w]) for w in worlds}
    assert all(r == per_world[worlds[0]] for r in per_world.values()), per_world
    return {"lines": lines, "ratios": per_world[worlds[0]], "worlds": list(worlds),
            "backend": backend, "device": device, "launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks' tensors live (default: cuda, all on cuda:0)")
    ap.add_argument("--worlds", default="2,4", help="world sizes, comma-separated")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, args.world, args.rdzv, args.backend, args.out)
    worlds = tuple(int(w) for w in args.worlds.split(","))

    def collect(env):
        return run(env, backend=args.backend, worlds=worlds)

    def lines(rec):
        return rec["lines"] + [{"metric": "collective_bytes_ratios", "ratios": rec["ratios"],
                                "worlds": rec["worlds"], "backend": rec["backend"],
                                "device": rec["device"], "launches": rec["launches"]}]

    return bench_torch.main(collect, lines=lines)


if __name__ == "__main__":
    sys.exit(main())
