#!/usr/bin/env python3
"""Multi-host scaling of cdlrm_tpu_torch: examples/s of one host against H
hosts at the same global batch (``multihost_scaling_efficiency``).

The port's counterpart of bench_scaling.py, on its worker configuration: 8
tables x 20,000 rows, dim 16, MLPs 13-64-16 and 16-8-1, a cache of 1,024
sets x 4 ways, lookahead 8, virtual masters, the synthetic stream of seed 7,
max(4, steps // 5) warm-up steps, then ``--steps`` timed steps on the host
clock of rank 0.

A cdlrm_tpu host is one port rank with one device, so the two topologies
are:

  1-host   H data-parallel ranks started as one host (a file rendezvous, a
           full copy of the masters each): the counterpart of one cdlrm_tpu
           process that holds H devices;
  H-host   H multi-host ranks joined through a coordinator address
           (``initialize_distributed``), each holding its row shard of the
           masters and exchanging the window's rows.

Both run at the global batch ``--batch-per-device`` x H, and the efficiency
is the H-host rate over the 1-host rate. ``--devices-per-host`` takes 1
only: a port rank holds one device. With ``--backend cuda`` every rank
shares ``cuda:0`` over gloo, so the reading is a lower bound that tells
nothing of H cards or H hosts; on the CPU the ranks share the machine's
cores, a lower bound too. The ranks' output goes to files, as the
reference's does (a rank writing into an undrained pipe could block while
its peer waits in a collective).

Run from the repository root:

    python3 bench_scaling_torch.py --hosts 2                  # on cuda:0
    python3 bench_scaling_torch.py --backend cpu --steps 8    # the CPU

Without a card and without ``--backend cpu`` it exits 1. It prints the
reference's three lines: one per topology, then the efficiency line with its
``note``, which also carries the ``backend``, the ``device`` (the card's name
and power limit) and the kernels' ``launches`` of both topologies.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

import bench_torch


def worker_config_kwargs(world: int, batch: int) -> dict:
    """bench_scaling.py's ``_WORKER`` configuration (:36-45)."""
    return dict(
        arch_sparse_feature_size=16,
        arch_embedding_size="-".join(["20000"] * 8),
        arch_mlp_bot="13-64-16", arch_mlp_top="16-8-1",
        mini_batch_size=batch, world_size=world,
        cache_size=1024, num_ways=4, loss_function="bce",
        lookahead=8, table_agg_freq=100, print_freq=10**9,
        round_targets=True, numpy_rand_seed=3,
        num_indices_per_lookup=1, num_indices_per_lookup_fixed=True,
        master_init="virtual",
    )


def rank_main(args) -> int:
    """One rank of a topology: join, train the warm-up and the timed steps,
    and (rank 0) write the topology's rate to ``args.out``."""
    import torch

    from cdlrm_tpu_torch.config import Config
    from cdlrm_tpu_torch.data.synthetic import SyntheticDataset
    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure
    from cdlrm_tpu_torch.parallel.multihost import initialize_distributed
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    pid, world = args.rank, args.world
    dev = torch.device("cuda", 0) if args.backend == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    batch = args.batch_per_device * world
    kw = worker_config_kwargs(world, batch)
    if args.multihost:
        address = f"127.0.0.1:{args.port}"
        kw["coordinator_address"] = address
        initialize_distributed(address, world, pid, backend="gloo", device=dev, timeout_s=300)
        group = make_dp_mesh(world, pid, device=dev)
    else:
        group = make_dp_mesh(world, pid, init_method="file://" + args.rdzv, backend="gloo",
                             device=dev, timeout_s=300)
    try:
        cfg = Config(**kw)
        cfg.finalize()
        warm = max(4, args.steps // 5)
        ds = SyntheticDataset(m_den=13, ln_emb=cfg.ln_emb,
                              data_size=batch * (warm + args.steps + 4), mini_batch_size=batch,
                              num_indices_per_lookup=1, num_indices_per_lookup_fixed=True,
                              round_targets=True, seed=7)
        bench_torch.reset_launches()
        tr = CachedDlrmTrainer(cfg, ds, device=dev, group=group)
        try:
            tr.train(max_steps=warm, log_fn=lambda s: None)
            t0 = time.perf_counter()
            tr.train(max_steps=warm + args.steps, log_fn=lambda s: None)
            bench_torch.synchronize(dev)
            dt = time.perf_counter() - t0
        finally:
            tr.close()
        del tr
    except BaseException:
        report_failure(pid)  # before the peers fail on the closed connections
        raise
    finally:
        destroy_dp_mesh(group)
    rec = {"launches": bench_torch.read_launches()}
    if pid == 0:
        rec.update(world=world, examples_per_sec=args.steps * batch / dt,
                   ms_per_iter=1000 * dt / args.steps)
    with open(args.out, "w") as f:
        json.dump(rec, f)
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_topology(hosts: int, multihost: bool, steps: int, batch_per_device: int,
                 backend: str, timeout_s: float = 1800.0) -> tuple:
    """Start the ``hosts`` ranks of one topology and wait for them; returns
    rank 0's record and the launches summed over the ranks."""
    with tempfile.TemporaryDirectory(prefix="cdlrm_scaling_") as td:
        outs = [os.path.join(td, f"out{r}.json") for r in range(hosts)]
        common = ["--world", str(hosts), "--steps", str(steps), "--batch-per-device",
                  str(batch_per_device), "--backend", backend, "--rdzv",
                  os.path.join(td, "rdzv"), "--port", str(_free_port())]
        bench_torch.launch_ranks(
            [[os.path.abspath(__file__), "--rank", str(r), "--out", outs[r], *common]
             + (["--multihost"] if multihost else []) for r in range(hosts)], td, timeout_s)
        recs = []
        for path in outs:
            with open(path) as f:
                recs.append(json.load(f))
    launches = {k: sum(r["launches"][k] for r in recs) for k in bench_torch.KERNELS}
    head = {k: v for k, v in recs[0].items() if k != "launches"}
    return head, launches


def run(env: dict, hosts: int = 2, steps: int = 40, batch_per_device: int = 128,
        backend: str = "cuda") -> dict:
    """Both topologies; returns ``{"lines": [the reference's three]}`` and
    the run's ``launches``."""
    import torch

    if backend == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_scaling_torch: no CUDA device; pass --backend cpu for the "
                           "ranks on the CPU")
    device = bench_torch.card_line() if backend == "cuda" else None
    single, l1 = run_topology(hosts, False, steps, batch_per_device, backend)
    multi, l2 = run_topology(hosts, True, steps, batch_per_device, backend)
    eff = multi["examples_per_sec"] / max(1e-9, single["examples_per_sec"])
    shared = ("every rank on cuda:0 over gloo" if backend == "cuda"
              else "every rank on this machine's CPU cores over gloo")
    launches = {k: l1[k] + l2[k] for k in bench_torch.KERNELS}
    lines = [
        {"topology": "1-host", "ranks": hosts, **single},
        {"topology": f"{hosts}-host", "ranks": hosts, **multi},
        {"metric": "multihost_scaling_efficiency", "value": round(eff, 3),
         "unit": f"x (same global batch, {hosts} ranks: 1 host data parallel vs "
                 f"{hosts} hosts)",
         "note": f"{shared}: the ranks contend for one {'card' if backend == 'cuda' else 'machine'}"
                 f", so this is a lower bound only and tells nothing of {hosts} cards or "
                 f"{hosts} hosts",
         "backend": backend, "device": device, "launches": launches},
    ]
    return {"lines": lines, "launches": launches, "backend": backend, "device": device}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--devices-per-host", type=int, default=1,
                    help="1 only: a port rank holds one device")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch-per-device", type=int, default=128)
    ap.add_argument("--backend", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--multihost", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rdzv", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.devices_per_host != 1:
        ap.error(f"--devices-per-host {args.devices_per_host}: a cdlrm_tpu_torch rank holds "
                 "one device, so a host is one rank; give --hosts the number of ranks")
    return bench_torch.main(
        lambda env: run(env, args.hosts, args.steps, args.batch_per_device, args.backend),
        lines=lambda rec: rec["lines"])


if __name__ == "__main__":
    sys.exit(main())
