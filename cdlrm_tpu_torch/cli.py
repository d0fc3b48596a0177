"""Training and serving CLI, the counterpart of cdlrm_tpu/cli.py: train on
the stream (unless ``--inference-only``), then evaluate the
test stream and save a checkpoint with ``--save-model`` (unless
``--inference-only``), optionally starting from a checkpoint of either
package (``--load-model``). The cached trainer runs by default, the
full-table trainer with ``--no-use-cache``.

``--world-size N`` with N > 1 runs N processes, one per device
(parallel/mesh.py): started here with no rank in the environment, the CLI
spawns them itself (rank r on ``cuda:r``, or all on the CPU under ``--device
cpu``) and exits non-zero if any of them fails; started by a launcher that
sets ``RANK`` and ``WORLD_SIZE`` (and ``MASTER_ADDR``/``MASTER_PORT``), it
joins as that rank.

``--coordinator-address host:port`` runs multi-host mode
(parallel/multihost.py): one process per card, each started by the user or
a launcher on its machine, joins rank 0's ``host:port`` as rank
``--host-id`` (or ``RANK``) of ``--num-hosts`` (or ``WORLD_SIZE``), which
must equal ``--world-size``, and trains on ``cuda:LOCAL_RANK`` (``cuda:0``
when it is unset), or on the CPU under ``--device cpu``. Each rank holds its
row shard of the masters.

Example (tiny, CPU-runnable):
  python -m cdlrm_tpu_torch.cli --device cpu --data-generation random \
    --arch-embedding-size 1000-500-2000 --arch-sparse-feature-size 16 \
    --arch-mlp-bot 13-32-16 --arch-mlp-top 16-8-1 --mini-batch-size 64 \
    --num-batches 20 --cache-size 128 --num-ways 4 --loss-function bce \
    --lookahead 4 --print-freq 10

Every flag but ``--device`` is also cdlrm_tpu's (cdlrm_tpu_torch.config
keeps the same fields, checks and errors), and the port implements each of
them.
"""

from __future__ import annotations

import argparse
import importlib
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from cdlrm_tpu_torch.config import Config, config_from_args


def build_dataset(cfg: Config):
    """Returns (train_ds, test_ds, cfg) with cfg.finalize() applied."""
    if cfg.data_generation in ("random", "synthetic"):
        cfg.finalize()
        from cdlrm_tpu_torch.data.synthetic import SyntheticDataset

        train = SyntheticDataset(
            m_den=cfg.ln_bot[0],
            ln_emb=cfg.ln_emb,
            data_size=cfg.data_size,
            mini_batch_size=cfg.mini_batch_size,
            num_batches=cfg.num_batches,
            num_indices_per_lookup=cfg.num_indices_per_lookup,
            num_indices_per_lookup_fixed=cfg.num_indices_per_lookup_fixed,
            round_targets=cfg.round_targets,
            data_generation=cfg.data_generation,
            trace_file=cfg.data_trace_file,
            enable_padding=cfg.data_trace_enable_padding,
            trace_model=cfg.data_trace_model,
            seed=cfg.numpy_rand_seed,
        )
        test = SyntheticDataset(
            m_den=cfg.ln_bot[0],
            ln_emb=cfg.ln_emb,
            data_size=max(cfg.test_mini_batch_size * 4, cfg.mini_batch_size),
            mini_batch_size=cfg.test_mini_batch_size,
            # eval batches must share the train stream's pooled width: the
            # trainer builds one eval step for [T, B, P] + mask
            num_indices_per_lookup=cfg.num_indices_per_lookup,
            num_indices_per_lookup_fixed=cfg.num_indices_per_lookup_fixed,
            round_targets=cfg.round_targets,
            data_generation=cfg.data_generation,
            trace_file=cfg.data_trace_file,
            enable_padding=cfg.data_trace_enable_padding,
            trace_model=cfg.data_trace_model,
            seed=cfg.numpy_rand_seed + 1,
        )
        return train, test, cfg
    if cfg.data_generation == "dataset":
        from cdlrm_tpu_torch.data.criteo import make_criteo_datasets

        return make_criteo_datasets(cfg)
    raise ValueError(f"unsupported --data-generation {cfg.data_generation}")


def _run(cfg: Config, device: torch.device, group=None) -> int:
    """Build the datasets and the trainer and run them; one process's work."""
    np.set_printoptions(precision=cfg.print_precision)
    train_ds, test_ds, cfg = build_dataset(cfg)
    if cfg.use_cache:
        from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

        trainer = CachedDlrmTrainer(cfg, train_ds, test_ds, device=device, group=group)
    else:
        from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

        trainer = FullTableDlrmTrainer(cfg, train_ds, test_ds, device=device, group=group)
    from cdlrm_tpu_torch.utils.profiling import profile_trace

    try:
        if cfg.load_model:
            trainer.load_checkpoint(cfg.load_model)
        # --enable-profiling: a torch.profiler trace of the training steps,
        # written to --profile-dir (utils/profiling.py), by rank 0 alone
        profiled = cfg.enable_profiling and (group is None or group.rank == 0)
        with profile_trace(cfg.profile_dir if profiled else None, device):
            if not cfg.inference_only:
                trainer.train(max_steps=cfg.num_batches if cfg.num_batches > 0 else None)
        if test_ds is not None:
            trainer.evaluate()
        if cfg.save_model and not cfg.inference_only:
            trainer.save_checkpoint(cfg.save_model)
    finally:
        trainer.close()
    return 0


def _run_rank(rank: int, world_size: int, argv, device_type: str, init_method: str) -> None:
    """One rank of a data-parallel run: join the group, train on this
    rank's device (``cuda:rank``, or the CPU), leave the group. An
    exception is written to stderr before the rank leaves the group, and
    ends the process with a non-zero code, which ends the run."""
    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure

    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = make_dp_mesh(world_size, rank, init_method=init_method, device=device)
    try:
        _run(config_from_args(argv), device, group)
    except BaseException:
        report_failure(rank)
        raise
    finally:
        destroy_dp_mesh(group)


def _run_multihost(cfg: Config, device_type: str) -> int:
    """One rank of a multi-host run (cdlrm_tpu/cli.py:73-83): check the host
    fields against the world size, join the group through the coordinator,
    set ``num_hosts`` and ``host_id`` to the group's (the bin loader's
    ``--data-host-slice`` reads them), train, leave the group. An exception
    is written to stderr before the rank leaves the group."""
    from cdlrm_tpu_torch.parallel.mesh import destroy_dp_mesh, make_dp_mesh, report_failure
    from cdlrm_tpu_torch.parallel.multihost import check_hosts, initialize_distributed

    world = cfg.world_size
    # -1: from the environment, as a launcher sets it
    check_hosts(cfg.num_hosts if cfg.num_hosts > 0 else int(os.environ.get("WORLD_SIZE", world)),
                cfg.host_id, world)
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    pid, nproc = initialize_distributed(
        cfg.coordinator_address, world, cfg.host_id if cfg.host_id >= 0 else None,
        device=device,
    )
    print(f"[multihost] process {pid}/{nproc} initialized")
    cfg.num_hosts, cfg.host_id = nproc, pid
    group = make_dp_mesh(nproc, pid, device=device)
    try:
        return _run(cfg, device, group)
    except BaseException:
        report_failure(pid)
        raise
    finally:
        destroy_dp_mesh(group)


def main(argv=None) -> int:
    dev_parser = argparse.ArgumentParser(add_help=False)
    dev_parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the cache and the dense model live (default: cuda)",
    )
    ns, rest = dev_parser.parse_known_args(argv)
    cfg = config_from_args(rest)
    if ns.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu)")
    if cfg.coordinator_address:
        return _run_multihost(cfg, ns.device)
    world = cfg.world_size
    if world <= 1:
        return _run(cfg, torch.device(ns.device))
    if ns.device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(
            f"--device cuda --world-size {world}: one CUDA device per rank is "
            f"needed, {torch.cuda.device_count()} available"
        )
    if "RANK" in os.environ:
        # started by a launcher, one process per rank
        if int(os.environ.get("WORLD_SIZE", world)) != world:
            raise ValueError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} in the environment, "
                f"--world-size {world}"
            )
        _run_rank(int(os.environ["RANK"]), world, rest, ns.device, "env://")
        return 0
    import torch.multiprocessing as mp

    # the ranks meet through a file in a directory of their own, never a
    # fixed port. The worker is taken from the imported module, not from
    # __main__, so that the spawned interpreters can find it by name
    worker = importlib.import_module("cdlrm_tpu_torch.cli")._run_rank
    rdzv = tempfile.mkdtemp(prefix="cdlrm_dp_")
    try:
        # spawn (never fork: CUDA and the host threads do not survive it);
        # a rank that fails ends the others and raises here
        mp.spawn(worker, args=(world, rest, ns.device, "file://" + os.path.join(rdzv, "rdzv")),
                 nprocs=world, join=True)
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
