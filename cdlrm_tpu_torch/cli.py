"""Training and serving CLI, the counterpart of cdlrm_tpu/cli.py on one
device: train on the stream (unless ``--inference-only``), then evaluate the
test stream and save a checkpoint with ``--save-model`` (unless
``--inference-only``), optionally starting from a checkpoint of either
package (``--load-model``). The cached trainer runs by default, the
full-table trainer with ``--no-use-cache``.

Example (tiny, CPU-runnable):
  python -m cdlrm_tpu_torch.cli --device cpu --data-generation random \
    --arch-embedding-size 1000-500-2000 --arch-sparse-feature-size 16 \
    --arch-mlp-bot 13-32-16 --arch-mlp-top 16-8-1 --mini-batch-size 64 \
    --num-batches 20 --cache-size 128 --num-ways 4 --loss-function bce \
    --lookahead 4 --print-freq 10

Every flag but ``--device`` is also cdlrm_tpu's (cdlrm_tpu_torch.config
keeps the same fields); the trainer
refuses the ones the port does not implement yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import sys

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
    np.set_printoptions(precision=cfg.print_precision)
    train_ds, test_ds, cfg = build_dataset(cfg)

    device = torch.device(ns.device)
    if cfg.use_cache:
        from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

        trainer = CachedDlrmTrainer(cfg, train_ds, test_ds, device=device)
    else:
        from cdlrm_tpu_torch.train.fulltable import FullTableDlrmTrainer

        trainer = FullTableDlrmTrainer(cfg, train_ds, test_ds, device=device)
    from cdlrm_tpu_torch.utils.profiling import profile_trace

    try:
        if cfg.load_model:
            trainer.load_checkpoint(cfg.load_model)
        # --enable-profiling: a torch.profiler trace of the training steps,
        # written to --profile-dir (utils/profiling.py)
        with profile_trace(cfg.profile_dir if cfg.enable_profiling else None, device):
            if not cfg.inference_only:
                trainer.train(max_steps=cfg.num_batches if cfg.num_batches > 0 else None)
        if test_ds is not None:
            trainer.evaluate()
        if cfg.save_model and not cfg.inference_only:
            trainer.save_checkpoint(cfg.save_model)
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
