"""Full-table DLRM trainer, the counterpart of
cdlrm_tpu/train/fulltable.py::FullTableDlrmTrainer (``use_cache=False``,
``python -m cdlrm_tpu_torch.cli --no-use-cache``), on one device or as one
rank of a data-parallel run.

Every embedding table lives on the device, with no cache, prefetcher or
masters: the small-config path, and the oracle that pins the cached
machinery (a fully resident cached run must train the same trajectory). The
tables are one flat ``[sum(n), D]`` tensor (models/embedding.py); the
parameters, drawn from one generator in cdlrm_tpu's order (the dense MLPs,
then the tables), are equal to cdlrm_tpu's for the same seed. It is also the
only path for the QR and mixed-dimension compression tricks (``--qr-flag``,
``--md-flag``, SGD only): the tables above the flag's threshold are held
apart as ``QRParams`` / ``MDParams`` entries (models/tricks.py) and the flat
tensor holds the plain ones.

Ported: construction, ``train`` (SGD, or AdaGrad with a row-wise
accumulator per table row), ``evaluate``, ``save_checkpoint`` and
``load_checkpoint`` in cdlrm_tpu's format (``fulltable_params.npz``,
``fulltable_acc.npz``, ``meta.pkl``), ``close``. Beyond cdlrm_tpu, whose
full-table trainer ignores them, ``checkpoint_freq`` saves every so many
steps and ``checkpoint_async`` writes on a background thread, as in the
cached trainer. With ``world_size`` > 1 every rank holds the whole model and
the tables, feeds its slice of each batch, and applies the mean over the
ranks of the dense and the embedding gradients (fully synchronous data
parallelism, one collective a step); eval scores each rank's slice and
brings the scores together; rank 0 prints and writes the checkpoint.
Multi-host runs are refused, as cdlrm_tpu refuses them
(cdlrm_tpu/train/fulltable.py:33-36): the full tables are one process's,
and row-sharded masters are the cached trainer's. With a coordinator and one
rank it trains on one device.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import List, Optional

import numpy as np
import torch

from cdlrm_tpu_torch.config import Config
from cdlrm_tpu_torch.data.synthetic import Batch
from cdlrm_tpu_torch.utils.metrics import StreamingAUC, accuracy_count
from cdlrm_tpu_torch.models.dlrm import init_dlrm, map_params, params_from_jax, params_to_jax
from cdlrm_tpu_torch.models.embedding import emb_leaves, init_embedding_tables
from cdlrm_tpu_torch.parallel.mesh import DpGroup, local_batch_rows, make_dp_mesh
from cdlrm_tpu_torch.train import step as step_lib
from cdlrm_tpu_torch.train.trainer import (
    CheckpointWriter, _no_log, _pad_batch, _write_npz, _write_pickle, use_device,
)


class FullTableDlrmTrainer:
    """DLRM with the full tables on one device, or one rank of a
    data-parallel run: training and serving."""

    def __init__(self, cfg: Config, dataset, test_dataset=None, *, device,
                 group: Optional[DpGroup] = None):
        if cfg.ln_emb is None:
            raise ValueError(
                "call cdlrm_tpu_torch.config.finalize(cfg) (or build_dataset) first"
            )
        # this rank's DpGroup; by default the joined process group, and none
        # on one replica (parallel/mesh.py::make_dp_mesh)
        self.group = group if group is not None else make_dp_mesh(cfg.world_size)
        self.ndev = self.group.world_size
        if cfg.coordinator_address and self.ndev > 1:
            raise ValueError(
                "FullTableDlrmTrainer is single-process; multi-host runs use the "
                "cached trainer (use_cache=True) with row-sharded masters"
            )
        if self.ndev != cfg.world_size:
            raise ValueError(
                f"the group has {self.ndev} ranks, config world_size={cfg.world_size}"
            )
        self.cfg = cfg
        self.dataset = dataset
        self.test_dataset = test_dataset
        self.device = torch.device(device)
        use_device(self.device)
        # one generator, drawn in cdlrm_tpu's order (fulltable.py:42-57)
        rng = np.random.default_rng(cfg.numpy_rand_seed)
        self.params = init_dlrm(rng, cfg.ln_bot, cfg.ln_top, device=self.device)
        # the plain tables flat, their starts, and one entry per table: None
        # for a plain one, else its QRParams or MDParams
        self.tables, offsets, entries = init_embedding_tables(
            rng, cfg.ln_emb, cfg.m_spa_per_table if cfg.md_flag else cfg.m_spa,
            device=self.device, qr_flag=cfg.qr_flag, qr_collisions=cfg.qr_collisions,
            qr_threshold=cfg.qr_threshold, qr_operation=cfg.qr_operation,
            md_flag=cfg.md_flag, md_threshold=cfg.md_threshold,
        )
        self.table_offsets = offsets
        self._offsets = torch.from_numpy(offsets).to(self.device)
        self.emb_entries = entries
        # the steps' keyword for compressed tables; none when all are plain
        self._entries_kw = (
            {"entries": entries} if any(e is not None for e in entries) else {}
        )
        # AdaGrad state (cdlrm_tpu fulltable.py:59-72): element-wise dense
        # accumulators and one row-wise accumulator per table row, held flat
        # [sum(n)] like the tables
        self._adagrad = cfg.optimizer == "adagrad"
        self.dense_acc = self.emb_acc = None
        if self._adagrad:
            self.dense_acc = map_params(torch.zeros_like, self.params)
            self.emb_acc = torch.zeros(self.tables.shape[0], dtype=torch.float32,
                                       device=self.device)
        self._ckpt_writer = CheckpointWriter(self.device)
        scfg = step_lib.StepConfig(
            interaction_op=cfg.arch_interaction_op,
            interaction_itself=cfg.arch_interaction_itself,
            loss_function=cfg.loss_function,
            loss_weights=tuple(cfg.loss_weights_list),
            loss_threshold=cfg.loss_threshold,
            # strict_bias_divergence stays off: cdlrm_tpu's full-table step
            # averages every gradient, the biases' too (step.py:1452)
            compute_dtype=cfg.compute_dtype,
            optimizer=cfg.optimizer,
            adagrad_eps=cfg.adagrad_eps,
        )
        self.step_cfg = scfg
        self._pooled = cfg.num_indices_per_lookup > 1 or not cfg.num_indices_per_lookup_fixed
        self.train_step = step_lib.make_fulltable_train_step(
            scfg, pooled=self._pooled, group=self.group)
        self.eval_step = step_lib.make_fulltable_eval_step(scfg, pooled=self._pooled)
        # float32 learning rates, as cdlrm_tpu holds them (jnp.float32)
        self._lr = float(np.float32(cfg.learning_rate))
        self._lr_emb = float(np.float32(cfg.lr_embeds))
        self.global_step = 0

    def emb_tables(self, flat: Optional[torch.Tensor] = None) -> list:
        """cdlrm_tpu's ``params['emb']`` list: per table, the view of its
        rows in the flat tables ([n, D]) or its ``QRParams`` / ``MDParams``
        entry. With ``flat`` given, the per-table views of another tensor
        laid out by plain-table row, such as the row-wise accumulators
        ([n])."""
        flat = self.tables if flat is None else flat
        ends = list(self.table_offsets[1:]) + [flat.shape[0]]
        views = iter(flat[a:b] for a, b in zip(self.table_offsets, ends))
        return [next(views) if e is None else e for e in self.emb_entries]

    def _put(self, batch: Batch):
        """This rank's slice of x, ls_i, the mask (all False for
        single-index batches) and the targets on the device (cdlrm_tpu
        ``_put``)."""
        mask = batch.ls_mask
        if mask is None:
            mask = np.zeros(batch.ls_i.shape, dtype=bool)
        return tuple(
            self._to_device(local_batch_rows(a, self.group, axis))
            for a, axis in ((batch.x, 0), (batch.ls_i, 1), (mask, 1), (batch.y, 0))
        )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _global_ids(self, batch: Batch) -> dict:
        """The train step's ``global_ids`` keyword: the whole batch's ids,
        with more than one rank."""
        return {"global_ids": self._to_device(batch.ls_i)} if self.ndev > 1 else {}

    def train(self, max_steps: Optional[int] = None, log_fn=print) -> None:
        """Train over the stream, epoch by epoch (cdlrm_tpu
        fulltable.py:107-169): skip partial batches, stop at ``max_steps``,
        and log the loss and accuracy since the last log every
        ``print_freq`` batches of an epoch. Each step's loss and accuracy
        stay on the device until the next log."""
        cfg = self.cfg
        use_device(self.device)
        if self.group.rank != 0:
            log_fn = _no_log  # rank 0 alone prints
        b = cfg.mini_batch_size
        pending: List[torch.Tensor] = []  # (loss_sum, correct) device scalars
        loss_carry = corr_carry = n_carry = 0.0
        t0 = time.perf_counter()

        def flush():
            vals = torch.stack(pending).cpu().tolist() if pending else []
            n = len(pending) // 2 * b
            pending.clear()
            return sum(vals[0::2]), sum(vals[1::2]), n

        for epoch in range(cfg.nepochs):
            # the per-epoch shuffle protocol (data/criteo.py): the same epoch
            # order as the cached trainer
            kw = {"epoch": epoch} if getattr(self.dataset, "epoch_seeded_shuffle", False) else {}
            for j, batch in enumerate(self.dataset.batches(**kw)):
                if batch.x.shape[0] != b:
                    continue
                if max_steps is not None and self.global_step >= max_steps:
                    return
                x, ls_i, mask, tgt = self._put(batch)
                ids_kw = self._global_ids(batch)
                inputs = (self.params, self.tables, self._offsets, x, ls_i, mask, tgt)
                if self._adagrad:
                    (self.params, self.tables, self.dense_acc, self.emb_acc, loss_sum,
                     correct) = self.train_step(*inputs, self.dense_acc, self.emb_acc,
                                                self._lr, self._lr_emb, **ids_kw)
                else:
                    self.params, self.tables, loss_sum, correct = self.train_step(
                        *inputs, self._lr, self._lr_emb, **self._entries_kw, **ids_kw
                    )
                self.global_step += 1
                if (cfg.checkpoint_freq > 0 and cfg.save_model
                        and self.global_step % cfg.checkpoint_freq == 0):
                    self.save_checkpoint(cfg.save_model)
                pending += [loss_sum, correct]
                if len(pending) >= 2 * 4096:
                    # bound the live device scalars on huge print windows
                    la, ca, na = flush()
                    loss_carry += la
                    corr_carry += ca
                    n_carry += na
                if j > 0 and j % cfg.print_freq == 0:
                    loss_acc, corr_acc, n_acc = flush()
                    loss_acc += loss_carry
                    corr_acc += corr_carry
                    n_acc += int(n_carry)
                    loss_carry = corr_carry = n_carry = 0.0
                    dt = time.perf_counter() - t0
                    log_fn(
                        f"Epoch {epoch}: {j}/{len(self.dataset)} "
                        f"{1000 * dt / max(1, n_acc // b):.2f} ms/it, "
                        f"loss {loss_acc / max(1, n_acc):.5f}, acc {corr_acc / max(1, n_acc):.5f}"
                    )
                    t0 = time.perf_counter()

    def evaluate(self, max_batches: Optional[int] = None, log_fn=print):
        """Eval over the test stream; returns (accuracy, auc). A short last
        batch is padded to the eval batch size (with more than one rank, to
        ``world_size * ceil(tb / world_size)``: each rank scores its slice
        and the scores come together in rank order) and its padding
        dropped."""
        use_device(self.device)
        if self.group.rank != 0:
            log_fn = _no_log
        total, correct = 0, 0
        auc = StreamingAUC()
        tb = -(-self.cfg.test_mini_batch_size // self.ndev) * self.ndev
        for i, batch in enumerate(self.test_dataset.batches()):
            if max_batches is not None and i >= max_batches:
                break
            n = batch.x.shape[0]
            batch = _pad_batch(batch, tb)
            x, ls_i, mask, _ = self._put(batch)
            scores = self.eval_step(self.params, self.tables, self._offsets, x, ls_i, mask,
                                    **self._entries_kw)
            scores = self.group.gather_batch_rows(scores).cpu().numpy()[:n]
            correct += accuracy_count(scores, batch.y[:n])
            total += n
            auc.update(scores, batch.y[:n])
        acc = correct / max(1, total)
        auc_v = auc.result()
        log_fn(f"Test accuracy = {100.0 * acc:.4f}%  AUC = {auc_v:.5f}")
        return acc, auc_v

    def save_checkpoint(self, path: str) -> None:
        """Save in cdlrm_tpu's full-table format (fulltable.py:193-211):
        ``fulltable_params.npz`` and, under AdaGrad, ``fulltable_acc.npz``
        (``leaf_i`` in jax.tree_util.tree_flatten order of {"bot", "emb",
        "top"}: every bottom (W, b), every table, every top (W, b); a QR
        table is ``weight_q, weight_r``, an MD table ``weight`` and, where it
        has one, ``proj``; the ``emb`` accumulators as per-table [n]
        arrays), and ``meta.pkl``
        with the global step. The state is copied to the host here; the
        files are written by a :class:`CheckpointWriter`, on a background
        thread with ``checkpoint_async``. With more than one rank the
        replicas are equal (every gradient is averaged), so rank 0 alone
        writes, and after a synchronous write a barrier holds the others
        until the files are there."""
        self._ckpt_writer.join()
        if self.group.rank != 0:
            if not self.cfg.checkpoint_async:
                self.group.barrier()
            return
        os.makedirs(path, exist_ok=True)

        def leaves(params, emb) -> dict:
            tree = {"bot": params["bot"], "emb": emb_leaves(emb), "top": params["top"]}
            return {f"leaf_{i}": a for i, a in enumerate(params_to_jax(tree))}

        writes = [(_write_npz, os.path.join(path, "fulltable_params.npz"),
                   leaves(self.params, self.emb_tables()))]
        if self._adagrad:
            writes.append((_write_npz, os.path.join(path, "fulltable_acc.npz"),
                           leaves(self.dense_acc, self.emb_tables(self.emb_acc))))
        writes.append((_write_pickle, os.path.join(path, "meta.pkl"),
                       {"global_step": self.global_step}))
        self._ckpt_writer.run(writes, background=self.cfg.checkpoint_async)
        if not self.cfg.checkpoint_async:
            self.group.barrier()

    def load_checkpoint(self, path: str) -> None:
        """Load a full-table checkpoint of either package (the files of
        :meth:`save_checkpoint`). Raises cdlrm_tpu's errors
        (fulltable.py:221-233) when the checkpoint's optimizer state does
        not fit this run's optimizer."""
        self._ckpt_writer.join()
        acc_file = os.path.join(path, "fulltable_acc.npz")
        if self._adagrad and not os.path.exists(acc_file):
            raise ValueError(
                f"optimizer='adagrad' but {path!r} carries no optimizer "
                "state (saved by an SGD run?); resume with the matching "
                "optimizer"
            )
        if not self._adagrad and os.path.exists(acc_file):
            raise ValueError(
                f"{path!r} carries AdaGrad optimizer state but this run is "
                "optimizer='sgd'; resuming would silently drop the "
                "accumulators: pass --optimizer adagrad"
            )
        use_device(self.device)
        n_bot, n_top = len(self.params["bot"]), len(self.params["top"])

        def load(file: str, n_emb: int) -> dict:
            n_leaves = 2 * (n_bot + n_top) + n_emb
            with np.load(os.path.join(path, file)) as data:
                if len(data.files) != n_leaves:
                    raise ValueError(
                        f"{file} holds {len(data.files)} leaves, this config's model "
                        f"{n_leaves} (qr_flag, md_flag or the thresholds differ)"
                    )
                leaves = [data[f"leaf_{i}"] for i in range(n_leaves)]
            return params_from_jax(leaves, n_bot=n_bot, n_emb=n_emb, device=self.device)

        def copy_rows(dst_views, src):
            src = list(src)
            for dst, s in zip(dst_views, src):
                if tuple(dst.shape) != tuple(s.shape):
                    raise ValueError(
                        f"checkpoint table {tuple(s.shape)} != this config's {tuple(dst.shape)}"
                    )
                dst.copy_(s)

        dst = emb_leaves(self.emb_tables())
        loaded = load("fulltable_params.npz", len(dst))
        copy_rows(dst, loaded.pop("emb"))
        self.params = loaded
        if self._adagrad:
            dst = self.emb_tables(self.emb_acc)
            acc = load("fulltable_acc.npz", len(dst))
            copy_rows(dst, acc.pop("emb"))
            self.dense_acc = acc
        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            self.global_step = pickle.load(f)["global_step"]

    def close(self) -> None:
        """Wait for an outstanding checkpoint writer; the trainer starts no
        other thread."""
        self._ckpt_writer.join()
