"""Configuration: the live flag surface of the reference CLI plus this
system's additions. The port's own copy of cdlrm_tpu/config.py: the same
fields, defaults, checks and flags, so one command line configures either
package, and the port implements every field; the fields that select
cdlrm_tpu's Pallas or XLA forms
(``use_pallas_lookup``, ``use_pallas_scatter``, ``pallas_interpret``) are
accepted and read by nothing here: the port's row operations are always its
CUDA kernels.

Reference: ``ProcessArgs`` (main_no_ddp.py:34-145). Flags the
reference parses but never uses (--save-model/--load-model/--enable-profiling/
--inference-only/... — see SURVEY.md §5 "dead flags") are either implemented
properly here (checkpointing, inference) or intentionally dropped; each case
is noted on the field.

Dropped without a field (the full ledger — every reference flag not present
below, with its reference disposition):

- ``--activation-function`` (main_no_ddp.py:47), ``--debug-mode`` (:105),
  ``--plot-compute-graph`` (:107), ``--dense-threshold`` (:131),
  ``--save-onnx`` (:141): parsed and never read anywhere in the
  reference — dead letters with no behavior to reproduce (the MLPs are
  fixed relu/sigmoid regardless, model_no_ddp.py:244-268).
- ``--evict-victim-cache`` (:96, "# Added"): parsed and never read; the
  model stores ``victim_cache_entries`` each forward
  (model_no_ddp.py:120,187) but nothing ever READS them — vestigial
  state for a feature that was never finished. The live part of that
  machinery (miss rows staged into the aux region) is our aux staging
  path (train/step.py, ``aux_capacity``).
- ``--use-gpu`` (:142): parsed and never read — the reference hardcodes
  CUDA/NCCL (main_no_ddp.py:225,343). Device selection here is the
  CLI's ``--device``, not a Config field.
- ``--sync-dense-params`` (:90): stored on DLRM_Net (model_no_ddp.py:236)
  and never read after that — dense grads are ALWAYS all-reduced by the
  explicit weight-grad pass (main_no_ddp.py:229-248) regardless.
  Ours syncs dense grads unconditionally too;
  ``strict_bias_divergence`` reproduces the one place the reference's
  sync actually diverges.
- ``--master-port`` (:128): live — the NCCL rendezvous port
  (main_no_ddp.py:342). Subsumed by ``coordinator_address`` (host:port).
- ``--trainer-start-core`` (:129): parsed, then unconditionally overwritten
  with main_start_core + cache_workers + 3 (main_no_ddp.py:635) — a derived
  value, not a user knob. Our pin layout derives the same region for
  loader/worker threads (``main_start_core`` doc; DESIGN.md D5).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from cdlrm_tpu_torch.utils.primes import next_prime


def _int_list(s: str) -> List[int]:
    return [int(v) for v in s.split("-") if v != ""]


@dataclass
class Config:
    # ---- model architecture (main_no_ddp.py:37-44) ----
    arch_sparse_feature_size: int = 2
    arch_embedding_size: str = "4-3-2"
    arch_mlp_bot: str = "4-3-2"
    arch_mlp_top: str = "4-2-1"
    arch_interaction_op: str = "dot"
    arch_interaction_itself: bool = False

    # ---- loss (main_no_ddp.py:47-52) ----
    loss_function: str = "mse"  # mse | bce | wbce
    loss_weights: str = "1.0-1.0"
    loss_threshold: float = 0.0
    round_targets: bool = False

    # ---- data (main_no_ddp.py:55-70) ----
    data_size: int = 1
    num_batches: int = 0
    data_generation: str = "random"  # random | synthetic | dataset
    data_trace_file: str = "./input/dist_emb_j.log"
    data_set: str = "kaggle"  # kaggle | terabyte
    raw_data_file: str = ""
    processed_data_file: str = ""
    data_randomize: str = "total"  # total | day | none
    data_trace_enable_padding: bool = False
    data_trace_model: str = "lru"  # lru | rand — which stack-distance trace
    #   generator drives data_generation='synthetic' (the reference hard-codes
    #   lru and keeps rand commented out, dlrm_data_pytorch.py:850-854)
    max_ind_range: int = -1
    data_sub_sample_rate: float = 0.0
    num_indices_per_lookup: int = 10
    num_indices_per_lookup_fixed: bool = False
    num_workers: int = 0
    memory_map: bool = False

    # ---- embedding compression (main_no_ddp.py:73-81) ----
    md_flag: bool = False
    md_threshold: int = 200
    md_temperature: float = 0.3
    md_round_dims: bool = False
    qr_flag: bool = False
    qr_threshold: int = 200
    qr_operation: str = "mult"
    qr_collisions: int = 4

    # ---- training (main_no_ddp.py:84-97) ----
    mini_batch_size: int = 1  # GLOBAL batch (sliced per DP shard)
    nepochs: int = 1
    learning_rate: float = 0.1
    lr_embeds: float = 0.3
    optimizer: str = "sgd"  # sgd | adagrad. Beyond-parity (the reference
    #   trains SGD only, main_no_ddp.py:374-376): AdaGrad = torch-semantics
    #   element-wise on the dense MLPs + row-wise (torchrec semantics) on
    #   the cached embedding rows with CACHE-RESIDENT per-row state —
    #   refill insert resets an inserted slot's state (fresh id), eviction
    #   drops it (state never round-trips to the masters; documented
    #   approximation). Requires dedup_lookups='on' (row-wise state needs
    #   coalesced slots); incompatible with the hot tier and QR/MD tricks.
    adagrad_eps: float = 1e-10  # torch.optim.Adagrad default eps
    adagrad_master_state: bool = False  # the row-wise accumulator
    #   ROUND-TRIPS through a host-resident AccumulatorStore instead of the
    #   default drop-at-evict / reset-at-insert approximation: evicted ids'
    #   accumulators write back with their rows (same eviction thread,
    #   always overwrite — state restore, not a merge) and inserted ids
    #   RESUME their state, gathered at refill staging behind an
    #   eviction-fifo fence (exact restore — trainer._refill_device_inputs;
    #   row VALUES keep the reference's eventual-consistency envelope).
    #   Closes the thrash gap of cache-resident-only state under
    #   capacity pressure.
    #   +4 bytes host RAM per owned embedding row; accumulator support
    #   rides the checkpoint. Multi-host: the store is row-sharded with
    #   the masters — writebacks mask to owned rows and resume values ride
    #   the window exchange as one extra f32 column
    #   (parallel/multihost.py exchange_window_rows; 2x2-vs-1x4 trajectory
    #   pinned in tests/test_multihost.py).
    print_precision: int = 5
    numpy_rand_seed: int = 123
    lookahead: int = 2
    cache_workers: int = 2
    cache_size: int = 10240
    num_ways: int = 4
    average_on_writeback: bool = False

    # ---- debugging / reporting (main_no_ddp.py:100-107) ----
    print_freq: int = 1
    test_freq: int = -1
    test_mini_batch_size: int = -1
    test_num_workers: int = -1
    print_time: bool = False  # parsed for reference-CLI parity only: the
    #   reference parses --print-time and never reads it
    #   (main_no_ddp.py:104); ms/it + amortized caching overhead are always
    #   in our print_freq window line (and --metrics-log)

    # ---- checkpointing (reference parses but never implements,
    #      main_no_ddp.py:111-112; we implement it) ----
    save_model: str = ""
    load_model: str = ""
    checkpoint_freq: int = -1  # steps; <=0 disables periodic checkpoints
    checkpoint_masters: str = "dirty"  # dirty | full. 'dirty' checkpoints
    #   the master tables as (procedural init + rows ever written back):
    #   masters only mutate via eviction writeback, so the dirty-row set is
    #   the exact delta — checkpoint size scales with rows written, not
    #   table size (at Terabyte geometry a full dump is 100s of GB). 'full'
    #   dumps every table (cache/master.py save). Resume is bit-identical
    #   either way (tests/test_trainer_e2e.py); 'dirty' requires loading
    #   with the same numpy_rand_seed + master geometry (guarded).
    inference_only: bool = False  # skip training; evaluate the test stream
    #   (typically with --load-model). The reference parses this flag but
    #   never uses it (main_no_ddp.py:140); here it is a real serving-style
    #   eval path.

    # ---- mlperf (main_no_ddp.py:116-124) ----
    mlperf_logging: bool = False  # parsed for reference-CLI parity only
    #   (the reference parses --mlperf-logging and never reads it,
    #   main_no_ddp.py:116); the stop thresholds below are LIVE here
    mlperf_acc_threshold: float = 0.0
    mlperf_auc_threshold: float = 0.0
    mlperf_bin_loader: bool = False
    mlperf_bin_shuffle: bool = False
    large_batch: bool = False  # parsed for reference-CLI parity only: the
    #   reference uses it to gate the terabyte streaming loader on
    #   large_batch AND memory_map (dlrm_data_pytorch.py:387); here the
    #   streaming loader is selected by memory_map alone — it has no
    #   small-batch penalty (per-day npz + carry stitching, data/criteo.py)

    # ---- distributed (main_no_ddp.py:127-137) ----
    world_size: int = 1  # number of DP shards (devices along the 'dp' mesh axis)
    table_agg_op: str = "mean"  # sum | mean | max
    table_agg_freq: int = 1
    table_agg_bucket: int = -1  # static union-slot bucket for the sparse
    #   touched-row exchange (train/step.py make_aggregate_step); -1 = auto
    #   from the exact bound table_agg_freq * batch * tables * pooled_width
    batch_fifo_size: int = 8
    eviction_fifo_size: int = 8
    eviction_fifo_timeout: int = 300

    # ---- additions of this system (no reference equivalent) ----
    use_cache: bool = True  # False = full tables resident in device memory (small configs)
    compute_dtype: str = "float32"  # float32 | bfloat16 (matmul operands; sums in float32)
    refill_broadcast: str = "strict"  # strict | delta | off. strict =
    #   faithful rank-0 whole-cache broadcast at refill (reference
    #   main_no_ddp.py:317-321); delta = ship only evicted rows and let the
    #   replica-identical insert scatter carry the new values — trajectory-
    #   equal to strict when table_agg_freq divides lookahead, at O(E*D)
    #   instead of O(R*D) collective bytes per refill; off = no collective
    #   (single-device)
    strict_bias_divergence: bool = False  # reproduce reference bias non-sync bug
    aux_capacity: int = -1  # miss-row slots per table per step; -1 = local batch
    data_host_slice: bool = False  # multi-host bin-loader IO slicing: each
    #   host READS only its replicas' row range of every train batch (the
    #   packed layout makes the slice one contiguous seek+read), zero-
    #   filling the rest so shapes and cursor accounting are unchanged. The
    #   prefetcher's index pass always reads full rows (host-identical
    #   cache metadata). Train-pass IO scales 1/H instead of 1x per host;
    #   the reference streams the full loader on every rank and slices on
    #   device (main_no_ddp.py:388-391). Bin loader only; 2-process
    #   trajectory pinned equal to unsliced (tests/test_multihost.py).
    pin_cores: bool = False  # sched_setaffinity pinning of pipeline threads
    main_start_core: int = 0  # base of the pin layout when pin_cores: main
    #   thread at +0, prefetcher +1, eviction +2, cache worker p at +3+p,
    #   Criteo loader worker w at +3+cache_workers+w — the reference's
    #   taskset layout (main_no_ddp.py:130,634, cache_manager.py:71,79,
    #   dlrm_data_pytorch.py:341-343); cores wrap modulo os.cpu_count()
    prefetch_backend: str = "thread"  # thread | process
    master_init: str = "uniform"  # uniform | tile | virtual (see cache/master.py)
    master_mmap_dir: str = ""  # file-back master tables here (enables process prefetch)
    pipeline_depth: int = 2  # batches probed/staged ahead of the device step
    scan_steps: int = 1  # >1 runs blocks of consecutive train steps: ONE
    #   enqueue per block instead of per step. Blocks are
    #   capped at window/print/test/agg/checkpoint boundaries, so every
    #   cadence fires at exactly the same global step; per-step metrics come
    #   back stacked. Compatible with dedup_lookups (per-window negotiated
    #   unique buckets keep wire shapes block-stable).
    probe_impl: str = "auto"  # auto | map | setassoc. 'map' keeps a flat
    #   id->cache-row direct map beside the occupancy: the host probe becomes
    #   one vectorized gather in place of the occupancy walk. Costs
    #   4 bytes of host RAM per embedding id; 'auto' enables it when that
    #   total is <= slot_map_max_bytes.
    slot_map_max_bytes: int = 1 << 32  # 4 GiB (small next to host masters).
    #   NOTE the prefetcher's shadow planner clones the map (D13), so the
    #   actual host RAM is 2x this budget when the map is enabled.
    pack_wire: bool = True  # 3-byte slot ids + narrow dtypes on host->device
    #   transfers (lossless; auto-disabled for tables >= 2^24 cache rows)
    enable_profiling: bool = False  # a profiler trace around training
    #   (the reference parses this flag but never uses it, main_no_ddp.py:106)
    profile_dir: str = "./jax_trace"  # where --enable-profiling writes traces
    #   (cdlrm_tpu's default, kept so both packages finalize alike)
    metrics_log: str = ""  # append one JSON line per print window / eval to
    #   this file (host 0 only): structured observability over the
    #   reference's print-only reporting (SURVEY.md §5) — step, ms/it,
    #   caching overhead, loss, accuracy, hit rates, wire decision, AUC
    wire_rows_bf16: bool = False  # ship refill/miss/evicted ROWS as bf16 —
    #   halves the dominant refill traffic; lossy once per staged row
    wire_x_fp8: bool = False  # ship dense features as float8_e4m3 (1 byte):
    #   halves the second-largest per-step H2D payload on thin host links.
    #   LOSSY (3 mantissa bits vs bf16's 8); compute upcasts at step entry.
    #   Gate on a convergence check for your data before production use.
    hot_tier_rows: int = 0  # H > 0: per-window hot-tier sparse update. The
    #   prefetcher's shadow pass picks the window's H-1 hottest resident
    #   cache rows (+ the reserved trash row); on device, hot lookup
    #   gradients coalesce via a one-hot segment-sum into ONE H-row
    #   scatter while cold lookups compact to an exactly-negotiated bucket —
    #   scatter rows per step drop from N lookups to H + cold.
    #   Exact semantics (same gradient sums, different float order).
    #   QUARANTINED in cdlrm_tpu (the auto-dedup wire removes the
    #   duplicate-chain cost more cheaply); finalize() warns when enabled,
    #   as cdlrm_tpu's does.
    use_pallas_lookup: bool = False  # cdlrm_tpu: its Pallas gather for
    #   cache lookups. Read by nothing here (module docstring)
    use_pallas_scatter: bool = False  # cdlrm_tpu: its Pallas row scatters
    #   for the dedup sparse update. Read by nothing here
    refill_prestage: bool = True  # start the refill's insert-row H2D while
    #   the previous window still trains: a depth-1 stager thread joins each
    #   shadow-planned window's insert plan (pure build_insert_plan) and
    #   dispatches the padded insert/evict transfers as soon as the window
    #   is ready, so the boundary pays only plan replay + dispatch instead
    #   of the synchronous transfer. Plan metadata/occupancy stay
    #   bit-identical (shadow-planned); inserted row VALUES keep the
    #   reference's eventually-consistent writeback envelope, read up to
    #   one window earlier (trainer._WindowStager doc). Multi-host: the
    #   same hoist runs on the MAIN thread at a deterministic mid-window
    #   point (first block of each window), because the window-row
    #   allgather must keep every host's collective sequence identical —
    #   it moves the allgather + plan join + insert H2D off the boundary
    #   (trainer._prefetch_next_window doc). Costs up to one extra
    #   window's rows + insert payload in host and device memory while
    #   staged.
    checkpoint_async: bool = False  # write checkpoint FILES on a background
    #   thread: the train-thread cost shrinks to the eviction flush + the
    #   device D2H + host-side snapshot copies; npz serialization/IO (the
    #   dominant cost for big masters) overlaps training. The snapshot is
    #   consistent: dirty-master rows are fancy-index-copied before any new
    #   writeback can land. A later save/load/close joins the writer and
    #   re-raises its errors. Multi-host: async saves skip the shared-dir
    #   visibility barrier (no collective may run off the main thread) —
    #   each host joins only its OWN writer, so resuming another host's
    #   async checkpoint from a shared dir needs external completion
    #   coordination (trainer.save_checkpoint doc); synchronous saves
    #   barrier before returning.
    pallas_interpret: bool = False  # cdlrm_tpu's tests only. Read by
    #   nothing here
    sorted_dedup_wire: bool = False  # emit the UNPACKED dedup wire's unique
    #   slots in ascending order (one stable host argsort; exact — segments
    #   keep their contents) so the device unique gather/scatter read
    #   ascending rows. Requires pack_wire=False; no-op on the non-dedup
    #   wire. Quarantined in cdlrm_tpu; finalize() warns when enabled, as
    #   cdlrm_tpu's does.
    block_coalesced_update: str = "auto"  # on | off | auto — scan-block
    #   pending-buffer sparse update (train/step.py StepConfig.block_coalesce):
    #   per-lookup grads scatter into a small pending buffer in
    #   block-union row space and the cache pays ONE union-row scatter per
    #   scan block instead of one unique-row scatter per step. SGD-exact up
    #   to float reassociation. Legality: scan_steps > 1,
    #   the unpacked dedup wire (dedup_lookups != 'off', pack_wire=False),
    #   optimizer='sgd', hot_tier_rows == 0. 'auto' (default) enables it
    #   exactly when legal; 'on' raises on an illegal combo. Multi-host: the
    #   per-block union bucket is negotiated with one tiny allgather-max on
    #   the main thread (deterministic collective order — blocks are pure
    #   functions of shared state). Blocks assembled in the plain wire
    #   (auto-dedup off-windows) fall back to the per-step update; size-1
    #   remainder blocks always do. Bools accepted (True='on', False='off').
    dedup_lookups: str = "auto"  # on | off | auto — coalesce duplicate slots
    #   on the host and ship (rank wire + unique list) instead of per-lookup
    #   slots: the device sparse update shrinks from N to U scatter rows
    #   (break-even near U=0.5N; the win scales with duplication). 'auto'
    #   (default): each lookahead window's measured duplication picks the
    #   wire — the shadow stats pass (cache/prefetcher.py) counts
    #   unique-vs-total lookups per window and enables dedup when
    #   U <= 0.5 N, so the default config is skew-safe with no tuning.
    #   Bools accepted (True='on', False='off').

    # -- multi-host (parallel/multihost.py; reference is single-node-only,
    # MASTER_ADDR='localhost' at main_no_ddp.py:341) --
    coordinator_address: str = ""  # host:port of process 0; "" = single-process
    num_hosts: int = -1  # process count of the cluster (-1 = from env)
    host_id: int = -1  # this process's id (-1 = from env)
    aux_bucket: int = -1  # fixed packed-miss buffer size for multi-host steps
    #   (-1 = aux capacity); must be identical on every host — the global
    #   aux array shape is part of the step

    # ---- derived (populated by finalize()) ----
    ln_emb: Optional[np.ndarray] = None
    ln_bot: Optional[List[int]] = None
    ln_top: Optional[List[int]] = None
    m_spa_per_table: Optional[List[int]] = None

    def finalize(self, ln_emb: Optional[np.ndarray] = None, m_den: Optional[int] = None) -> "Config":
        """Derive architecture dims and run the reference's sanity checks
        (main_no_ddp.py:514-619). ``ln_emb``/``m_den`` come from the dataset
        when data_generation == 'dataset'."""
        from cdlrm_tpu_torch.models.dlrm import derive_top_mlp_input_dim
        from cdlrm_tpu_torch.models.tricks import md_solver

        if self.test_mini_batch_size < 0:
            self.test_mini_batch_size = self.mini_batch_size
        if self.test_num_workers < 0:
            self.test_num_workers = self.num_workers

        self.ln_bot = _int_list(self.arch_mlp_bot)
        if ln_emb is None:
            ln_emb = np.array(_int_list(self.arch_embedding_size), dtype=np.int64)
        if self.max_ind_range > 0:
            ln_emb = np.minimum(ln_emb, self.max_ind_range)
        self.ln_emb = np.asarray(ln_emb, dtype=np.int64)
        if m_den is not None:
            self.ln_bot[0] = int(m_den)
        m_den = self.ln_bot[0]

        m_spa = self.arch_sparse_feature_size
        m_den_out = self.ln_bot[-1]
        num_int = derive_top_mlp_input_dim(
            len(self.ln_emb), m_den_out, self.arch_interaction_op, self.arch_interaction_itself
        )
        self.ln_top = [num_int] + _int_list(self.arch_mlp_top)

        # sanity checks (reference main_no_ddp.py:571-609)
        if self.scan_steps > 1 and self.pipeline_depth < self.scan_steps + 2:
            # a scan block consumes scan_steps staged batches at once; the
            # assembly pipeline must run at least that far ahead or the
            # device idles while the rest of the block stages
            self.pipeline_depth = self.scan_steps + 2
        if self.refill_broadcast is True:  # legacy bool spelling
            self.refill_broadcast = "strict"
        elif self.refill_broadcast is False:
            self.refill_broadcast = "off"
        if self.refill_broadcast not in ("strict", "delta", "off"):
            raise ValueError(
                f"refill_broadcast must be strict|delta|off, got "
                f"{self.refill_broadcast!r}"
            )
        if self.probe_impl not in ("auto", "map", "setassoc"):
            raise ValueError(
                f"probe_impl must be auto|map|setassoc, got {self.probe_impl!r}"
            )
        if self.dedup_lookups is True:  # legacy bool spelling
            self.dedup_lookups = "on"
        elif self.dedup_lookups is False:
            self.dedup_lookups = "off"
        if self.optimizer not in ("sgd", "adagrad"):
            raise ValueError(
                f"optimizer must be sgd|adagrad, got {self.optimizer!r}"
            )
        if self.optimizer == "adagrad":
            if self.use_cache and self.dedup_lookups != "on":
                raise ValueError(
                    "optimizer='adagrad' on the cached path requires "
                    "dedup_lookups='on': the row-wise state update needs "
                    "duplicate-slot lookups coalesced on the host "
                    "(config.py optimizer doc)"
                )
            if self.hot_tier_rows > 0:
                raise ValueError(
                    "optimizer='adagrad' is incompatible with the hot tier"
                )
            if self.qr_flag or self.md_flag:
                raise ValueError(
                    "optimizer='adagrad' supports plain embeddings only "
                    "(no QR/MD compression)"
                )
        if self.adagrad_master_state and self.optimizer != "adagrad":
            raise ValueError(
                "adagrad_master_state requires optimizer='adagrad'"
            )
        # block-coalesced sparse update: tri-state. 'auto' (default) turns
        # it on exactly when its preconditions hold and stays
        # silently off otherwise (auto-dedup's capability-gate pattern);
        # explicit 'on' raises on an illegal combination so a user who asked
        # for it learns why they can't have it. Resolved to a plain bool
        # here — everything downstream reads True/False.
        if self.block_coalesced_update is True:  # legacy bool spelling
            self.block_coalesced_update = "on"
        elif self.block_coalesced_update is False:
            self.block_coalesced_update = "off"
        if self.block_coalesced_update not in ("on", "off", "auto"):
            raise ValueError(
                "block_coalesced_update must be on|off|auto, got "
                f"{self.block_coalesced_update!r}"
            )
        # ONE legality list drives both modes ('auto' silently declines on
        # the first unmet condition; 'on' raises it) — two hand-kept copies
        # would drift and let auto enable an illegal combination
        _blk_illegal = []
        if self.scan_steps <= 1:
            _blk_illegal.append(
                "requires scan_steps > 1 (the flush amortizes over a "
                "scan block)"
            )
        if self.dedup_lookups == "off" or self.pack_wire:
            _blk_illegal.append(
                "requires the unpacked dedup wire: dedup_lookups "
                "'on'/'auto' and pack_wire=False"
            )
        if self.optimizer != "sgd":
            _blk_illegal.append(
                "requires optimizer='sgd' (pending-sum exactness breaks "
                "under per-step AdaGrad accumulators)"
            )
        if self.hot_tier_rows > 0:
            _blk_illegal.append("is incompatible with hot_tier_rows")
        if self.block_coalesced_update == "auto":
            self.block_coalesced_update = not _blk_illegal
        elif self.block_coalesced_update == "on":
            if _blk_illegal:
                raise ValueError(
                    "block_coalesced_update " + "; ".join(_blk_illegal)
                )
            self.block_coalesced_update = True
        else:
            self.block_coalesced_update = False
        if self.sorted_dedup_wire and self.pack_wire:
            raise ValueError(
                "sorted_dedup_wire requires the unpacked wire: pass "
                "pack_wire=False (the packed bitstream keeps the first-seen "
                "rank layout)"
            )
        if self.dedup_lookups not in ("on", "off", "auto"):
            raise ValueError(
                f"dedup_lookups must be on|off|auto, got {self.dedup_lookups!r}"
            )
        if (
            self.refill_broadcast == "delta"
            and self.table_agg_freq > 0
            and self.lookahead % self.table_agg_freq != 0
        ):
            import warnings

            # delta's trajectory-equality precondition (train/step.py
            # make_refill_step) is violated: replicas would keep divergent
            # untouched rows across refills — a silently different algorithm.
            # Fall back to the always-correct strict broadcast instead of
            # training with undocumented dynamics.
            warnings.warn(
                "refill_broadcast='delta' requires table_agg_freq to divide "
                f"lookahead (got freq={self.table_agg_freq}, lookahead="
                f"{self.lookahead}); falling back to 'strict' — replicas "
                "would otherwise keep divergent untouched rows across refills",
                stacklevel=2,
            )
            self.refill_broadcast = "strict"
        if self.optimizer == "adagrad" and max(
            self.learning_rate, self.lr_embeds
        ) > 0.2:
            import warnings

            # At SGD-scale lrs AdaGrad's first updates are ~sign-sized
            # (g/sqrt(g^2) = +-1 per element), which can saturate the
            # sigmoid. Warn, don't clamp — the user may know their loss
            # surface.
            warnings.warn(
                f"optimizer='adagrad' with lr={self.learning_rate}/"
                f"lr_embeds={self.lr_embeds}: AdaGrad first steps are "
                "sign-sized, and SGD-scale rates can saturate the sigmoid "
                "on a task that trains fine at smaller ones; consider "
                "lr <= 0.1",
                stacklevel=2,
            )
        if self.sorted_dedup_wire:
            import warnings

            # quarantined in cdlrm_tpu, like the hot tier
            warnings.warn(
                "sorted_dedup_wire is quarantined in cdlrm_tpu (its argsorted "
                "rank remap cost more than sorted indices bought there); "
                "enable only with an A/B measurement on your own stream",
                stacklevel=2,
            )
        if self.hot_tier_rows > 0:
            import warnings

            # quarantined in cdlrm_tpu: the membership resolve and the cold
            # compaction's padding cost more than the scatter rows it
            # removes, and auto-dedup already guards duplicate-heavy streams
            warnings.warn(
                f"hot_tier_rows={self.hot_tier_rows}: the hot-tier update is "
                "quarantined in cdlrm_tpu; enable only with an A/B "
                "measurement on your own stream",
                stacklevel=2,
            )
        if self.qr_flag:
            if self.qr_operation == "concat" and 2 * m_spa != m_den_out:
                raise ValueError(
                    f"2*sparse-feature-size {2*m_spa} != bottom MLP out {m_den_out} "
                    "(concat QR requires bottom out = 2x embedding dim)"
                )
            if self.qr_operation != "concat" and m_spa != m_den_out:
                raise ValueError(f"sparse-feature-size {m_spa} != bottom MLP out {m_den_out}")
        else:
            if m_spa != m_den_out:
                raise ValueError(f"sparse-feature-size {m_spa} != bottom MLP out {m_den_out}")

        if self.md_flag:
            self.m_spa_per_table = list(
                md_solver(
                    self.ln_emb,
                    self.md_temperature,
                    d0=m_spa,
                    round_dim=self.md_round_dims,
                )
            )
        else:
            self.m_spa_per_table = [m_spa] * len(self.ln_emb)
        return self

    # convenience accessors -------------------------------------------------
    @property
    def m_spa(self) -> int:
        return self.arch_sparse_feature_size

    @property
    def local_batch_size(self) -> int:
        """Per-DP-shard batch (reference main_no_ddp.py:344)."""
        return math.ceil(self.mini_batch_size / self.world_size)

    @property
    def loss_weights_list(self) -> List[float]:
        return [float(v) for v in self.loss_weights.split("-")]

    @property
    def cache_sets(self) -> int:
        return next_prime(self.cache_size)


def build_arg_parser() -> argparse.ArgumentParser:
    """CLI mirroring the reference's live flags (main_no_ddp.py:34-145)."""
    p = argparse.ArgumentParser(description="Train DLRM (cDLRM, PyTorch + CUDA)")
    for f in dataclasses.fields(Config):
        if f.name in ("ln_emb", "ln_bot", "ln_top", "m_spa_per_table"):
            continue
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            # BooleanOptionalAction adds --no-<flag>, so default-True
            # tunables (pack-wire, refill-broadcast, use-cache) stay
            # disable-able from the CLI
            p.add_argument(
                flag, action=argparse.BooleanOptionalAction, default=f.default
            )
        else:
            typ = type(f.default)
            p.add_argument(flag, type=typ, default=f.default)
    return p


def config_from_args(argv=None) -> Config:
    ns = build_arg_parser().parse_args(argv)
    return Config(**vars(ns))


def finalize(
    cfg: Config, ln_emb: Optional[np.ndarray] = None, m_den: Optional[int] = None
) -> Config:
    """``cfg.finalize(ln_emb, m_den)``, kept as a function for its callers."""
    return cfg.finalize(ln_emb=ln_emb, m_den=m_den)


def build_dataset(cfg: Config):
    """:func:`cdlrm_tpu_torch.cli.build_dataset` under its earlier name:
    returns (train_ds, test_ds, cfg) with the config finalized."""
    from cdlrm_tpu_torch.cli import build_dataset as cli_build_dataset

    return cli_build_dataset(cfg)
