"""Synthetic data generators (reference C19,
dlrm_data_pytorch.py:551-1129).

Canonical batch layout of this framework (all numpy, host-side):
  x:       [B, m_den] float32   dense features
  ls_i:    [T, B] int64         single-index lookups (Criteo layout), or
           [T, B, P] int64      padded multi-hot lookups
  ls_mask: None                 for single-index, or
           [T, B, P] bool       valid-position mask for multi-hot
  y:       [B, 1] float32       targets

The reference's variable-length bag layout (per-table offsets+indices,
dlrm_data_pytorch.py:763-805) is re-expressed as a *static-shape* padded
layout: the device steps take fixed shapes, and a masked sum reproduces
EmbeddingBag(mode="sum") exactly. Like the reference, duplicate indices
within one lookup are removed (np.unique at dlrm_data_pytorch.py:793).

Generators are rebuilt with the same seed for each iteration pass, mirroring
``reset_seed_on_access=True`` (dlrm_data_pytorch.py:608-610,676): the trainer
stream and the prefetcher's cache stream observe identical batches.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np


class Batch(NamedTuple):
    x: np.ndarray
    ls_i: np.ndarray
    ls_mask: Optional[np.ndarray]
    y: np.ndarray


def generate_uniform_batch(
    rng: np.random.Generator,
    m_den: int,
    ln_emb: Sequence[int],
    n: int,
    num_indices_per_lookup: int,
    fixed: bool,
    round_targets: bool = False,
) -> Batch:
    """Uniform-random batch (reference generate_uniform_input_batch,
    dlrm_data_pytorch.py:763-805), vectorized. Single-index layout when
    num_indices_per_lookup == 1 and fixed."""
    x = rng.random((n, m_den), dtype=np.float32)
    y = rng.random((n, 1), dtype=np.float32)
    if round_targets:
        y = np.round(y)

    t_count = len(ln_emb)
    single = fixed and num_indices_per_lookup == 1
    if single:
        ls_i = np.stack(
            [rng.integers(0, size, size=n, dtype=np.int64) for size in ln_emb]
        )
        return Batch(x, ls_i, None, y)

    p = num_indices_per_lookup
    ls_i = np.zeros((t_count, n, p), dtype=np.int64)
    ls_mask = np.zeros((t_count, n, p), dtype=bool)
    for t, size in enumerate(ln_emb):
        if fixed:
            counts = np.full(n, min(p, size), dtype=np.int64)
        else:
            r = rng.random(n)
            counts = np.maximum(1, np.round(r * min(size, p))).astype(np.int64)
        idx = rng.integers(0, size, size=(n, p), dtype=np.int64)
        pos = np.arange(p)[None, :]
        valid = pos < counts[:, None]
        # per-lookup dedup (reference np.unique, dlrm_data_pytorch.py:793):
        # sort each row, mark first occurrences among the valid prefix
        idx_sorted = np.sort(np.where(valid, idx, np.iinfo(np.int64).max), axis=1)
        firsts = np.ones_like(valid)
        firsts[:, 1:] = idx_sorted[:, 1:] != idx_sorted[:, :-1]
        mask = valid & firsts
        # re-read sorted values where valid (padding keeps last valid value,
        # masked out anyway)
        ls_i[t] = np.where(mask, idx_sorted, 0)
        ls_mask[t] = mask
    return Batch(x, ls_i, ls_mask, y)


# ---------------------------------------------------------------------------
# trace-driven synthetic generation (stack-distance model,
# reference dlrm_data_pytorch.py:809-1001)
# ---------------------------------------------------------------------------


def trace_profile(
    trace: Sequence[int], enable_padding: bool = False
) -> Tuple[List[int], List[int], List[int]]:
    """Profile a reference trace into (final stack, stack distances, first
    accesses) — the LRU stack-distance model (dlrm_data_pytorch.py:956-1001).
    Distances use depth l - i (consecutive repeats have distance 1).

    ``enable_padding`` (dlrm_data_pytorch.py:985-995): long traces with small
    cardinality c produce few new (sd=0) samples relative to trace length l,
    so the fitted distribution under-weights new references; pad ceil(l/c)
    zero-distances to put new samples on par with the per-line average."""
    rstack: List[int] = []
    stack_distances: List[int] = []
    line_accesses: List[int] = []
    pos = {}
    for x in trace:
        r = int(x)
        if r in pos:
            # find depth from top; list.index is O(n) in the reference too —
            # keep a dict + list for the same semantics at lower cost
            i = rstack.index(r)
            sd = len(rstack) - i
            stack_distances.insert(0, sd)
            rstack.pop(i)
            rstack.append(r)
        else:
            stack_distances.insert(0, 0)
            line_accesses.insert(0, r)
            rstack.append(r)
            pos[r] = True
    if enable_padding and stack_distances:
        l = len(stack_distances)
        c = max(1, max(stack_distances))  # all-new trace: max sd is 0
        stack_distances = stack_distances + [0] * int(np.ceil(l / c))
    return rstack, stack_distances, line_accesses


def _sample_stack_distance(
    rng, cumm_val, cumm_dist, max_i, i, enable_padding=False
) -> int:
    u = float(rng.random())
    if i < max_i:
        j = bisect.bisect(cumm_val, i) - 1
        u *= cumm_dist[j]
    elif enable_padding:
        fi = cumm_dist[0]
        u = (1.0 - fi) * u + fi
    for j, f in enumerate(cumm_dist):
        if u <= f:
            return cumm_val[j]
    return cumm_val[-1]


def trace_generate_lru(
    rng: np.random.Generator,
    line_accesses: List[int],
    list_sd: List[int],
    cumm_sd: List[float],
    out_trace_len: int,
    enable_padding: bool = False,
) -> List[int]:
    """Generate a synthetic access trace from a stack-distance distribution,
    maintaining the LRU stack (dlrm_data_pytorch.py:904-930)."""
    line_accesses = list(line_accesses)
    max_sd = list_sd[-1]
    l = len(line_accesses)
    i = 0
    out = []
    for _ in range(out_trace_len):
        sd = _sample_stack_distance(rng, list_sd, cumm_sd, max_sd, i, enable_padding)
        if sd == 0:  # new reference
            ref = line_accesses.pop(0)
            line_accesses.append(ref)
            i += 1
        else:  # existing reference; move to MRU position
            ref = line_accesses[l - sd]
            line_accesses.pop(l - sd)
            line_accesses.append(ref)
        out.append(ref)
    return out


def trace_generate_rand(
    rng: np.random.Generator,
    line_accesses: List[int],
    list_sd: List[int],
    cumm_sd: List[float],
    out_trace_len: int,
    enable_padding: bool = False,
) -> List[int]:
    """Generate a synthetic trace from a stack-distance distribution WITHOUT
    maintaining LRU recency (dlrm_data_pytorch.py:933-953, the reference's
    commented-out alternative to the LRU model at :850): new (sd=0)
    references rotate the first-access list exactly as the LRU variant, but
    an existing reference reads position l-sd without moving it to the MRU
    end — repeat accesses don't reshape the stack."""
    line_accesses = list(line_accesses)
    max_sd = list_sd[-1]
    l = len(line_accesses)
    i = 0
    out = []
    for _ in range(out_trace_len):
        sd = _sample_stack_distance(rng, list_sd, cumm_sd, max_sd, i, enable_padding)
        if sd == 0:  # new reference
            ref = line_accesses.pop(0)
            line_accesses.append(ref)
            i += 1
        else:  # existing reference; stack NOT reordered
            ref = line_accesses[l - sd]
        out.append(ref)
    return out


def read_dist_from_file(path: str):
    """Load (line_accesses, list_sd, cumm_sd) written one-list-per-line."""
    with open(path) as f:
        lines = f.read().splitlines()
    unique_accesses = [int(el) for el in lines[0].split(", ")]
    list_sd = [int(el) for el in lines[1].split(", ")]
    cumm_sd = [float(el) for el in lines[2].split(", ")]
    return unique_accesses, list_sd, cumm_sd


def write_dist_to_file(path: str, unique_accesses, list_sd, cumm_sd) -> None:
    with open(path, "w") as f:
        f.write(", ".join(str(v) for v in unique_accesses) + "\n")
        f.write(", ".join(str(v) for v in list_sd) + "\n")
        f.write(", ".join(str(v) for v in cumm_sd) + "\n")


def generate_synthetic_batch(
    rng: np.random.Generator,
    m_den: int,
    ln_emb: Sequence[int],
    n: int,
    num_indices_per_lookup: int,
    fixed: bool,
    trace_file: str,
    enable_padding: bool = False,
    round_targets: bool = False,
    trace_model: str = "lru",
) -> Batch:
    """Trace-driven synthetic batch (dlrm_data_pytorch.py:809-880): per-table
    stack-distance distribution files (trace_file with 'j' replaced by the
    table id) drive an LRU-model index stream. ``trace_model``: 'lru'
    (reference default, :854) or 'rand' (the :850 alternative — no recency
    reordering on repeat accesses)."""
    x = rng.random((n, m_den), dtype=np.float32)
    y = rng.random((n, 1), dtype=np.float32)
    if round_targets:
        y = np.round(y)
    p = num_indices_per_lookup
    t_count = len(ln_emb)
    ls_i = np.zeros((t_count, n, p), dtype=np.int64)
    ls_mask = np.zeros((t_count, n, p), dtype=bool)
    for t, size in enumerate(ln_emb):
        line_accesses, list_sd, cumm_sd = read_dist_from_file(
            trace_file.replace("j", str(t))
        )
        for b in range(n):
            if fixed:
                cnt = p
            else:
                cnt = max(1, int(np.round(float(rng.random()) * min(size, p))))
            gen = trace_generate_lru if trace_model == "lru" else trace_generate_rand
            refs = gen(
                rng, line_accesses, list_sd, cumm_sd, cnt, enable_padding
            )
            group = np.unique(np.asarray(refs, dtype=np.int64))
            if group.min() < 0 or group.max() >= size:
                group = np.mod(group, size)
                group = np.unique(group)
            k = min(group.size, p)
            ls_i[t, b, :k] = group[:k]
            ls_mask[t, b, :k] = True
    return Batch(x, ls_i, ls_mask, y)


@dataclass
class SyntheticDataset:
    """Deterministic, restartable synthetic stream (reference RandomDataset,
    dlrm_data_pytorch.py:551-646). Every ``batches()`` call restarts the
    stream from the seed, so trainer and prefetcher iterate identical data
    (the reference's two-loader pattern, dlrm_data_pytorch.py:465-483)."""

    m_den: int
    ln_emb: np.ndarray
    data_size: int
    mini_batch_size: int
    num_batches: int = 0
    num_indices_per_lookup: int = 1
    num_indices_per_lookup_fixed: bool = True
    round_targets: bool = False
    data_generation: str = "random"
    trace_file: str = ""
    enable_padding: bool = False
    trace_model: str = "lru"  # 'lru' | 'rand' (dlrm_data_pytorch.py:850-854)
    seed: int = 123

    def __post_init__(self):
        nbatches = int(np.ceil(self.data_size / self.mini_batch_size))
        if self.num_batches:
            nbatches = self.num_batches
            self.data_size = nbatches * self.mini_batch_size
        self.num_batches = nbatches
        self.ln_emb = np.asarray(self.ln_emb, dtype=np.int64)

    def __len__(self) -> int:
        return self.num_batches

    def batches(self, skip: int = 0) -> Iterator[Batch]:
        """Restartable stream; ``skip`` seeks past the first ``skip`` batches
        in O(1) (checkpoint data-cursor contract, trainer.py): each batch
        draws from its own (seed, index)-derived generator, so batch i is
        identical whether or not earlier batches were materialized."""
        for i in range(skip, self.num_batches):
            rng = np.random.default_rng([self.seed, i])
            n = min(self.mini_batch_size, self.data_size - i * self.mini_batch_size)
            if self.data_generation == "random":
                yield generate_uniform_batch(
                    rng,
                    self.m_den,
                    self.ln_emb,
                    n,
                    self.num_indices_per_lookup,
                    self.num_indices_per_lookup_fixed,
                    self.round_targets,
                )
            elif self.data_generation == "synthetic":
                yield generate_synthetic_batch(
                    rng,
                    self.m_den,
                    self.ln_emb,
                    n,
                    self.num_indices_per_lookup,
                    self.num_indices_per_lookup_fixed,
                    self.trace_file,
                    self.enable_padding,
                    self.round_targets,
                    self.trace_model,
                )
            else:
                raise ValueError(f"unsupported data_generation: {self.data_generation}")
