// Native host-path kernels for cdlrm_tpu_torch (the port's own copy of
// cdlrm_tpu's csrc/host_ops.cpp: the same C symbols and the same outputs,
// built into a library of its own).
//
// The reference (lkp411/cDLRM) runs its host hot path in numpy/torch across
// a taskset-pinned mp.Pool (cache_manager.py:20-46,77-100).
// Our single-controller design keeps the same three host hot spots, rebuilt
// as fused C++ loops instead of multi-pass numpy:
//
//   1. set-associative probe  (reference model_no_ddp.py:163-187: idx % sets,
//      occupancy compare, hit/miss partition, aux-slot assignment) — numpy
//      needs ~6 full passes + temporaries; here one pass per lookup.
//   2. lookahead-window dedup (reference torch.unique per table,
//      cache_manager.py:32-34) — bitmap (O(n)) when the id space is dense
//      enough, LSD radix sort (O(n * live_bytes)) otherwise; both return
//      sorted uniques like np.unique.
//   3. master-row gather / eviction writeback (reference
//      fetch_unique_idx_slices, model_no_ddp.py:80-87; writeback
//      cache_manager.py:58-62) — OpenMP row-parallel memcpy.
//
// Beside them, the prefetcher's per-window probe statistics (section 5):
// one GIL-free call per window entry instead of a numpy loop over tables.
//
// All entry points are extern "C" and called through ctypes
// (cdlrm_tpu_torch/ops/native.py). Thread counts come from OpenMP's runtime
// default (the deployment host is many-core; CI may be 1-core — the loops
// are written to win single-threaded too).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// threading controls
// ---------------------------------------------------------------------------

int cdlrm_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

void cdlrm_set_num_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

// ---------------------------------------------------------------------------
// 1. set-associative probe
// ---------------------------------------------------------------------------

// Probe one table's lookups against its occupancy.
//   occ:     [sets * ways] int32, row-major [set][way], -1 = empty
//   idx:     [n] int64 lookup ids (all < 2^31 by dataset contract)
//   valid:   [n] uint8 or nullptr; invalid positions resolve to trash_row
//   slots:   [n] int32 out — global cache rows
//   miss_pos:[n] int32 out — positions (in batch order) of valid misses;
//            the k-th miss gets aux slot aux_base + k
// Returns the miss count.
//
// Semantics mirror HostCacheController.probe (cache/host_cache.py) and the
// reference probe (model_no_ddp.py:163-187): hit slot =
// table_offset + way * sets + set; misses take consecutive aux slots in
// batch order; masked positions go to trash_row even when they'd hit.
int64_t cdlrm_probe_table(const int32_t* occ, int64_t sets, int64_t ways,
                          const int64_t* idx, int64_t n, const uint8_t* valid,
                          int64_t table_offset, int64_t aux_base,
                          int64_t trash_row, int32_t* slots,
                          int32_t* miss_pos) {
  int64_t n_miss = 0;
  const int32_t sets32 = (int32_t)sets;
  const int64_t PF = 16;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n && (!valid || valid[i + PF])) {
      const int32_t vp = (int32_t)idx[i + PF];
      __builtin_prefetch(occ + (int64_t)(vp % sets32) * ways, 0, 1);
    }
    if (valid && !valid[i]) {
      slots[i] = (int32_t)trash_row;
      continue;
    }
    const int32_t v = (int32_t)idx[i];
    const int32_t s = v % sets32;
    const int32_t* row = occ + (int64_t)s * ways;
    int32_t w = -1;
    for (int64_t k = 0; k < ways; ++k) {
      if (row[k] == v) {
        w = (int32_t)k;
        break;
      }
    }
    if (w >= 0) {
      slots[i] = (int32_t)(table_offset + (int64_t)w * sets + s);
    } else {
      miss_pos[n_miss] = (int32_t)i;
      slots[i] = (int32_t)(aux_base + n_miss);
      ++n_miss;
    }
  }
  return n_miss;
}

// Wire-format probe: like cdlrm_probe_table but emits table-LOCAL 3-byte
// slot ids directly (the train-step wire format, cdlrm_tpu_torch/train/step.py
// pack_slots) — probe + pack in one pass. Hit -> way*sets + set; miss ->
// aux_base_local + k; masked -> sentinel 0xFFFFFF. Emits software
// prefetches PF lookups ahead: the probe is bound by the random occupancy
// reads (one cache line each).
int64_t cdlrm_probe_table_wire(const int32_t* occ, int64_t sets, int64_t ways,
                               const int64_t* idx, int64_t n,
                               const uint8_t* valid, int64_t aux_base_local,
                               int32_t* miss_pos, uint8_t* wire) {
  const int32_t sets32 = (int32_t)sets;
  const int64_t PF = 16;
  int64_t n_miss = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n && (!valid || valid[i + PF])) {
      const int32_t vp = (int32_t)idx[i + PF];
      __builtin_prefetch(occ + (int64_t)(vp % sets32) * ways, 0, 1);
    }
    uint32_t slot;
    if (valid && !valid[i]) {
      slot = 0xFFFFFFu;  // sentinel: masked padding -> trash row
    } else {
      const int32_t v = (int32_t)idx[i];
      const int32_t s = v % sets32;
      const int32_t* row = occ + (int64_t)s * ways;
      int32_t w = -1;
      for (int64_t k = 0; k < ways; ++k) {
        if (row[k] == v) {
          w = (int32_t)k;
          break;
        }
      }
      if (w >= 0) {
        slot = (uint32_t)((int64_t)w * sets + s);
      } else {
        miss_pos[n_miss] = (int32_t)i;
        slot = (uint32_t)(aux_base_local + n_miss);
        ++n_miss;
      }
    }
    wire[i * 3 + 0] = (uint8_t)(slot & 0xFF);
    wire[i * 3 + 1] = (uint8_t)((slot >> 8) & 0xFF);
    wire[i * 3 + 2] = (uint8_t)((slot >> 16) & 0xFF);
  }
  return n_miss;
}

// Bitstream-format probe: like cdlrm_probe_table_wire but emits slot ids as
// an LSB-first bitstream of `bits`-wide values (the variable-width wire
// format, train/step.py pack_slots) — probe + bit-pack in one pass.
int64_t cdlrm_probe_table_wirebits(const int32_t* occ, int64_t sets,
                                   int64_t ways, const int64_t* idx, int64_t n,
                                   const uint8_t* valid,
                                   int64_t aux_base_local, int64_t bits,
                                   int32_t* miss_pos, uint8_t* out) {
  const int32_t sets32 = (int32_t)sets;
  const uint32_t sentinel = (uint32_t)((1u << bits) - 1u);
  const int64_t PF = 16;
  int64_t n_miss = 0;
  uint64_t acc = 0;
  int accbits = 0;
  uint8_t* p = out;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n && (!valid || valid[i + PF])) {
      const int32_t vp = (int32_t)idx[i + PF];
      __builtin_prefetch(occ + (int64_t)(vp % sets32) * ways, 0, 1);
    }
    uint32_t slot;
    if (valid && !valid[i]) {
      slot = sentinel;  // masked padding -> trash row
    } else {
      const int32_t v = (int32_t)idx[i];
      const int32_t s = v % sets32;
      const int32_t* row = occ + (int64_t)s * ways;
      int32_t w = -1;
      for (int64_t k = 0; k < ways; ++k) {
        if (row[k] == v) {
          w = (int32_t)k;
          break;
        }
      }
      if (w >= 0) {
        slot = (uint32_t)((int64_t)w * sets + s);
      } else {
        miss_pos[n_miss] = (int32_t)i;
        slot = (uint32_t)(aux_base_local + n_miss);
        ++n_miss;
      }
    }
    acc |= (uint64_t)(slot & sentinel) << accbits;
    accbits += (int)bits;
    while (accbits >= 8) {
      *p++ = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      accbits -= 8;
    }
  }
  if (accbits) *p++ = (uint8_t)(acc & 0xFF);
  return n_miss;
}

// Direct-map probe + bit-pack in one pass (the fastest host probe path:
// cache/host_cache.py probe_impl=map). The flat id->row map replaces the
// occupancy walk; per lookup: one map load, miss test, local-slot compute,
// bitstream emit, with fewer memory touches than numpy gather + pack.
int64_t cdlrm_map_probe_table_wirebits(const int32_t* map_flat,
                                       int64_t id_base, const int64_t* idx,
                                       int64_t n, const uint8_t* valid,
                                       int64_t table_offset,
                                       int64_t aux_base_local, int64_t bits,
                                       int32_t* miss_pos, uint8_t* out) {
  const uint32_t sentinel = (uint32_t)((1u << bits) - 1u);
  const int64_t PF = 16;
  int64_t n_miss = 0;
  uint64_t acc = 0;
  int accbits = 0;
  uint8_t* p = out;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n && (!valid || valid[i + PF]))
      __builtin_prefetch(map_flat + id_base + idx[i + PF], 0, 1);
    uint32_t slot;
    if (valid && !valid[i]) {
      slot = sentinel;  // masked padding -> trash row
    } else {
      const int32_t m = map_flat[id_base + idx[i]];
      if (m >= 0) {
        slot = (uint32_t)((int64_t)m - table_offset);
      } else {
        miss_pos[n_miss] = (int32_t)i;
        slot = (uint32_t)(aux_base_local + n_miss);
        ++n_miss;
      }
    }
    acc |= (uint64_t)(slot & sentinel) << accbits;
    accbits += (int)bits;
    while (accbits >= 8) {
      *p++ = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      accbits -= 8;
    }
  }
  if (accbits) *p++ = (uint8_t)(acc & 0xFF);
  return n_miss;
}

// Batch variant, OpenMP-parallel over tables.
void cdlrm_map_probe_batch_wire(const int32_t* map_flat,
                                const int64_t* id_bases, int64_t t_count,
                                const int64_t* idx, int64_t n,
                                const uint8_t* valid,
                                const int64_t* table_offsets,
                                const int64_t* aux_bases_local, int64_t bits,
                                int64_t bytes_per_table, uint8_t* out,
                                int32_t* miss_pos, int64_t* miss_counts) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    miss_counts[t] = cdlrm_map_probe_table_wirebits(
        map_flat, id_bases[t], idx + t * n, n,
        valid ? valid + t * n : nullptr, table_offsets[t],
        aux_bases_local[t], bits, miss_pos + t * n,
        out + t * bytes_per_table);
  }
}

// Dedup probe: probe + duplicate-slot coalescing in one pass. The device
// scatter-add pays per updated row
// and Zipf index streams are duplicate-heavy, so shipping each lookup as a
// RANK into a per-step unique-slot list lets the device segment-sum
// duplicate gradients into a small [U, D] operand and scatter only U rows.
//
// Emits, per table:
//   inv_out:  LSB-first bitstream of inv_bits-wide table-LOCAL ranks in
//             first-seen order (masked positions -> all-ones sentinel)
//   uniq_out: [n_uniq] GLOBAL cache rows in first-seen order
//   miss_pos/miss count: as cdlrm_probe_table (misses get distinct aux
//             slots, hence distinct ranks — reference miss semantics,
//             model_no_ddp.py:176-185)
// rank_scratch: [ways*sets + aux_capacity] int32, all -1 on entry; the
// kernel self-cleans it by walking its own uniq list before returning.
int64_t cdlrm_probe_table_dedup(const int32_t* occ, int64_t sets, int64_t ways,
                                const int64_t* idx, int64_t n,
                                const uint8_t* valid, int64_t aux_base_local,
                                int64_t aux_capacity, int64_t table_offset,
                                int64_t inv_bits, int32_t* rank_scratch,
                                uint8_t* inv_out, int32_t* uniq_out,
                                int32_t* miss_pos, int64_t* n_miss_out) {
  const int32_t sets32 = (int32_t)sets;
  // inv_bits == 32: the LSB-first bitstream degenerates to a raw
  // little-endian int32 array (the UNPACKED dedup wire for fast host
  // links; sentinel = 0xFFFFFFFF reads back as -1)
  const uint32_t sentinel =
      inv_bits >= 32 ? 0xFFFFFFFFu : (uint32_t)((1u << inv_bits) - 1u);
  const int64_t PF = 16;
  int64_t n_miss = 0, n_uniq = 0;
  uint64_t acc = 0;
  int accbits = 0;
  uint8_t* p = inv_out;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n && (!valid || valid[i + PF])) {
      const int32_t vp = (int32_t)idx[i + PF];
      __builtin_prefetch(occ + (int64_t)(vp % sets32) * ways, 0, 1);
    }
    uint32_t rank;
    if (valid && !valid[i]) {
      rank = sentinel;  // masked padding -> trash rank on device
    } else {
      const int32_t v = (int32_t)idx[i];
      const int32_t s = v % sets32;
      const int32_t* row = occ + (int64_t)s * ways;
      int32_t w = -1;
      for (int64_t k = 0; k < ways; ++k) {
        if (row[k] == v) {
          w = (int32_t)k;
          break;
        }
      }
      int64_t local;
      if (w >= 0) {
        local = (int64_t)w * sets + s;
      } else {
        // scratch is sized aux_base_local + aux_capacity: clamp overflow
        // misses to the last aux slot (memory-safe garbage) and keep
        // counting — the Python-side guard raises the aux-capacity
        // ValueError from the true count before any output is consumed.
        // aux_capacity == 0 leaves no aux slot at all: emit the sentinel
        // rank and skip the scratch entirely.
        if (n_miss < n) miss_pos[n_miss] = (int32_t)i;
        ++n_miss;
        if (aux_capacity <= 0) {
          rank = sentinel;
          goto emit;
        }
        local = aux_base_local +
                (n_miss - 1 < aux_capacity ? n_miss - 1 : aux_capacity - 1);
      }
      int32_t r = rank_scratch[local];
      if (r < 0) {
        r = (int32_t)n_uniq;
        rank_scratch[local] = r;
        uniq_out[n_uniq++] = (int32_t)(table_offset + local);
      }
      rank = (uint32_t)r;
    }
  emit:
    acc |= (uint64_t)(rank & sentinel) << accbits;
    accbits += (int)inv_bits;
    while (accbits >= 8) {
      *p++ = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      accbits -= 8;
    }
  }
  if (accbits) *p++ = (uint8_t)(acc & 0xFF);
  // self-clean the scratch (touched entries only: U <= n)
  for (int64_t j = 0; j < n_uniq; ++j)
    rank_scratch[uniq_out[j] - table_offset] = -1;
  *n_miss_out = n_miss;
  return n_uniq;
}

// Dedup batch probe, OpenMP-parallel over tables.
void cdlrm_probe_batch_dedup(const int32_t* const* occ_ptrs,
                             const int64_t* sets, int64_t ways, int64_t t_count,
                             const int64_t* idx, int64_t n,
                             const uint8_t* valid,
                             const int64_t* aux_bases_local,
                             int64_t aux_capacity,
                             const int64_t* table_offsets, int64_t inv_bits,
                             int64_t inv_bytes_per_table,
                             int32_t* const* rank_scratch_ptrs,
                             uint8_t* inv_out, int32_t* uniq_out,
                             int64_t* uniq_counts, int32_t* miss_pos,
                             int64_t* miss_counts) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    uniq_counts[t] = cdlrm_probe_table_dedup(
        occ_ptrs[t], sets[t], ways, idx + t * n, n,
        valid ? valid + t * n : nullptr, aux_bases_local[t], aux_capacity,
        table_offsets[t], inv_bits, rank_scratch_ptrs[t],
        inv_out + t * inv_bytes_per_table,
        uniq_out + t * n, miss_pos + t * n, &miss_counts[t]);
  }
}

// Direct-map dedup probe: one pass per lookup does map gather + first-seen
// rank assignment + bit pack — the O(1)-probe analogue of
// cdlrm_probe_table_dedup (the occupancy walk costs one random DRAM line
// per PROBE; the map costs one 4-byte gather). Same outputs, bit-identical
// (tests/test_native.py). rank_scratch indexed by LOCAL slot as above.
int64_t cdlrm_map_probe_table_dedup(
    const int32_t* map_flat, int64_t id_base, const int64_t* idx, int64_t n,
    const uint8_t* valid, int64_t table_offset, int64_t aux_base_local,
    int64_t aux_capacity, int64_t inv_bits, int32_t* rank_scratch,
    uint8_t* inv_out, int32_t* uniq_out, int32_t* miss_pos,
    int64_t* n_miss_out) {
  const uint32_t sentinel =
      inv_bits >= 32 ? 0xFFFFFFFFu : (uint32_t)((1u << inv_bits) - 1u);
  const int64_t PF = 16;
  int64_t n_miss = 0, n_uniq = 0;
  uint64_t acc = 0;
  int accbits = 0;
  uint8_t* p = inv_out;
  for (int64_t i = 0; i < n; ++i) {
    if (i + PF < n && (!valid || valid[i + PF]))
      __builtin_prefetch(map_flat + id_base + idx[i + PF], 0, 1);
    uint32_t rank;
    if (valid && !valid[i]) {
      rank = sentinel;  // masked padding -> trash rank on device
    } else {
      const int32_t m = map_flat[id_base + idx[i]];
      int64_t local;
      if (m >= 0) {
        local = (int64_t)m - table_offset;
      } else {
        if (n_miss < n) miss_pos[n_miss] = (int32_t)i;
        ++n_miss;
        if (aux_capacity <= 0) {
          rank = sentinel;
          goto emit;
        }
        local = aux_base_local +
                (n_miss - 1 < aux_capacity ? n_miss - 1 : aux_capacity - 1);
      }
      int32_t r = rank_scratch[local];
      if (r < 0) {
        r = (int32_t)n_uniq;
        rank_scratch[local] = r;
        uniq_out[n_uniq++] = (int32_t)(table_offset + local);
      }
      rank = (uint32_t)r;
    }
  emit:
    acc |= (uint64_t)(rank & sentinel) << accbits;
    accbits += (int)inv_bits;
    while (accbits >= 8) {
      *p++ = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      accbits -= 8;
    }
  }
  if (accbits) *p++ = (uint8_t)(acc & 0xFF);
  for (int64_t j = 0; j < n_uniq; ++j)
    rank_scratch[uniq_out[j] - table_offset] = -1;
  *n_miss_out = n_miss;
  return n_uniq;
}

void cdlrm_map_probe_batch_dedup(
    const int32_t* map_flat, const int64_t* id_bases, int64_t t_count,
    const int64_t* idx, int64_t n, const uint8_t* valid,
    const int64_t* table_offsets, const int64_t* aux_bases_local,
    int64_t aux_capacity, int64_t inv_bits, int64_t inv_bytes_per_table,
    int32_t* const* rank_scratch_ptrs, uint8_t* inv_out, int32_t* uniq_out,
    int64_t* uniq_counts, int32_t* miss_pos, int64_t* miss_counts) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    uniq_counts[t] = cdlrm_map_probe_table_dedup(
        map_flat, id_bases[t], idx + t * n, n,
        valid ? valid + t * n : nullptr, table_offsets[t],
        aux_bases_local[t], aux_capacity, inv_bits, rank_scratch_ptrs[t],
        inv_out + t * inv_bytes_per_table, uniq_out + t * n,
        miss_pos + t * n, &miss_counts[t]);
  }
}

// Pack int64 values (< 0 => all-ones sentinel) into an LSB-first bitstream
// of `bits`-wide values — the generic wire emitter (train/step.py pack_slots
// byte layout) for host-assembled buffers like the dedup unique list, in
// place of a numpy loop over the bits.
// Sorted-wire post-pass (Config.sorted_dedup_wire): permute each table's
// first-seen-order unique segment into ASCENDING slot order and remap the
// table-local ranks through the permutation. In-place on both buffers.
// ranks: [t_count, n] int32, -1 = masked (unchanged). uniq_cat:
// concatenated per-table segments of lengths uniq_counts[t] (slots are
// distinct within a table, so the order is unique — bit-identical to the
// numpy stable-argsort fallback in host_cache.probe_dedup_raw). The numpy
// path is an argsort plus a [T,N] fancy-index remap; this is one linear
// remap pass plus U-element sorts.
void cdlrm_sort_dedup_wire(int32_t* ranks, int32_t* uniq_cat,
                           const int64_t* uniq_counts, int64_t t_count,
                           int64_t n) {
  std::vector<int64_t> base(t_count);
  int64_t acc = 0;
  for (int64_t t = 0; t < t_count; ++t) {
    base[t] = acc;
    acc += uniq_counts[t];
  }
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    const int64_t U = uniq_counts[t];
    int32_t* u = uniq_cat + base[t];
    std::vector<std::pair<int32_t, int32_t>> ps((size_t)U);
    for (int64_t j = 0; j < U; ++j)
      ps[(size_t)j] = {u[j], (int32_t)j};
    std::sort(ps.begin(), ps.end());
    std::vector<int32_t> remap((size_t)U);
    for (int64_t j = 0; j < U; ++j) {
      u[j] = ps[(size_t)j].first;
      remap[(size_t)ps[(size_t)j].second] = (int32_t)j;
    }
    int32_t* r = ranks + t * n;
    for (int64_t i = 0; i < n; ++i)
      if (r[i] >= 0) r[i] = remap[(size_t)r[i]];
  }
}

void cdlrm_pack_bits(const int64_t* vals, int64_t n, int64_t bits,
                     uint8_t* out) {
  const uint64_t sentinel = (1ull << bits) - 1ull;
  uint64_t acc = 0;
  int accbits = 0;
  uint8_t* p = out;
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t v = vals[i] < 0 ? sentinel : ((uint64_t)vals[i] & sentinel);
    acc |= v << accbits;
    accbits += (int)bits;
    while (accbits >= 8) {
      *p++ = (uint8_t)(acc & 0xFF);
      acc >>= 8;
      accbits -= 8;
    }
  }
  if (accbits) *p++ = (uint8_t)(acc & 0xFF);
}

// Bitstream batch probe, OpenMP-parallel over tables. out strides by
// bytes_per_table per table (caller computes wire_bytes(n, bits)).
void cdlrm_probe_batch_wirebits(const int32_t* const* occ_ptrs,
                                const int64_t* sets, int64_t ways,
                                int64_t t_count, const int64_t* idx, int64_t n,
                                const uint8_t* valid,
                                const int64_t* aux_bases_local, int64_t bits,
                                int64_t bytes_per_table, uint8_t* out,
                                int32_t* miss_pos, int64_t* miss_counts) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    miss_counts[t] = cdlrm_probe_table_wirebits(
        occ_ptrs[t], sets[t], ways, idx + t * n, n,
        valid ? valid + t * n : nullptr, aux_bases_local[t], bits,
        miss_pos + t * n, out + t * bytes_per_table);
  }
}

// Wire-format batch probe, OpenMP-parallel over tables.
void cdlrm_probe_batch_wire(const int32_t* const* occ_ptrs, const int64_t* sets,
                            int64_t ways, int64_t t_count, const int64_t* idx,
                            int64_t n, const uint8_t* valid,
                            const int64_t* aux_bases_local, uint8_t* wire,
                            int32_t* miss_pos, int64_t* miss_counts) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    miss_counts[t] = cdlrm_probe_table_wire(
        occ_ptrs[t], sets[t], ways, idx + t * n, n,
        valid ? valid + t * n : nullptr, aux_bases_local[t],
        miss_pos + t * n, wire + t * n * 3);
  }
}

// Batch probe: all tables in one call, OpenMP-parallel over tables.
//   occ_ptrs:  [t_count] pointers to each table's occupancy
//   sets:      [t_count] per-table set counts
//   idx:       [t_count * n] int64, table-major
//   valid:     [t_count * n] uint8 or nullptr
//   table_offsets/aux_bases: [t_count]
//   slots:     [t_count * n] int32 out
//   miss_pos:  [t_count * n] int32 out (per-table block t*n..)
//   miss_counts: [t_count] int64 out
void cdlrm_probe_batch(const int32_t* const* occ_ptrs, const int64_t* sets,
                       int64_t ways, int64_t t_count, const int64_t* idx,
                       int64_t n, const uint8_t* valid,
                       const int64_t* table_offsets, const int64_t* aux_bases,
                       int64_t trash_row, int32_t* slots, int32_t* miss_pos,
                       int64_t* miss_counts) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t t = 0; t < t_count; ++t) {
    miss_counts[t] = cdlrm_probe_table(
        occ_ptrs[t], sets[t], ways, idx + t * n, n,
        valid ? valid + t * n : nullptr, table_offsets[t], aux_bases[t],
        trash_row, slots + t * n, miss_pos + t * n);
  }
}

// ---------------------------------------------------------------------------
// 2. sorted unique (window dedup)
// ---------------------------------------------------------------------------

// Bitmap unique: O(n + n_rows/64). Wins when the id space is dense relative
// to the window (Criteo: 24.6M-index windows over <=40M-row tables).
static int64_t unique_bitmap(const int64_t* in, int64_t n, int64_t n_rows,
                             int64_t* out) {
  const int64_t words = (n_rows + 63) >> 6;
  uint64_t* bits = (uint64_t*)calloc((size_t)words, sizeof(uint64_t));
  if (!bits) return -1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t v = (uint64_t)in[i];
    // atomic OR: different threads may touch the same word
    __atomic_fetch_or(&bits[v >> 6], 1ULL << (v & 63), __ATOMIC_RELAXED);
  }
  int64_t m = 0;
  for (int64_t w = 0; w < words; ++w) {
    uint64_t x = bits[w];
    const int64_t base = w << 6;
    while (x) {
      const int b = __builtin_ctzll(x);
      out[m++] = base + b;
      x &= x - 1;
    }
  }
  free(bits);
  return m;
}

// LSD radix sort unique for sparse id spaces. Skips dead bytes.
static int64_t unique_radix(const int64_t* in, int64_t n, int64_t* out) {
  if (n == 0) return 0;
  std::vector<uint64_t> a((size_t)n), b((size_t)n);
  uint64_t maxv = 0;
  for (int64_t i = 0; i < n; ++i) {
    a[(size_t)i] = (uint64_t)in[i];
    if (a[(size_t)i] > maxv) maxv = a[(size_t)i];
  }
  uint64_t* src = a.data();
  uint64_t* dst = b.data();
  for (int shift = 0; shift < 64 && (maxv >> shift); shift += 8) {
    int64_t count[256] = {0};
    for (int64_t i = 0; i < n; ++i) ++count[(src[i] >> shift) & 0xFF];
    if (count[(src[0] >> shift) & 0xFF] == n) continue;  // dead byte
    int64_t pos[256];
    int64_t acc = 0;
    for (int v = 0; v < 256; ++v) {
      pos[v] = acc;
      acc += count[v];
    }
    for (int64_t i = 0; i < n; ++i) dst[pos[(src[i] >> shift) & 0xFF]++] = src[i];
    std::swap(src, dst);
  }
  int64_t m = 0;
  out[m++] = (int64_t)src[0];
  for (int64_t i = 1; i < n; ++i)
    if (src[i] != src[i - 1]) out[m++] = (int64_t)src[i];
  return m;
}

// Sorted unique of in[0..n) into out (caller-sized >= n). n_rows > 0 enables
// the bitmap strategy when dense enough. Returns the unique count.
int64_t cdlrm_unique_i64(const int64_t* in, int64_t n, int64_t n_rows,
                         int64_t* out) {
  if (n == 0) return 0;
  // bitmap wins when scanning n_rows/64 words is cheap next to the input:
  // words <= 2n covers every realistic cDLRM window (and allocs <= 16B/elem)
  if (n_rows > 0 && (n_rows >> 6) <= 2 * n) {
    int64_t m = unique_bitmap(in, n, n_rows, out);
    if (m >= 0) return m;
  }
  return unique_radix(in, n, out);
}

// ---------------------------------------------------------------------------
// 3. master-row gather / writeback
// ---------------------------------------------------------------------------

void cdlrm_gather_f32(const float* table, int64_t d, const int64_t* idx,
                      int64_t n, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i)
    memcpy(out + i * d, table + idx[i] * d, (size_t)d * sizeof(float));
}

// Writeback evicted rows (reference cache_manager.py:58-62). average=1
// halves with the resident row. Duplicate idx entries are caller-deduped.
void cdlrm_writeback_f32(float* table, int64_t d, const int64_t* idx,
                         int64_t n, const float* rows, int average) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float* dstrow = table + idx[i] * d;
    const float* srcrow = rows + i * d;
    if (average) {
      for (int64_t j = 0; j < d; ++j)
        dstrow[j] = 0.5f * (dstrow[j] + srcrow[j]);
    } else {
      memcpy(dstrow, srcrow, (size_t)d * sizeof(float));
    }
  }
}

// Fused unique + gather: one call per (window, table) in the prefetcher.
// out_idx sized >= n; out_rows sized >= n * d. Returns unique count.
int64_t cdlrm_unique_gather_f32(const int64_t* in, int64_t n, int64_t n_rows,
                                const float* table, int64_t d,
                                int64_t* out_idx, float* out_rows) {
  const int64_t m = cdlrm_unique_i64(in, n, n_rows, out_idx);
  cdlrm_gather_f32(table, d, out_idx, m, out_rows);
  return m;
}

// ---------------------------------------------------------------------------
// 4. block-coalesce union + rank rows (trainer._build_block_union)
// ---------------------------------------------------------------------------

// One-time helper: byte mask -> LSB-first uint64 bitmap (word w, bit b =
// mask[w*64 + b]; tail bits of the last word = 0). The trainer builds this
// once per run for the STATIC real-row mask, so the per-block union pass
// ANDs whole words instead of paying one random byte read per marked slot.
void cdlrm_mask_bits(const uint8_t* mask, int64_t n, uint64_t* bits_out) {
  const int64_t words = (n + 63) >> 6;
  for (int64_t w = 0; w < words; ++w) {
    uint64_t x = 0;
    const int64_t base = w << 6;
    const int64_t hi = (base + 64 <= n) ? 64 : n - base;
    for (int64_t b = 0; b < hi; ++b)
      x |= (uint64_t)(mask[base + b] != 0) << b;
    bits_out[w] = x;
  }
}

// Phase 1 of the block-coalesce host pass: mark the block's slots in a
// scratch bitmap, AND word-wise with the static real-row bitmap (aux/trash
// rows = 0; cdlrm_mask_bits), and emit the SORTED union, setting
// rank_map[slot] = rank for every union slot. rank_map MUST be all -1 on
// entry (the caller lazily resets it with cdlrm_block_union_reset —
// O(union) not O(n_rows)). Slots arrive int32 — the wire dtype — so the
// caller skips the int64 widening copy the first-generation ABI forced,
// and bounds are checked inline (no separate python-side min/max pass).
// Returns the union count, -1 on allocation failure (caller falls back to
// numpy), -2 on an out-of-range slot (nothing written to union_out that
// the caller may read: the scan never runs).
int64_t cdlrm_block_union(const int32_t* uniq_cat, int64_t total_n,
                          const uint64_t* real_bits, int64_t n_rows,
                          int32_t* rank_map, int32_t* union_out) {
  const int64_t words = (n_rows + 63) >> 6;
  uint64_t* bits = (uint64_t*)calloc((size_t)words, sizeof(uint64_t));
  if (!bits) return -1;
  for (int64_t i = 0; i < total_n; ++i) {
    const uint32_t v = (uint32_t)uniq_cat[i];  // negatives wrap high: caught
    if ((uint64_t)v >= (uint64_t)n_rows) { free(bits); return -2; }
    bits[v >> 6] |= 1ULL << (v & 63);
  }
  int64_t m = 0;
  for (int64_t w = 0; w < words; ++w) {
    uint64_t x = bits[w] & real_bits[w];
    const int64_t base = w << 6;
    while (x) {
      const int b = __builtin_ctzll(x);
      const int32_t slot = (int32_t)(base + b);
      union_out[m] = slot;
      rank_map[slot] = (int32_t)m;
      ++m;
      x &= x - 1;
    }
  }
  free(bits);
  return m;
}

// Phase 2: per-step rank rows, aligned with the staged uniq wire, written
// DIRECTLY into the caller's destination — row s starts at
// rows_out + s*row_stride (int32 elements; inner dim contiguous), so the
// trainer hands a strided view of its [n_steps, n_local, ub] staging array
// and skips the intermediate-array copy. Step s's positions
// [base, base+len_s) carry rank_map[u] (p_trash when the slot is not in
// the union — aux or trash), every other position p_trash. step_off is
// [n_steps + 1]. Returns 0; -1 WITHOUT writing anything when any step's
// list exceeds ub - base — the numpy fallback fails loudly there
// (shape-mismatch assignment), and silent out-of-row writes would corrupt
// the heap; -2 on an out-of-range slot (rows may be partially written —
// the caller raises and discards the block either way).
int64_t cdlrm_block_ranks(const int32_t* uniq_cat, const int64_t* step_off,
                          int64_t n_steps, const int32_t* rank_map,
                          int64_t n_rows, int32_t p_trash, int64_t ub,
                          int64_t base, int64_t row_stride,
                          int32_t* rows_out) {
  for (int64_t s = 0; s < n_steps; ++s)
    if (step_off[s + 1] - step_off[s] > ub - base) return -1;
  int bad = 0;  // benign write race: any thread only ever sets it to 1
#pragma omp parallel for schedule(static)
  for (int64_t s = 0; s < n_steps; ++s) {
    int32_t* row = rows_out + s * row_stride;
    for (int64_t j = 0; j < ub; ++j) row[j] = p_trash;
    const int64_t lo = step_off[s], hi = step_off[s + 1];
    for (int64_t j = lo; j < hi; ++j) {
      const uint32_t v = (uint32_t)uniq_cat[j];
      if ((uint64_t)v >= (uint64_t)n_rows) { bad = 1; break; }
      const int32_t r = rank_map[v];
      row[base + (j - lo)] = r < 0 ? p_trash : r;
    }
  }
  return bad ? -2 : 0;
}

// Lazy rank-map reset: only the union's entries were touched.
void cdlrm_block_union_reset(const int32_t* union_slots, int64_t m,
                             int32_t* rank_map) {
  for (int64_t i = 0; i < m; ++i) rank_map[union_slots[i]] = -1;
}

// ---------------------------------------------------------------------------
// 5. window probe statistics (cache/prefetcher.py _window_stats)
// ---------------------------------------------------------------------------

// Probe statistics of one window entry against the CURRENT residency, for
// each of ndev replica slices: slice r is columns [r*slice_n, (r+1)*slice_n)
// of idx, clipped to n. out[r*4 + k] (HostCacheController.count_probe_stats
// and count_misses, cache/host_cache.py):
//   k=0 misses: valid lookups whose id is not resident;
//   k=1 uniques (want_uniq, else 0): per table, distinct RESIDENT ids plus
//       every missing occurrence (each miss takes its own aux slot);
//   k=2 cold (has_hot, else 0): valid lookups whose resolved slot is not in
//       the SORTED hot set hot[0..n_hot); misses always count;
//   k=3 valid lookups.
// Residency is the flat id->row map when map_flat is non-null (table t's
// ids must lie in [0, end_t - id_bases[t]), end_t the next table's base or
// map_len), else the set-associative occupancy walk (numpy semantics: the
// id truncated to int32, set = floor-mod, first matching way). Masked lanes
// are skipped before their id is read. Single-threaded: the caller's pool
// runs one call per entry beside the assembly thread's OpenMP probes.
// Returns 0; t + 1 for the first (slice, table) whose unmasked lanes hold an
// id outside its map segment (out is then incomplete); -1 on an allocation
// failure.
int64_t cdlrm_count_probe_stats(
    const int32_t* map_flat, const int64_t* id_bases, int64_t map_len,
    const int32_t* const* occ_ptrs, const int64_t* sets, int64_t ways,
    const int64_t* table_offsets, int64_t t_count, const int64_t* idx,
    int64_t n, const uint8_t* valid, int64_t ndev, int64_t slice_n,
    int64_t want_uniq, int64_t has_hot, const int64_t* hot, int64_t n_hot,
    int64_t* out) {
  // distinct resident ids: open addressing over a power-of-two table at
  // least twice the slice, emptied between tables by a generation stamp
  int64_t cap = 16;
  while (cap < 2 * slice_n) cap <<= 1;
  int shift = 64;
  for (int64_t c = cap; c > 1; c >>= 1) --shift;
  int64_t* keys = nullptr;
  uint32_t* stamp = nullptr;
  if (want_uniq) {
    keys = (int64_t*)malloc((size_t)cap * sizeof(int64_t));
    stamp = (uint32_t*)calloc((size_t)cap, sizeof(uint32_t));
    if (!keys || !stamp) {
      free(keys);
      free(stamp);
      return -1;
    }
  }
  uint32_t gen = 0;
  int64_t rc = 0;
  const int64_t PF = 16;
  for (int64_t r = 0; r < ndev && rc == 0; ++r) {
    const int64_t lo = std::min(r * slice_n, n);
    const int64_t hi = std::min(lo + slice_n, n);
    int64_t miss = 0, uniq = 0, cold = 0, nvalid = 0;
    for (int64_t t = 0; t < t_count; ++t) {
      const int64_t* ids = idx + t * n;
      const uint8_t* v = valid ? valid + t * n : nullptr;
      int64_t base = 0, size = 0, sets_t = 0, offset = 0;
      const int32_t* occ = nullptr;
      if (map_flat) {
        base = id_bases[t];
        size = (t + 1 < t_count ? id_bases[t + 1] : map_len) - base;
      } else {
        occ = occ_ptrs[t];
        sets_t = sets[t];
        offset = table_offsets[t];
      }
      const int32_t sets32 = (int32_t)sets_t;
      ++gen;
      int64_t t_valid = 0, t_miss = 0, t_distinct = 0, t_hot = 0;
      for (int64_t i = lo; i < hi; ++i) {
        if (i + PF < hi && (!v || v[i + PF])) {
          const int64_t p = ids[i + PF];
          if (map_flat) {
            if (p >= 0 && p < size) __builtin_prefetch(map_flat + base + p, 0, 1);
          } else {
            int32_t s = (int32_t)p % sets32;
            if (s < 0) s += sets32;
            __builtin_prefetch(occ + (int64_t)s * ways, 0, 1);
          }
        }
        if (v && !v[i]) continue;
        const int64_t id = ids[i];
        ++t_valid;
        int64_t slot = -1;
        if (map_flat) {
          if (id < 0 || id >= size) {
            rc = t + 1;
            break;
          }
          slot = map_flat[base + id];
        } else {
          const int32_t w32 = (int32_t)id;
          int32_t s = w32 % sets32;
          if (s < 0) s += sets32;
          const int32_t* row = occ + (int64_t)s * ways;
          for (int64_t k = 0; k < ways; ++k) {
            if (row[k] == w32) {
              slot = offset + k * sets_t + s;
              break;
            }
          }
        }
        if (slot < 0) {
          ++t_miss;
          continue;
        }
        if (want_uniq) {
          uint64_t h = ((uint64_t)id * 0x9E3779B97F4A7C15ULL) >> shift;
          while (stamp[h] == gen && keys[h] != id) h = (h + 1) & (cap - 1);
          if (stamp[h] != gen) {
            stamp[h] = gen;
            keys[h] = id;
            ++t_distinct;
          }
        }
        if (has_hot && n_hot > 0 && std::binary_search(hot, hot + n_hot, slot))
          ++t_hot;
      }
      if (rc) break;
      miss += t_miss;
      nvalid += t_valid;
      if (want_uniq) uniq += t_distinct + t_miss;
      if (has_hot) cold += t_valid - t_hot;
    }
    out[r * 4 + 0] = miss;
    out[r * 4 + 1] = uniq;
    out[r * 4 + 2] = cold;
    out[r * 4 + 3] = nvalid;
  }
  free(keys);
  free(stamp);
  return rc;
}

}  // extern "C"
