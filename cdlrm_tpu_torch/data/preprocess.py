"""Offline Criteo preprocessing: raw TSV -> per-day npz artifacts.

Re-implementation of the reference pipeline (C18, data_utils.py)
producing the same artifact family with the same filenames, so datasets
prepared by either implementation interoperate:

  <prefix>_day_count.npz      total_per_file: samples per day
  <prefix>_day_<i>.npz        parsed day: X_int i32 [N,13], X_cat_t i32 [26,N], y i32
  <prefix>_fea_dict_<j>.npz   unique raw values of categorical column j
  <prefix>_fea_count.npz      counts: table sizes per categorical column
  <prefix>_day_<i>_processed.npz  remapped X_cat [N,26], clamped X_int, y
  <prefix>_day_<i>_reordered.npz  FYR-shuffled day files
  <o_filename>.npz            single concatenated file (non-memory-map mode)

Raw format (reference data_utils.py:996-1006): one sample per line,
tab-separated: target, 13 ints (dense), 26 hex strings (categorical); empty
fields mean 0. Kaggle ships one train.txt (split into 7 synthetic days,
data_utils.py:926-942); Terabyte ships day_0..day_23.

Documented intent-preserving deviations (model-equivalent bijections /
unbiased versions of reference quirks):
- categorical id assignment is sorted-unique order (np.unique + searchsorted)
  rather than first-occurrence insertion order (data_utils.py:1076-1092) —
  any bijection is equivalent; table sizes (counts) are identical.
- the FYR first pass assigns each record's target day by a multivariate
  hypergeometric draw over remaining bucket capacities — the unbiased
  vectorized form of the reference's uniform-day-with-retry rejection loop
  (data_utils.py:608-622), which slightly over-weights small days.
- parsing is chunk-vectorized instead of per-line Python (same output).
"""

from __future__ import annotations

import argparse
import os
from os import path
from typing import List, Optional, Sequence

import numpy as np

DEN_FEA = 13
SPA_FEA = 26


# --------------------------------------------------------------------------
# parsing
# --------------------------------------------------------------------------


def _parse_lines(lines: List[str], max_ind_range: int):
    """Parse raw TSV lines -> (y, X_int, X_cat) int32 arrays."""
    n = len(lines)
    y = np.zeros(n, dtype=np.int32)
    x_int = np.zeros((n, DEN_FEA), dtype=np.int32)
    x_cat = np.zeros((n, SPA_FEA), dtype=np.int32)
    for i, line in enumerate(lines):
        f = line.rstrip("\n").split("\t")
        # pad missing trailing fields; empty fields mean zero
        if len(f) < 1 + DEN_FEA + SPA_FEA:
            f = f + [""] * (1 + DEN_FEA + SPA_FEA - len(f))
        y[i] = int(f[0]) if f[0] else 0
        for j in range(DEN_FEA):
            v = f[1 + j]
            x_int[i, j] = int(v) if v else 0
        for j in range(SPA_FEA):
            v = f[1 + DEN_FEA + j]
            h = int(v, 16) if v else 0
            if max_ind_range > 0:
                h %= max_ind_range
            x_cat[i, j] = h
    return y, x_int, x_cat


def parse_day_file(
    datfile: str,
    out_npz: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    rng: Optional[np.random.Generator] = None,
    chunk_lines: int = 1_000_000,
) -> int:
    """Parse one raw day file into <out_npz> (keys X_int, X_cat_t, y),
    dropping negative samples with probability sub_sample_rate
    (reference data_utils.py:966-1067). Returns the number of kept samples."""
    rng = rng or np.random.default_rng(123)
    ys, xis, xcs = [], [], []
    with open(datfile) as f:
        while True:
            lines = f.readlines(chunk_lines * 64)
            if not lines:
                break
            y, x_int, x_cat = _parse_lines(lines, max_ind_range)
            if sub_sample_rate > 0.0:
                drop = (y == 0) & (rng.random(y.size) < sub_sample_rate)
                keep = ~drop
                y, x_int, x_cat = y[keep], x_int[keep], x_cat[keep]
            ys.append(y)
            xis.append(x_int)
            xcs.append(x_cat)
    y = np.concatenate(ys) if ys else np.zeros(0, np.int32)
    x_int = np.concatenate(xis) if xis else np.zeros((0, DEN_FEA), np.int32)
    x_cat = np.concatenate(xcs) if xcs else np.zeros((0, SPA_FEA), np.int32)
    np.savez_compressed(out_npz, X_int=x_int, X_cat_t=x_cat.T, y=y)
    return int(y.size)


def split_kaggle_train_file(datafile: str, npzfile_prefix: str, days: int) -> List[int]:
    """Split Kaggle's single train.txt into ``days`` synthetic day files
    (reference data_utils.py:917-942): near-equal line counts, extras to the
    first days."""
    total = 0
    with open(datafile) as f:
        for _ in f:
            total += 1
    per_file, extras = divmod(total, days)
    total_per_file = [per_file + (1 if j < extras else 0) for j in range(days)]
    with open(datafile) as f:
        for i in range(days):
            with open(f"{npzfile_prefix}_{i}", "w") as nf:
                for _ in range(total_per_file[i]):
                    nf.write(f.readline())
    return total_per_file


# --------------------------------------------------------------------------
# dictionaries + remap
# --------------------------------------------------------------------------


def build_dictionaries(npzfile_prefix: str, days: int, d_prefix: str) -> np.ndarray:
    """Global per-column categorical dictionaries over all days; writes
    <d_prefix>_fea_dict_<j>.npz and <d_prefix>_fea_count.npz. Returns counts."""
    uniques = [np.zeros(0, dtype=np.int32) for _ in range(SPA_FEA)]
    for i in range(days):
        with np.load(f"{npzfile_prefix}_{i}.npz") as data:
            x_cat_t = data["X_cat_t"]
        for j in range(SPA_FEA):
            uniques[j] = np.union1d(uniques[j], x_cat_t[j])
    counts = np.zeros(SPA_FEA, dtype=np.int32)
    for j in range(SPA_FEA):
        counts[j] = uniques[j].size
        np.savez_compressed(f"{d_prefix}_fea_dict_{j}.npz", unique=uniques[j])
    np.savez_compressed(f"{d_prefix}_fea_count.npz", counts=counts)
    return counts


def process_days(npzfile_prefix: str, days: int, d_prefix: str) -> None:
    """Remap raw categorical values to dense ids via the global dictionaries
    and clamp negative dense features to 0 (reference data_utils.py:111-169);
    writes <prefix>_<i>_processed.npz (keys X_int, X_cat, y)."""
    dicts = []
    for j in range(SPA_FEA):
        with np.load(f"{d_prefix}_fea_dict_{j}.npz") as data:
            dicts.append(data["unique"])
    for i in range(days):
        out = f"{npzfile_prefix}_{i}_processed.npz"
        if path.exists(out):
            continue
        with np.load(f"{npzfile_prefix}_{i}.npz") as data:
            x_cat_t = data["X_cat_t"]
            x_int = data["X_int"].copy()
            y = data["y"]
        x_cat = np.zeros(x_cat_t.T.shape, dtype=np.int32)
        for j in range(SPA_FEA):
            x_cat[:, j] = np.searchsorted(dicts[j], x_cat_t[j])
        x_int[x_int < 0] = 0
        np.savez_compressed(out, X_int=x_int, X_cat=x_cat, y=y)


# --------------------------------------------------------------------------
# Fisher-Yates-Rao out-of-core shuffle
# --------------------------------------------------------------------------


def fyr_shuffle(
    npzfile_prefix: str,
    days: int,
    total_per_file: Sequence[int],
    data_split: str = "train",
    randomize: str = "total",
    seed: int = 123,
) -> None:
    """Two-pass out-of-core shuffle across day files
    (reference data_utils.py:555-702); writes <prefix>_<i>_reordered.npz.

    Pass 1 scatters each day's records into intermediate per-target-day
    buckets (capacity = that day's size); pass 2 permutes within each bucket.
    With data_split != 'none' the last day is preserved in place (it holds
    the test/val split). randomize: 'total' shuffles across days, 'day'
    shuffles within days only, 'none' copies through."""
    rng = np.random.default_rng(seed)
    total_per_file = list(total_per_file)
    days_to_sample = days if data_split == "none" else days - 1

    inter = {}
    for j in range(days):
        inter[j] = {
            "y": np.lib.format.open_memmap(
                f"{npzfile_prefix}_{j}_intermediate_y.npy", mode="w+",
                dtype=np.int32, shape=(total_per_file[j],),
            ),
            "d": np.lib.format.open_memmap(
                f"{npzfile_prefix}_{j}_intermediate_d.npy", mode="w+",
                dtype=np.int32, shape=(total_per_file[j], DEN_FEA),
            ),
            "s": np.lib.format.open_memmap(
                f"{npzfile_prefix}_{j}_intermediate_s.npy", mode="w+",
                dtype=np.int32, shape=(total_per_file[j], SPA_FEA),
            ),
        }

    fill = [0] * days
    remaining = np.array(total_per_file[:days_to_sample], dtype=np.int64)
    for i in range(days):
        with np.load(f"{npzfile_prefix}_{i}_processed.npz") as data:
            x_cat, x_int, y = data["X_cat"], data["X_int"], data["y"]
        size = len(y)
        if size != total_per_file[i]:
            raise ValueError(f"day {i}: expected {total_per_file[i]} samples, got {size}")
        if randomize == "total" and (data_split == "none" or i < days - 1):
            # unbiased target-day assignment: draw per-day counts from the
            # remaining capacities, then scatter a random permutation
            counts = rng.multivariate_hypergeometric(remaining, size)
            remaining -= counts
            perm = rng.permutation(size)
            start = 0
            for j in range(days_to_sample):
                sel = perm[start : start + counts[j]]
                start += counts[j]
                s, e = fill[j], fill[j] + counts[j]
                inter[j]["y"][s:e] = y[sel]
                inter[j]["d"][s:e] = x_int[sel]
                inter[j]["s"][s:e] = x_cat[sel]
                fill[j] += counts[j]
        else:  # keep records in their own day (randomize day/none, last day)
            s, e = fill[i], fill[i] + size
            inter[i]["y"][s:e] = y
            inter[i]["d"][s:e] = x_int
            inter[i]["s"][s:e] = x_cat
            fill[i] += size

    # pass 2: permute within buckets
    for j in range(days):
        y = np.asarray(inter[j]["y"])
        d = np.asarray(inter[j]["d"])
        s = np.asarray(inter[j]["s"])
        if randomize in ("day", "total") and (data_split == "none" or j < days - 1):
            idx = rng.permutation(total_per_file[j])
        else:
            idx = np.arange(total_per_file[j])
        np.savez_compressed(
            f"{npzfile_prefix}_{j}_reordered.npz",
            X_cat=s[idx], X_int=d[idx], y=y[idx],
        )
    for j in range(days):
        for k in ("y", "d", "s"):
            del inter[j][k]
        for suffix in ("y", "d", "s"):
            try:
                os.remove(f"{npzfile_prefix}_{j}_intermediate_{suffix}.npy")
            except OSError:
                pass


def concat_days(npzfile_prefix: str, days: int, d_prefix: str, o_file: str) -> str:
    """Non-memory-map mode: concatenate all processed days into one npz with
    counts (reference data_utils.py:724-753)."""
    xs, ds, ys = [], [], []
    for i in range(days):
        with np.load(f"{npzfile_prefix}_{i}_processed.npz") as data:
            xs.append(data["X_cat"])
            ds.append(data["X_int"])
            ys.append(data["y"])
    with np.load(f"{d_prefix}_fea_count.npz") as data:
        counts = data["counts"]
    np.savez_compressed(
        o_file,
        X_cat=np.concatenate(xs),
        X_int=np.concatenate(ds),
        y=np.concatenate(ys),
        counts=counts,
    )
    return o_file


# --------------------------------------------------------------------------
# top-level entry point (reference getCriteoAdData, data_utils.py:876-1211)
# --------------------------------------------------------------------------


def get_criteo_ad_data(
    datafile: str,
    o_filename: str,
    max_ind_range: int = -1,
    sub_sample_rate: float = 0.0,
    days: int = 7,
    data_split: str = "train",
    randomize: str = "total",
    criteo_kaggle: bool = True,
    memory_map: bool = False,
    seed: int = 123,
) -> str:
    """Full offline pipeline. Returns the processed-npz path (non-mmap mode)
    or the day-file prefix (mmap mode, files <prefix>_<i>_reordered.npz)."""
    lstr = datafile.split("/")
    d_path = "/".join(lstr[0:-1]) + "/"
    d_file = lstr[-1].split(".")[0] if criteo_kaggle else lstr[-1]
    npzfile = d_path + ((d_file + "_day") if criteo_kaggle else d_file)
    d_prefix = d_path + d_file

    rng = np.random.default_rng(seed)

    total_file = d_prefix + "_day_count.npz"
    if path.exists(total_file):
        with np.load(total_file) as data:
            total_per_file = list(data["total_per_file"])
    else:
        if criteo_kaggle:
            if not path.exists(datafile):
                raise FileNotFoundError(f"Kaggle raw file not found: {datafile}")
            split_kaggle_train_file(datafile, npzfile, days)

        total_per_file = []
        for i in range(days):
            raw_i = f"{npzfile}_{i}" if criteo_kaggle else f"{datafile}_{i}"
            out_i = f"{npzfile}_{i}.npz"
            if path.exists(out_i):
                with np.load(out_i) as data:
                    total_per_file.append(int(data["y"].size))
            else:
                total_per_file.append(
                    parse_day_file(raw_i, out_i, max_ind_range, sub_sample_rate, rng)
                )
        np.savez_compressed(total_file, total_per_file=total_per_file)

    if not path.exists(d_prefix + "_fea_count.npz"):
        build_dictionaries(npzfile, days, d_prefix)
    process_days(npzfile, days, d_prefix)

    if memory_map:
        if not all(
            path.exists(f"{npzfile}_{j}_reordered.npz") for j in range(days)
        ):
            fyr_shuffle(npzfile, days, total_per_file, data_split, randomize, seed)
        return npzfile
    out = d_path + o_filename + ".npz"
    if not path.exists(out):
        concat_days(npzfile, days, d_prefix, out)
    return out


def main(argv=None):
    """Standalone preprocessing CLI (reference data_utils.py:1184-1211)."""
    p = argparse.ArgumentParser(description="Preprocess Criteo raw data")
    p.add_argument("--raw-data-file", required=True)
    p.add_argument("--output-name", default="criteo_processed")
    p.add_argument("--data-set", choices=["kaggle", "terabyte"], default="kaggle")
    p.add_argument("--max-ind-range", type=int, default=-1)
    p.add_argument("--data-sub-sample-rate", type=float, default=0.0)
    p.add_argument("--data-randomize", default="total")
    p.add_argument("--memory-map", action="store_true")
    args = p.parse_args(argv)
    out = get_criteo_ad_data(
        args.raw_data_file,
        args.output_name,
        max_ind_range=args.max_ind_range,
        sub_sample_rate=args.data_sub_sample_rate,
        days=7 if args.data_set == "kaggle" else 24,
        randomize=args.data_randomize,
        criteo_kaggle=args.data_set == "kaggle",
        memory_map=args.memory_map,
    )
    print("Wrote", out)


if __name__ == "__main__":
    main()
