"""cdlrm_tpu_torch's host layer against cdlrm_tpu's on the same inputs.

The port keeps its own copy of the host layer (config, data with the Criteo
preprocessing and loaders, cache geometry, probes, insert plans, masters, the accumulator store, the prefetcher, the
native C++ kernels) and imports nothing of cdlrm_tpu, so nothing but these
tests holds the two copies to the same bytes: every comparison here is exact
equality of arrays, dtypes included. Inputs are small and come from numpy
generators with fixed seeds."""

import dataclasses
import importlib

import numpy as np
import pytest

from cdlrm_tpu.cache import geometry as jgeometry
from cdlrm_tpu.cache import host_cache as jhost
from cdlrm_tpu.cache import master as jmaster
from cdlrm_tpu.cache import prefetcher as jprefetcher
from cdlrm_tpu.data import criteo as jcriteo
from cdlrm_tpu.data import preprocess as jpreprocess
from cdlrm_tpu.data import synthetic as jsynthetic
from cdlrm_tpu.ops import native as jnative
from cdlrm_tpu.parallel import multihost as jmultihost
from cdlrm_tpu.utils import metrics as jmetrics
from cdlrm_tpu.utils import padding as jpadding
from cdlrm_tpu.utils import primes as jprimes
from cdlrm_tpu_torch.cache import geometry as pgeometry
from cdlrm_tpu_torch.cache import host_cache as phost
from cdlrm_tpu_torch.cache import master as pmaster
from cdlrm_tpu_torch.cache import prefetcher as pprefetcher
from cdlrm_tpu_torch.data import criteo as pcriteo
from cdlrm_tpu_torch.data import preprocess as ppreprocess
from cdlrm_tpu_torch.data import synthetic as psynthetic
from cdlrm_tpu_torch.ops import native as pnative
from cdlrm_tpu_torch.parallel import multihost as pmultihost
from cdlrm_tpu_torch.utils import metrics as pmetrics
from cdlrm_tpu_torch.utils import padding as ppadding
from cdlrm_tpu_torch.utils import primes as pprimes

LN_EMB = np.array([300, 1200, 2000, 40])
DIM, SETS, WAYS, AUX = 16, 64, 4, 96
# (host_cache, geometry, master, native) of each package
JAX = (jhost, jgeometry, jmaster, jnative)
PORT = (phost, pgeometry, pmaster, pnative)


def same(a, b, what=""):
    """Exact equality of two values of the host layer: arrays with their
    dtypes and shapes, dataclasses field by field, sequences item by item."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        names = [f.name for f in dataclasses.fields(a)]
        assert names == [f.name for f in dataclasses.fields(b)], what
        for name in names:
            same(getattr(a, name), getattr(b, name), f"{what}.{name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for key in a:
            same(a[key], b[key], f"{what}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{what}[{i}]")
    else:
        assert a == b, (what, a, b)


# ------------------------------------------------------------------- config

# the config helpers of the other port tests: (module, function, arguments
# after ``port``)
CONFIGS = [
    ("test_torch_trainer", "_cfg", {}),
    ("test_torch_trainer", "_cfg", {"inference_only": True, "compute_dtype": "bfloat16"}),
    ("test_torch_train_step", "_cfg", {}),
    ("test_torch_train_step", "_cfg", {"dedup_lookups": "on"}),
    ("test_torch_train_trainer", "_cfg", {}),
    ("test_torch_train_trainer", "_cfg", {"dedup_lookups": "off", "refill_prestage": False}),
    ("test_torch_scan_trainer", "_cfg", {}),
    ("test_torch_scan_trainer", "_cfg", {"dedup_lookups": "on", "block_coalesced_update": "off"}),
    ("test_torch_block_step", "_cfg", {}),
    ("test_torch_fulltable", "_cfg", {}),
    ("test_torch_fulltable", "_cfg", {"pooled": 3, "optimizer": "adagrad"}),
    ("test_torch_adagrad", "_step_cfg", {}),
    ("test_torch_adagrad", "_traj_cfg", {"scan_steps": 3, "pack_wire": False}),
    ("test_torch_adagrad", "_cycle_cfg", {"master": True}),
    ("test_torch_checkpoint", "_fulltable_cfg", {"opt": "adagrad", "checkpoint_freq": 4}),
    ("test_torch_wires", "_cfg", {"wire_x_fp8": True, "wire_rows_bf16": True}),
    ("test_torch_md_cached", "_cfg", {"ln_emb": [500, 200, 1000], "master_init": "virtual"}),
    ("test_torch_tricks", "_cfg", {"qr_flag": True, "qr_threshold": 300}),
    ("test_torch_tricks", "_cfg", {"pooled": 3, "md_flag": True, "md_threshold": 300}),
]


@pytest.mark.parametrize("module,fn,kw", CONFIGS,
                         ids=[f"{m[11:]}.{f}{i}" for i, (m, f, _) in enumerate(CONFIGS)])
def test_finalized_config_fields_equal(module, fn, kw):
    """One set of keyword arguments finalizes to the same fields in either
    package's Config: what the trajectory tests hand their two trainers."""
    make = getattr(importlib.import_module(module), fn)
    jcfg, pcfg = make(False, **kw), make(True, **kw)
    assert type(jcfg).__module__ == "cdlrm_tpu.config"
    assert type(pcfg).__module__ == "cdlrm_tpu_torch.config"
    same(pcfg, jcfg, "cfg")
    for prop in ("m_spa", "local_batch_size", "loss_weights_list", "cache_sets"):
        assert getattr(pcfg, prop) == getattr(jcfg, prop), prop


def test_config_flags_and_errors_equal():
    """The two argument parsers take the same flags with the same defaults,
    and finalize refuses the same combinations with the same words."""
    from cdlrm_tpu import config as jconfig
    from cdlrm_tpu_torch import config as pconfig

    def flags(mod):
        return sorted((a.dest, a.default, tuple(a.option_strings), a.type)
                      for a in mod.build_arg_parser()._actions if a.dest != "help")

    assert flags(pconfig) == flags(jconfig)
    argv = ["--arch-embedding-size", "100-200", "--arch-sparse-feature-size", "2",
            "--no-pack-wire", "--scan-steps", "4", "--dedup-lookups", "on"]
    same(pconfig.config_from_args(argv).finalize(), jconfig.config_from_args(argv).finalize())
    for kw in (dict(optimizer="rmsprop"), dict(optimizer="adagrad"),
               dict(block_coalesced_update="on"), dict(refill_broadcast="sometimes"),
               dict(arch_sparse_feature_size=3), dict(adagrad_master_state=True),
               dict(sorted_dedup_wire=True)):
        errs = []
        for mod in (jconfig, pconfig):
            with pytest.raises(ValueError) as info:
                mod.Config(**kw).finalize()
            errs.append(str(info.value))
        assert errs[0] == errs[1], kw


# -------------------------------------------------------------------- utils


def test_utils_equal():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 4, 9, 64, 1000, 10240, 16384):
        assert pprimes.next_prime(n) == jprimes.next_prime(n)
        assert pprimes.is_prime(n) == jprimes.is_prime(n)
    for n, min_size, factor in ((0, 8, 2), (8, 8, 2), (9, 8, 2), (1000, 8, 2), (70, 64, 4)):
        assert ppadding.pow2_bucket(n, min_size, factor) == jpadding.pow2_bucket(n, min_size, factor)
    for shape in ((5,), (9, 3), (64, 2)):
        a = rng.integers(0, 100, shape).astype(np.int32)
        same(ppadding.pad_to_bucket(a, 7), jpadding.pad_to_bucket(a, 7))
    scores = rng.random((500, 1)).astype(np.float32)
    targets = (rng.random((500, 1)) < 0.3).astype(np.float32)
    assert pmetrics.accuracy_count(scores, targets) == jmetrics.accuracy_count(scores, targets)
    assert pmetrics.roc_auc(scores, targets) == jmetrics.roc_auc(scores, targets)
    pa, ja = pmetrics.StreamingAUC(), jmetrics.StreamingAUC()
    for lo in range(0, 500, 100):
        pa.update(scores[lo: lo + 100], targets[lo: lo + 100])
        ja.update(scores[lo: lo + 100], targets[lo: lo + 100])
    assert pa.result() == ja.result()


# --------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [
    dict(),
    dict(round_targets=True, num_indices_per_lookup=1, num_indices_per_lookup_fixed=True),
    dict(num_indices_per_lookup=3, num_indices_per_lookup_fixed=True),
    dict(num_indices_per_lookup=4, round_targets=True),
    dict(num_batches=3),
], ids=["default", "single", "pooled3", "pooled-var", "num-batches"])
def test_synthetic_batches_equal(kw):
    args = dict(m_den=13, ln_emb=LN_EMB, data_size=64 * 4 + 10, mini_batch_size=64, seed=5, **kw)
    jds, pds = jsynthetic.SyntheticDataset(**args), psynthetic.SyntheticDataset(**args)
    assert len(pds) == len(jds)
    jb, pb = list(jds.batches()), list(pds.batches())
    assert len(pb) == len(jb) > 0
    for p, j in zip(pb, jb):
        assert type(p).__module__ == "cdlrm_tpu_torch.data.synthetic"
        assert p._fields == j._fields
        same(tuple(p), tuple(j), "batch")
    # a second pass replays the same stream
    same(tuple(next(iter(pds.batches()))), tuple(pb[0]))


# ------------------------------------------------------------------- Criteo

CRITEO_DAYS, CRITEO_LINES = 3, 120


def _write_raw_criteo(path, seed=0):
    """A raw Criteo-format TSV (target, 13 ints, 26 hex categories) with some
    fields missing, as tests/test_data_criteo.py fabricates it."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(CRITEO_LINES):
            target = int(rng.random() < 0.3)
            dense = [str(int(v)) for v in rng.integers(-2, 100, 13)]
            cats = [format(int(v), "x") for v in rng.integers(0, 5000, 26)]
            if i % 7 == 0:
                dense[3], cats[5] = "", ""
            f.write("\t".join([str(target)] + dense + cats) + "\n")


@pytest.fixture(scope="module")
def criteo_dirs(tmp_path_factory):
    """The same raw file preprocessed by each package into a directory of its
    own: day files, the concatenated npz, and the train and test binaries."""
    dirs = {}
    for name, pre, crit in (("jax", jpreprocess, jcriteo), ("port", ppreprocess, pcriteo)):
        d = tmp_path_factory.mktemp(f"criteo_{name}")
        raw = str(d / "train.txt")
        _write_raw_criteo(raw)
        prefix = pre.get_criteo_ad_data(raw, "kaggle_processed", days=CRITEO_DAYS,
                                        criteo_kaggle=True, memory_map=True)
        pro = pre.get_criteo_ad_data(raw, "kaggle_processed", days=CRITEO_DAYS,
                                     criteo_kaggle=True, memory_map=False)
        days = [f"{prefix}_{i}_reordered.npz" for i in range(CRITEO_DAYS)]
        crit.numpy_to_binary(days[:-1], str(d / "train_data.bin"), split="train")
        crit.numpy_to_binary(days[-1:], str(d / "test_data.bin"), split="test")
        dirs[name] = dict(dir=d, raw=raw, prefix=prefix, pro=pro,
                          counts=str(d / "train_fea_count.npz"),
                          day_count=str(d / "train_day_count.npz"))
    return dirs


def test_criteo_preprocessed_files_equal(criteo_dirs):
    """Both packages write the same files from one raw file: every array of
    every npz, and the binaries byte for byte."""
    import os

    jd, pd = criteo_dirs["jax"]["dir"], criteo_dirs["port"]["dir"]
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(pd))
    assert any(n.endswith("_reordered.npz") for n in names) and "train_data.bin" in names
    for name in names:
        if name.endswith(".npz"):
            same(_npz(pd / name), _npz(jd / name), name)
        else:
            assert (pd / name).read_bytes() == (jd / name).read_bytes(), name


def _criteo_loader(mod, files, kind):
    if kind.startswith("streaming"):
        return mod.CriteoStreamingDataset(
            files["prefix"], range(CRITEO_DAYS - 1), 32, split="train",
            max_ind_range=7 if kind == "streaming-modulo" else -1,
            num_workers=1 if kind == "streaming-worker" else 0)
    if kind == "streaming test half":
        return mod.CriteoStreamingDataset(files["prefix"], [CRITEO_DAYS - 1], 8, split="test")
    if kind == "in-memory":
        return mod.CriteoInMemoryDataset(files["pro"], 16, split="train",
                                         day_count_file=files["day_count"])
    train_bin = str(files["dir"] / "train_data.bin")
    if kind == "bin":
        return mod.CriteoBinDataset(train_bin, files["counts"], batch_size=16)
    if kind == "bin-shuffle-workers":
        return mod.CriteoBinDataset(train_bin, files["counts"], batch_size=12, shuffle=True,
                                    seed=5, num_workers=2)
    assert kind == "bin-host-rows", kind
    return mod.CriteoBinDataset(train_bin, files["counts"], batch_size=12, shuffle=True, seed=5,
                                host_rows=(3, 9))


@pytest.mark.parametrize("kind", ["streaming", "streaming-modulo", "streaming-worker",
                                  "streaming test half", "in-memory", "bin",
                                  "bin-shuffle-workers", "bin-host-rows"])
def test_criteo_loaders_equal(criteo_dirs, kind):
    """Every Criteo loader yields the same batches, the same index-only
    stream and the same table sizes in either package, each reading the files
    its own package wrote; so does a pass that skips its first batches."""
    jds = _criteo_loader(jcriteo, criteo_dirs["jax"], kind)
    pds = _criteo_loader(pcriteo, criteo_dirs["port"], kind)
    same(np.asarray(pds.ln_emb), np.asarray(jds.ln_emb), "ln_emb")
    assert pds.m_den == jds.m_den
    jb, pb = list(jds.batches()), list(pds.batches())
    assert len(pb) == len(jb) > 1
    for k, (p, j) in enumerate(zip(pb, jb)):
        assert type(p).__module__ == "cdlrm_tpu_torch.data.synthetic"
        same(tuple(p), tuple(j), f"batch {k}")
    same(list(pds.index_batches()), list(jds.index_batches()), "index stream")
    same([tuple(b) for b in pds.batches(skip=2)], [tuple(b) for b in jds.batches(skip=2)], "skip")
    if kind == "bin-host-rows":  # the slice really zeroed rows outside (3, 9)
        assert not pb[0].ls_i[:, :3].any() and pb[0].ls_i[:, 3:9].any()


@pytest.mark.parametrize("hosts,host,want", [(1, 0, None), (2, 0, (0, 16)), (2, 1, (16, 32))],
                         ids=["one-host", "host0of2", "host1of2"])
def test_make_criteo_datasets_host_slice_equal(criteo_dirs, monkeypatch, hosts, host, want):
    """``data_host_slice``: the port reads the cluster's shape from its config
    (``num_hosts``, ``host_id``) where cdlrm_tpu asks jax; both slice the train
    loader to the same rows, leave the test loader whole, finalize the config
    alike and stream the same batches."""
    import jax

    from cdlrm_tpu.config import Config as JConfig
    from cdlrm_tpu_torch.config import Config as PConfig

    def cfg(cls, files, **kw):
        return cls(arch_sparse_feature_size=8, arch_mlp_bot="13-8", arch_mlp_top="8-1",
                   mini_batch_size=32, world_size=4, cache_size=16, num_ways=2,
                   data_generation="dataset", data_set="kaggle", raw_data_file=files["raw"],
                   processed_data_file=str(files["dir"] / "x.npz"), mlperf_bin_loader=True,
                   data_host_slice=True, **kw)

    monkeypatch.setattr(jax, "process_count", lambda: hosts)
    monkeypatch.setattr(jax, "process_index", lambda: host)
    jtrain, jtest, jcfg = jcriteo.make_criteo_datasets(cfg(JConfig, criteo_dirs["jax"]))
    ptrain, ptest, pcfg = pcriteo.make_criteo_datasets(
        cfg(PConfig, criteo_dirs["port"], num_hosts=hosts, host_id=host))
    assert ptrain.host_rows == jtrain.host_rows == want
    assert ptest.host_rows is None and jtest.host_rows is None
    differ = ("raw_data_file", "processed_data_file", "num_hosts", "host_id")
    for f in dataclasses.fields(jcfg):  # finalized alike from the loaders' table sizes
        if f.name not in differ:
            same(getattr(pcfg, f.name), getattr(jcfg, f.name), f"cfg.{f.name}")
    assert len(pcfg.ln_emb) == 26 and pcfg.test_mini_batch_size == 32
    for pds, jds in ((ptrain, jtrain), (ptest, jtest)):
        same([tuple(b) for b in pds.batches()], [tuple(b) for b in jds.batches()], "batches")
    same(list(ptrain.index_batches()), list(jtrain.index_batches()), "index stream")


# ------------------------------------------------------------ cache geometry


@pytest.mark.parametrize("ln_emb,cache_size,ways,aux", [
    (LN_EMB, SETS, WAYS, AUX), ([250_000] * 26, 16_384, 8, 4096), ([5, 7], 10240, 4, 1)])
def test_cache_geometry_equal(ln_emb, cache_size, ways, aux):
    jg = jgeometry.CacheGeometry.build(ln_emb, DIM, cache_size, ways, aux)
    pg = pgeometry.CacheGeometry.build(ln_emb, DIM, cache_size, ways, aux)
    same(pg, jg, "geometry")
    assert pg.trash_row == jg.trash_row and pg.cache_bytes() == jg.cache_bytes()
    for t in range(len(ln_emb)):
        assert pg.aux_base(t) == jg.aux_base(t)
        same(pg.hit_slot(t, np.arange(ways), np.arange(ways)),
             jg.hit_slot(t, np.arange(ways), np.arange(ways)))


# ------------------------------------------------------------------- probes


def _warm_pair(slot_map: bool, seed=3):
    """The two packages' controllers and masters after the same warm-up
    insert, which leaves a mix of hits and misses for the probes."""
    out = []
    for host, geometry, master, _ in (JAX, PORT):
        geo = geometry.CacheGeometry.build(LN_EMB, DIM, SETS, WAYS, AUX)
        tables = master.MasterTables(LN_EMB, DIM, rng=np.random.default_rng(seed))
        ctl = host.HostCacheController(geo, seed=seed, ln_emb=LN_EMB, slot_map=slot_map)
        rng = np.random.default_rng(seed + 1)
        uniques = [np.unique(rng.integers(0, n, 150)) for n in LN_EMB]
        plan = ctl.plan_insert(uniques, tables.gather_all(uniques))
        out.append((ctl, tables, geo, plan))
    return out


def _lookups(rng, n=AUX, pooled=False):
    """[T, n] ids, half of them from a narrow range so that slots repeat, and
    a validity mask (None for single-index batches)."""
    ls = np.stack([np.where(rng.random(n) < 0.5, rng.integers(0, min(m, 12), n),
                            rng.integers(0, m, n)) for m in LN_EMB]).astype(np.int64)
    valid = None
    if pooled:
        valid = rng.random(ls.shape) < 0.7
        valid[:, 0] = True
    return ls, valid


def test_warmup_plans_equal():
    (jc, _, _, jplan), (pc, _, _, pplan) = _warm_pair(False)
    same(pplan, jplan, "plan")
    assert pplan.insert_slots.size > 0
    same(pc.state_dict(), jc.state_dict(), "occupancy")


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("slot_map", [False, True], ids=["setassoc", "map"])
@pytest.mark.parametrize("pooled", [False, True], ids=["single", "pooled"])
def test_probes_equal(monkeypatch, pooled, slot_map, native_on):
    """probe, probe_wire, probe_dedup and probe_dedup_raw (plain and sorted):
    the same wire bytes, unique lists, miss lists, aux rows and hit counts
    from either package, through the native kernels and the numpy forms."""
    if not native_on:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(pnative, "available", lambda: False)
    elif not (jnative.available() and pnative.available()):
        pytest.skip("the native host libraries are not built here")
    (jc, jm, _, _), (pc, pm, _, _) = _warm_pair(slot_map)
    ls, valid = _lookups(np.random.default_rng(11), pooled=pooled)
    kw = {} if valid is None else {"valid": valid}
    j, p = jc.probe(ls, jm, **kw), pc.probe(ls, pm, **kw)
    same(p, j, "probe")
    assert 0 < int(p.hit_counts.sum()) < p.num_lookups
    for bits in (16, 24):
        same(pc.probe_wire(ls, pm, bits, **kw), jc.probe_wire(ls, jm, bits, **kw), f"wire{bits}")
    for inv_bits in (8, 16):
        pd, jd = pc.probe_dedup(ls, pm, inv_bits, **kw), jc.probe_dedup(ls, jm, inv_bits, **kw)
        same(pd, jd, f"dedup{inv_bits}")
        assert int(pd.uniq_counts.sum()) < ls.size  # slots did repeat
    for sort in (False, True):
        same(pc.probe_dedup_raw(ls, pm, sort=sort, **kw),
             jc.probe_dedup_raw(ls, jm, sort=sort, **kw), f"raw sort={sort}")
    same(pc.count_misses(ls, **kw), jc.count_misses(ls, **kw))
    same(pc.count_probe_stats(ls, **kw), jc.count_probe_stats(ls, **kw))


def _hot_set(ctl, kind, seed=5):
    """A sorted hot set of global cache rows for the cold count: None
    (absent), empty, or a sample of the controller's resident rows."""
    if kind == "absent":
        return None
    if kind == "empty":
        return np.zeros(0, np.int64)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([ctl.resident_slots(t, np.arange(min(n, 40)))
                           for t, n in enumerate(LN_EMB)])
    rows = np.unique(rows[rows >= 0])
    return np.sort(rng.choice(rows, rows.size // 2, replace=False)).astype(np.int64)


@pytest.mark.parametrize("ndev", [1, 2], ids=["1dev", "2dev"])
@pytest.mark.parametrize("hot", ["absent", "empty", "hot"])
@pytest.mark.parametrize("want_uniq", [True, False], ids=["uniq", "no-uniq"])
@pytest.mark.parametrize("slot_map", [False, True], ids=["setassoc", "map"])
@pytest.mark.parametrize("pooled", [False, True], ids=["single", "pooled"])
def test_probe_stats_native_equal(monkeypatch, pooled, slot_map, want_uniq, hot, ndev):
    """count_probe_stats, count_misses and count_probe_slices (the window
    stats' one native call per entry, csrc cdlrm_count_probe_stats): the
    native counts equal the numpy passes and cdlrm_tpu's, slice by slice."""
    if not pnative.available():
        pytest.skip("the native host library is not built here")
    (jc, _, _, _), (pc, _, _, _) = _warm_pair(slot_map)
    ls, valid = _lookups(np.random.default_rng(12), n=2 * AUX, pooled=pooled)
    hot_slots = _hot_set(pc, hot)
    slice_n = ls.shape[1] // ndev
    got = pc.count_probe_slices(ls, valid, ndev=ndev, slice_n=slice_n,
                                want_uniq=want_uniq, hot_slots=hot_slots)
    native_whole = (pc.count_probe_stats(ls, valid=valid, want_uniq=want_uniq,
                                         hot_slots=hot_slots),
                    pc.count_misses(ls, valid=valid))
    assert got.dtype == np.int64 and got.shape == (ndev, 4)
    for r in range(ndev):
        sl = slice(r * slice_n, (r + 1) * slice_n)
        ls_r = ls[:, sl]
        v = None if valid is None else valid[:, sl]
        m, u, c = jc.count_probe_stats(ls_r, valid=v, want_uniq=want_uniq, hot_slots=hot_slots)
        assert m == jc.count_misses(ls_r, valid=v)
        n_valid = ls_r.size if v is None else int(v.sum())
        want = [m, u if want_uniq else 0, c if hot_slots is not None else 0, n_valid]
        assert got[r].tolist() == want, r
        assert 0 < m < n_valid  # hits and misses both
        if want_uniq:
            assert m < u < n_valid  # resident ids did repeat
        if hot == "hot":
            assert m < c < n_valid  # some resident lookups were hot
        elif hot == "empty":
            assert c == n_valid
    monkeypatch.setattr(pnative, "available", lambda: False)
    same(pc.count_probe_slices(ls, valid, ndev=ndev, slice_n=slice_n, want_uniq=want_uniq,
                               hot_slots=hot_slots), got, "numpy slices")
    numpy_whole = (pc.count_probe_stats(ls, valid=valid, want_uniq=want_uniq,
                                        hot_slots=hot_slots),
                   pc.count_misses(ls, valid=valid))
    jax_whole = (jc.count_probe_stats(ls, valid=valid, want_uniq=want_uniq, hot_slots=hot_slots),
                 jc.count_misses(ls, valid=valid))
    assert native_whole == numpy_whole == jax_whole


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_probe_stats_reject_out_of_range_ids(monkeypatch, masked, native_on):
    """The map form's per-table range check on the stats path (the port's
    counterpart of tests/test_cache.py's slot-map test): an id past its
    table's segment, or below 0, in an unmasked lane raises ValueError
    "out of range" from count_misses, count_probe_stats and
    count_probe_slices, in any replica slice; in a masked lane it is never
    read, and the counts skip it."""
    if not native_on:
        monkeypatch.setattr(pnative, "available", lambda: False)
    elif not pnative.available():
        pytest.skip("the native host library is not built here")
    ln_emb = (50, 40, 30)
    geo = pgeometry.CacheGeometry.build(ln_emb, 4, 8, 2, 16)
    ctl = phost.HostCacheController(geo, seed=1, ln_emb=np.asarray(ln_emb), slot_map=True)
    for bad in (45, -3):  # 45 < ln_emb[0]: lands in table 2's segment
        ls = np.stack([np.arange(8, dtype=np.int64) for _ in ln_emb])
        ls[1, 6] = bad  # in the second of two slices of 4
        valid = np.ones((3, 8), bool)
        if masked:
            valid[1, 6] = False
            assert ctl.count_misses(ls, valid=valid) == 23
            assert ctl.count_probe_stats(ls, valid=valid) == (23, 23, 0)
            got = ctl.count_probe_slices(ls, valid, ndev=2, slice_n=4, hot_slots=np.zeros(0))
            assert got.tolist() == [[12, 12, 12, 12], [11, 11, 11, 11]]
        else:
            for call in (lambda: ctl.count_misses(ls),
                         lambda: ctl.count_probe_stats(ls),
                         lambda: ctl.count_probe_slices(ls, None, ndev=2, slice_n=4)):
                with pytest.raises(ValueError, match="out of range"):
                    call()
    if native_on:  # the binding checks the mask's shape before the kernel reads it
        with pytest.raises(ValueError, match="valid mask"):
            ctl.count_probe_slices(ls, valid[:, :4], ndev=2, slice_n=4)


def test_insert_plans_equal_over_windows():
    """plan_insert_spec, build_insert_plan and apply_plan_spec over windows
    that evict: the same specs, joined plans, occupancy and generator state,
    on the planning controller and on a clone that replays the specs."""
    (jc, jm, jgeo, _), (pc, pm, pgeo, _) = _warm_pair(True)
    jshadow, pshadow = jc.clone(), pc.clone()
    rng = np.random.default_rng(21)
    evicted = 0
    for _ in range(4):
        uniques = [np.unique(rng.integers(0, n, 200)) for n in LN_EMB]
        jspec, pspec = jshadow.plan_insert_spec(uniques), pshadow.plan_insert_spec(uniques)
        same(pspec, jspec, "spec")
        jplan = jhost.build_insert_plan(jspec, jm.gather_all(uniques), jgeo.dim)
        pplan = phost.build_insert_plan(pspec, pm.gather_all(uniques), pgeo.dim)
        same(pplan, jplan, "plan")
        evicted += pplan.evict_slots.size
        jc.apply_plan_spec(jspec)
        pc.apply_plan_spec(pspec)
        same(pc.state_dict(), jc.state_dict(), "replayed occupancy")
        same(pc.state_dict(), pshadow.state_dict(), "shadow occupancy")
        for t, ids in enumerate(uniques):
            same(pc.resident_slots(t, ids), jc.resident_slots(t, ids))
    assert evicted > 0


# ------------------------------------------------------------------ masters


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("init", ["uniform", "tile"])
def test_master_tables_equal(tmp_path, init):
    """Gather, writeback (overwrite and average), the dirty payload and the
    saved files, full and dirty; either package loads the other's file."""
    jm = jmaster.MasterTables(LN_EMB, DIM, rng=np.random.default_rng(2), init=init)
    pm = pmaster.MasterTables(LN_EMB, DIM, rng=np.random.default_rng(2), init=init)
    same(pm.tables, jm.tables, "tables")
    rng = np.random.default_rng(8)
    for average in (False, True):
        for t, n in enumerate(LN_EMB):
            ids = np.unique(rng.integers(0, n, 30))
            rows = rng.normal(size=(ids.size, DIM)).astype(np.float32)
            assert pm.writeback(t, ids, rows, average) == jm.writeback(t, ids, rows.copy(), average)
    ids = [np.unique(rng.integers(0, n, 50)) for n in LN_EMB]
    same(pm.gather_all(ids), jm.gather_all(ids), "gather")
    same(pm.dirty_payload(7), jm.dirty_payload(7), "dirty payload")
    for kind in ("save", "save_dirty"):
        jp, pp = str(tmp_path / f"j_{kind}.npz"), str(tmp_path / f"p_{kind}.npz")
        getattr(jm, kind)(jp)
        getattr(pm, kind)(pp)
        same(_npz(pp), _npz(jp), kind)
        with open(jp, "rb") as f, open(pp, "rb") as g:
            assert f.read() == g.read(), f"{kind}: the two files differ"
    # across packages: a fresh table set of each loads the other's dirty save
    j2 = jmaster.MasterTables(LN_EMB, DIM, rng=np.random.default_rng(2), init=init)
    p2 = pmaster.MasterTables(LN_EMB, DIM, rng=np.random.default_rng(2), init=init)
    j2.load(str(tmp_path / "p_save_dirty.npz"))
    p2.load(str(tmp_path / "j_save_dirty.npz"))
    same(p2.tables, jm.tables, "loaded")
    same(j2.tables, pm.tables, "loaded")


def test_virtual_master_tables_equal(tmp_path):
    ln = [250_000, 70_000, 40]
    jm = jmaster.VirtualMasterTables(ln, DIM, rng=np.random.default_rng(4))
    pm = pmaster.VirtualMasterTables(ln, DIM, rng=np.random.default_rng(4))
    rng = np.random.default_rng(9)
    ids = [np.unique(rng.integers(0, n, 300)) for n in ln]
    same(pm.gather_all(ids), jm.gather_all(ids), "procedural rows")
    for average in (False, True):
        for t, n in enumerate(ln):
            sel = ids[t][:: 2 + average]
            rows = rng.normal(size=(sel.size, DIM)).astype(np.float32)
            assert pm.writeback(t, sel, rows, average) == jm.writeback(t, sel, rows.copy(), average)
    same(pm.gather_all(ids), jm.gather_all(ids), "overlaid rows")
    jp, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jm.save(jp)
    pm.save(pp)
    same(_npz(pp), _npz(jp), "save")
    j2 = jmaster.VirtualMasterTables(ln, DIM, rng=np.random.default_rng(4))
    p2 = pmaster.VirtualMasterTables(ln, DIM, rng=np.random.default_rng(4))
    j2.load(pp)
    p2.load(jp)
    same(p2.gather_all(ids), jm.gather_all(ids), "loaded")
    same(j2.gather_all(ids), pm.gather_all(ids), "loaded")


@pytest.mark.parametrize("hosts,host", [(1, 0), (3, 0), (3, 2)])
def test_row_shard_equal(hosts, host):
    js, ps = jmultihost.RowShard(host, hosts), pmultihost.RowShard(host, hosts)
    rng = np.random.default_rng(3)
    for n in (1, 40, 301, 1200):
        assert ps.owned_range(n) == js.owned_range(n)
        ids = np.sort(rng.integers(0, n, 50))
        same(ps.owner_of(ids, n), js.owner_of(ids, n), "owner_of")
        same(ps.bounds(ids, n), js.bounds(ids, n), "bounds")


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("hosts,host,dims", [
    (1, 0, None), (1, 0, [4, 16, 8, 16]), (2, 1, [4, 16, 8, 16]),
], ids=["whole", "whole-md", "second-of-two-md"])
def test_sharded_master_tables_equal(tmp_path, monkeypatch, hosts, host, dims, native_on):
    """The two numpy classes the port copies from cdlrm_tpu's
    parallel/multihost.py: gathers (sorted, and any order over one whole
    shard, as the probe calls it), writeback (overwrite and average; the
    padded columns cut), ``save``, ``save_dirty`` and ``load`` across
    packages, and the shard-identity check."""
    if not native_on:
        monkeypatch.setenv("CDLRM_NO_NATIVE", "1")
        for mod in (jnative, pnative):
            monkeypatch.setattr(mod, "available", lambda: False)

    def build(mod, seed=4):
        return mod.ShardedMasterTables(LN_EMB, DIM, mod.RowShard(host, hosts),
                                       np.random.default_rng(seed), dims=dims)

    jm, pm = build(jmultihost), build(pmultihost)
    same(pm.tables, jm.tables, "tables")
    same(pm.ranges, jm.ranges, "ranges")
    if dims is not None:
        assert [t.shape[1] for t in pm.tables] == dims
    rng = np.random.default_rng(9)
    ids = [np.unique(rng.integers(0, n, 60)) for n in LN_EMB]
    for t in range(len(LN_EMB)):
        got, want = pm.gather(t, ids[t]), jm.gather(t, ids[t])
        same(got, want, "gather")
        assert got.shape[1] == DIM
        same(pm.owned_mask(t, ids[t]), jm.owned_mask(t, ids[t]), "owned_mask")
        same(pm.gather_owned_of(t, ids[t][::-1]), jm.gather_owned_of(t, ids[t][::-1]),
             "gather_owned_of")
        if hosts == 1:
            shuffled = rng.permutation(ids[t])
            same(pm.gather(t, shuffled), jm.gather(t, shuffled), "unsorted gather")
    for average in (False, True):
        for t in range(len(LN_EMB)):
            sel = ids[t][:: 2 + average]
            rows = rng.normal(size=(sel.size, DIM)).astype(np.float32)
            assert pm.writeback(t, sel, rows, average) == jm.writeback(t, sel, rows.copy(), average)
    assert pm.writeback(0, np.zeros(0, np.int64), np.zeros((0, DIM), np.float32)) == 0
    same(pm.tables, jm.tables, "tables after writeback")
    for kind in ("save", "save_dirty"):
        jp, pp = str(tmp_path / f"j_{kind}.npz"), str(tmp_path / f"p_{kind}.npz")
        getattr(jm, kind)(jp)
        getattr(pm, kind)(pp)
        same(_npz(pp), _npz(jp), kind)
        j2, p2 = build(jmultihost), build(pmultihost)
        j2.load(pp)
        p2.load(jp)
        same(p2.tables, jm.tables, f"{kind} loaded")
        same(j2.tables, pm.tables, f"{kind} loaded")
    with pytest.raises(ValueError, match="init token"):
        build(pmultihost).load(str(tmp_path / "j_save_dirty.npz"), init_token=5)
    other = pmultihost.ShardedMasterTables(
        LN_EMB, DIM, pmultihost.RowShard(0, hosts + 1), np.random.default_rng(4), dims=dims)
    with pytest.raises(ValueError, match="hosts"):
        other.load(str(tmp_path / "j_save.npz"))


def test_sharded_master_tables_refuse_wide_dims():
    with pytest.raises(ValueError, match="exceed base dim"):
        pmultihost.ShardedMasterTables([10], 8, pmultihost.RowShard(0, 1), dims=[16])


def test_accumulator_store_equal(tmp_path):
    js, ps = jmaster.AccumulatorStore(LN_EMB), pmaster.AccumulatorStore(LN_EMB)
    rng = np.random.default_rng(13)
    for _ in range(3):
        for t, n in enumerate(LN_EMB):
            ids = np.unique(rng.integers(0, n, 25))
            vals = rng.random(ids.size).astype(np.float32)
            js.writeback(t, ids, vals)
            ps.writeback(t, ids, vals)
    same(ps.accs, js.accs, "accs")
    tables = rng.integers(0, len(LN_EMB), 200).astype(np.int32)
    ids = np.array([rng.integers(0, LN_EMB[t]) for t in tables], np.int64)
    same(ps.gather(tables, ids), js.gather(tables, ids), "gather")
    sorted_ids = np.unique(rng.integers(0, LN_EMB[1], 60))
    same(ps.gather_owned_slice(1, sorted_ids), js.gather_owned_slice(1, sorted_ids))
    same(ps.payload(), js.payload(), "payload")
    np.savez(str(tmp_path / "p.npz"), **ps.payload())
    fresh = jmaster.AccumulatorStore(LN_EMB)
    with np.load(str(tmp_path / "p.npz")) as data:
        fresh.load_payload(data)
    same(fresh.accs, ps.accs, "cdlrm_tpu loads the port's payload")


# --------------------------------------------------------------- prefetcher


class _Stream:
    """A seeded id stream in the prefetcher's protocol: ``fn(skip=)`` yields
    [T, B] id arrays, or (ids, mask) pairs when pooled."""

    def __init__(self, batches=12, batch=32, pooled=0, seed=17):
        self.batches, self.batch, self.pooled, self.seed = batches, batch, pooled, seed

    def __call__(self, skip=0):
        rng = np.random.default_rng(self.seed)
        for j in range(self.batches):
            n = self.batch * max(1, self.pooled)
            ls, _ = _lookups(rng, n)
            if self.pooled:
                ls = ls.reshape(len(LN_EMB), self.batch, self.pooled)
                mask = rng.random(ls.shape) < 0.7
                mask[:, :, 0] = True
                item = (ls, mask)
            else:
                item = ls
            if j >= skip:
                yield item


def _windows(pkg, stream, lookahead, want_uniq, skip=0, hot=0, ndev=1, mmap_dir=None):
    host, geometry, master, _ = pkg
    prefetcher = jprefetcher if pkg is JAX else pprefetcher
    geo = geometry.CacheGeometry.build(LN_EMB, DIM, SETS, WAYS, AUX)
    tables = master.MasterTables(LN_EMB, DIM, rng=np.random.default_rng(1), mmap_dir=mmap_dir)
    ctl = host.HostCacheController(geo, seed=1, ln_emb=LN_EMB, slot_map=True)
    pf = prefetcher.LookaheadPrefetcher(
        cache_stream_fn=stream, master=tables, lookahead=lookahead, batch_fifo_size=8,
        cache_workers=2, skip_batches=skip, shadow=ctl.clone(),
        backend="thread" if mmap_dir is None else "process",
        stats_spec=(ndev, stream.batch // ndev, want_uniq, hot),
    )
    pf.start()
    out = []
    try:
        while True:
            w = pf.get_window(timeout=60)
            if w is None:
                break
            out.append(w)
    finally:
        pf.stop()
        pf.join(timeout=60)
    assert not pf.is_alive() and pf.error is None, pf.error
    return out


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("pooled,want_uniq,skip,hot,ndev", [
    (0, True, 0, 0, 1), (3, True, 0, 0, 1), (0, False, 4, 0, 1), (0, True, 0, 16, 1),
    (3, False, 0, 16, 1), (3, True, 0, 16, 2), (0, False, 0, 0, 2),
], ids=["single", "pooled", "resumed", "hot", "pooled-hot", "pooled-hot-2dev", "misses-2dev"])
def test_prefetcher_windows_equal(monkeypatch, pooled, want_uniq, skip, hot, ndev, native_on):
    """The LookaheadPrefetcher's windows: uniques, master rows, the shadow
    planner's spec, the window stats and the stream cursor, field by field;
    with the hot tier (``hot`` = H) also the window's hot list (the H - 1
    hottest resident rows, ``_select_hot``) and its worst cold count. The
    port counts its window stats through the native library and, with it
    patched away, through the numpy passes; cdlrm_tpu's are the same."""
    if not native_on:
        monkeypatch.setattr(pnative, "available", lambda: False)
    elif not pnative.available():
        pytest.skip("the native host library is not built here")
    stream = _Stream(pooled=pooled)
    jw = _windows(JAX, stream, 4, want_uniq, skip, hot, ndev)
    pw = _windows(PORT, stream, 4, want_uniq, skip, hot, ndev)
    assert len(pw) == len(jw) == (12 - skip) // 4
    for p, j in zip(pw, jw):
        assert type(p).__module__ == "cdlrm_tpu_torch.cache.prefetcher"
        assert type(p.stats).__module__ == "cdlrm_tpu_torch.cache.host_cache"
        same(p, j, "window")
        assert p.stats.total_lookups > 0 and (p.stats.worst_uniq > 0) == want_uniq
        if hot:
            assert 0 < p.hot_slots.size <= hot - 1 and p.stats.worst_cold > 0
        else:
            assert p.hot_slots is None and p.stats.worst_cold == 0
    assert sum(w.plan_spec.evict_slots.size for w in pw) > 0  # later windows evicted


@pytest.mark.parametrize("backend", ["thread", "process"])
@pytest.mark.parametrize("native_on", [True, False], ids=["native", "numpy"])
def test_prefetcher_counts_how_it_counted_the_stats(tmp_path, monkeypatch, native_on, backend):
    """``prefetch.stats_native`` counts the window entries whose stats the
    native call counted, ``prefetch.stats_numpy`` those the numpy passes
    counted: one of the two moves by every entry, the other stays. The
    process backend counts on the prefetcher thread through the same call,
    and its windows equal cdlrm_tpu's thread-backend ones."""
    from cdlrm_tpu_torch.utils import profiling

    if not native_on:
        monkeypatch.setattr(pnative, "available", lambda: False)
    elif not pnative.available():
        pytest.skip("the native host library is not built here")
    names = ("prefetch.stats_native", "prefetch.stats_numpy")
    stream = _Stream(pooled=3)
    before = profiling.counters()
    windows = _windows(PORT, stream, 4, True, hot=16, ndev=2,
                       mmap_dir=None if backend == "thread" else str(tmp_path))
    after = profiling.counters()
    moved = [after.get(k, 0) - before.get(k, 0) for k in names]
    entries = sum(w.num_batches for w in windows)
    assert entries == 12
    assert moved == ([entries, 0] if native_on else [0, entries])
    if backend == "process":
        same(windows, _windows(JAX, stream, 4, True, hot=16, ndev=2), "windows")


def test_eviction_manager_writes_the_same_rows():
    import queue

    outs = []
    for pkg, prefetcher in ((JAX, jprefetcher), (PORT, pprefetcher)):
        tables = pkg[2].MasterTables(LN_EMB, DIM, rng=np.random.default_rng(1))
        store = pkg[2].AccumulatorStore(LN_EMB)
        fifo = queue.Queue()
        mgr = prefetcher.EvictionManager(tables, fifo, timeout=30, acc_store=store)
        rng = np.random.default_rng(5)
        mgr.start()
        for _ in range(3):
            # the rows of one eviction are distinct (a duplicate would have two
            # writers in the threaded writeback), later items write some again
            n = 40
            flat = rng.choice(int(LN_EMB.sum()), n, replace=False)
            t = (np.searchsorted(np.cumsum(LN_EMB), flat, side="right")).astype(np.int32)
            ids = (flat - np.concatenate([[0], np.cumsum(LN_EMB)])[t]).astype(np.int64)
            rows = rng.normal(size=(n, DIM)).astype(np.float32)
            fifo.put((t, ids, rows, rng.random(n).astype(np.float32)))
        assert mgr.flush(timeout=30)
        fifo.put(None)
        mgr.join(timeout=30)
        assert not mgr.is_alive()
        outs.append((tables.tables, store.accs, mgr.rows_written))
    same(outs[1], outs[0], "written")
    assert outs[1][2] > 0


# ------------------------------------------------------------------- native


def test_native_libraries_are_two_files():
    """Each package builds its own library from its own source into its own
    directory, and one process holds both."""
    if not (jnative.available() and pnative.available()):
        pytest.skip("the native host libraries are not built here")
    jlib, plib = jnative._load()._name, pnative._load()._name
    assert jlib != plib
    assert "/cdlrm_tpu_torch/csrc/build/libcdlrm_torch_host_" in plib
    assert "/cdlrm_tpu_torch/" not in jlib
    assert pnative.num_threads() >= 1


@pytest.mark.parametrize("fn", ["unique_i64", "gather_f32", "writeback_f32", "unique_gather_f32",
                                "pack_bits", "mask_bits"])
def test_native_kernels_match_numpy_forms(fn):
    """The port's own library against the numpy form of each kernel (and, by
    test_probes_equal, against cdlrm_tpu's library on the probes)."""
    if not pnative.available():
        pytest.skip("the native host library is not built here")
    rng = np.random.default_rng(31)
    table = rng.normal(size=(5000, DIM)).astype(np.float32)
    idx = rng.integers(0, 5000, 3000).astype(np.int64)
    if fn == "unique_i64":
        for n_rows in (0, 5000):  # the radix sort and the bitmap
            same(pnative.unique_i64(idx, n_rows), np.unique(idx))
        same(jnative.unique_i64(idx, 5000), pnative.unique_i64(idx, 5000))
    elif fn == "gather_f32":
        same(pnative.gather_f32(table, idx), table[idx])
    elif fn == "writeback_f32":
        ids = np.unique(idx)
        rows = rng.normal(size=(ids.size, DIM)).astype(np.float32)
        for average in (False, True):
            got, want = table.copy(), table.copy()
            pnative.writeback_f32(got, ids, rows, average)
            want[ids] = (want[ids] + rows) / 2 if average else rows
            same(got, want, f"average={average}")
    elif fn == "unique_gather_f32":
        ids, rows = pnative.unique_gather_f32(idx, table)
        same(ids, np.unique(idx))
        same(rows, table[np.unique(idx)])
    elif fn == "pack_bits":
        from cdlrm_tpu_torch.train.step import pack_slots, wire_bytes

        for bits in (9, 16, 24):
            vals = rng.integers(0, 1 << bits, 1001).astype(np.int64)
            vals[::13] = -1  # the all-ones sentinel, the trash row in pack_slots
            trash = 1 << 30
            want = pack_slots(np.where(vals < 0, trash, vals)[None], np.zeros(1, np.int64),
                              trash, bits)[0]
            same(pnative.pack_bits(vals, bits, wire_bytes(vals.size, bits)), want, f"bits={bits}")
    else:
        mask = rng.random(1000) < 0.4
        words = pnative.mask_bits(mask.astype(np.uint8))
        want = np.zeros(16, np.uint64)
        for i in np.flatnonzero(mask):
            want[i // 64] |= np.uint64(1) << np.uint64(i % 64)
        same(words, want)
        same(jnative.mask_bits(mask.astype(np.uint8)), words)


# -------------------------------------------------------------- checkpoints


def test_checkpoint_files_hold_no_object_of_the_port(tmp_path):
    """A checkpoint of the port must load where cdlrm_tpu_torch cannot be
    imported: ``meta.pkl`` names no class of the port, and every array file
    loads without pickle."""
    import os
    import pickle

    from test_torch_adagrad import _traj_cfg
    from test_torch_train_trainer import _SkewSwitch
    from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer

    tr = CachedDlrmTrainer(_traj_cfg(True, adagrad_master_state=True), _SkewSwitch(12),
                           device="cpu")
    ck = str(tmp_path / "ck")
    try:
        tr.train(max_steps=8, log_fn=lambda *_: None)
        tr.save_checkpoint(ck)
    finally:
        tr.close()
    names = sorted(os.listdir(ck))
    assert {"meta.pkl", "master.npz", "acc_store.npz", "occupancy.npz"} <= set(names), names
    for name in names:
        path = os.path.join(ck, name)
        with open(path, "rb") as f:
            raw = f.read()
        assert b"cdlrm_tpu_torch" not in raw, name
        if name.endswith(".pkl"):
            meta = pickle.loads(raw)
            assert meta["global_step"] == 8
        elif name.endswith(".npz"):
            with np.load(path, allow_pickle=False) as data:
                assert all(data[k] is not None for k in data.files)
        elif name.endswith(".npy"):
            np.load(path, allow_pickle=False)
