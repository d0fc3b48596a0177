"""cdlrm_tpu_torch imports neither jax nor cdlrm_tpu, and its Config
finalizes as cdlrm_tpu's does.

The port keeps its own copy of the host layer (config, data, cache, native
ops, pipeline, utils). The guard runs the whole serving and training paths
and the CLI in a fresh interpreter where importing jax or cdlrm_tpu fails,
and a static walk over the port's sources, chip_smoke.py and the port's
harnesses finds no such import, by statement or by string; bench_torch.py's
CPU mode runs where jax and cdlrm_tpu cannot be imported."""

import ast
import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu_torch.config import Config, finalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "cdlrm_tpu")
# any import of jax, ml_dtypes or cdlrm_tpu (or of a module of them) raises
# ImportError
_BLOCK_JAX = ("import sys; sys.modules['jax'] = None; sys.modules['cdlrm_tpu'] = None; "
              "sys.modules['ml_dtypes'] = None\n")
_JAX_LOADED = (
    "loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and "
    "m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'cdlrm_tpu'))\n"
    "assert not loaded, loaded\n"
)
_SERVE = _BLOCK_JAX + """
import numpy as np
from cdlrm_tpu_torch.config import Config, build_dataset
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
for pooled in (1, 3):
    cfg = Config(arch_embedding_size="1000-500-2000", arch_sparse_feature_size=16,
                 arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1", mini_batch_size=64,
                 num_batches=4, cache_size=128, num_ways=4, loss_function="bce",
                 num_indices_per_lookup=pooled, num_indices_per_lookup_fixed=pooled == 1,
                 inference_only=True, round_targets=True)
    train_ds, test_ds, cfg = build_dataset(cfg)
    tr = CachedDlrmTrainer(cfg, train_ds, test_ds, device="cpu")
    acc, auc = tr.evaluate(max_batches=2)
    tr.close()
    assert 0.0 <= acc <= 1.0 and tr.metrics.eval_lookups > 0
""" + _JAX_LOADED + "print('SERVED')\n"

_TRAIN = _BLOCK_JAX + """
import numpy as np
from cdlrm_tpu_torch.config import Config, build_dataset
from cdlrm_tpu_torch.train.trainer import CachedDlrmTrainer
# the hot tier on the plain wire, then the sorted unpacked dedup wire
for pooled, dedup, extra in ((1, "auto", {}), (1, "on", {}), (3, "on", {}),
                             (1, "off", dict(hot_tier_rows=16)),
                             (3, "on", dict(sorted_dedup_wire=True, pack_wire=False))):
    cfg = Config(arch_embedding_size="1000-500-2000", arch_sparse_feature_size=16,
                 arch_mlp_bot="13-32-16", arch_mlp_top="16-8-1", mini_batch_size=64,
                 num_batches=8, cache_size=128, num_ways=4, loss_function="bce",
                 num_indices_per_lookup=pooled, num_indices_per_lookup_fixed=pooled == 1,
                 lookahead=2, print_freq=4, dedup_lookups=dedup, round_targets=True, **extra)
    train_ds, test_ds, cfg = build_dataset(cfg)
    tr = CachedDlrmTrainer(cfg, train_ds, test_ds, device="cpu")
    tr.train(max_steps=8)
    tr.eviction_manager.flush()
    acc, auc = tr.evaluate(max_batches=2)
    tr.close()
    assert tr.global_step == 8 and tr.metrics.refills == 4, tr.metrics
    assert tr.eviction_manager.rows_written > 0 and 0.0 <= acc <= 1.0
    assert (tr._hot_slots_dev is not None) == bool(tr._hot)
""" + _JAX_LOADED + "print('TRAINED')\n"

_CLI = _BLOCK_JAX + """
import runpy
from cdlrm_tpu_torch.train import trainer
# record the train steps the cached trainer builds: (size, dedup, coalesce)
_BLOCKS = set()
_get_step = trainer.CachedDlrmTrainer._get_step
def _recording(self, *key):
    _BLOCKS.add(tuple(key) + (False,) * (3 - len(key)))
    return _get_step(self, *key)
trainer.CachedDlrmTrainer._get_step = _recording
try:
    runpy.run_module("cdlrm_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
""" + _JAX_LOADED
# a small training run of the CLI on the CPU: 8 batches of 64
_SMALL = (
    "--device", "cpu", "--data-generation", "random",
    "--arch-embedding-size", "1000-500-2000", "--arch-sparse-feature-size", "16",
    "--arch-mlp-bot", "13-32-16", "--arch-mlp-top", "16-8-1",
    "--mini-batch-size", "64", "--num-batches", "8", "--cache-size", "128",
    "--num-ways", "4", "--loss-function", "bce", "--round-targets",
)


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", code, *args], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )


def test_serving_path_runs_without_jax():
    res = _run(_SERVE)
    assert res.returncode == 0, res.stderr
    assert "SERVED" in res.stdout and "Test accuracy" in res.stdout


def test_cli_serves_without_jax():
    res = _run(
        _CLI, "--device", "cpu", "--inference-only", "--data-generation", "random",
        "--arch-embedding-size", "1000-500-2000", "--arch-sparse-feature-size", "16",
        "--arch-mlp-bot", "13-32-16", "--arch-mlp-top", "16-8-1",
        "--mini-batch-size", "64", "--num-batches", "4", "--cache-size", "128",
        "--num-ways", "4", "--loss-function", "bce", "--round-targets",
    )
    assert res.returncode == 0, res.stderr
    assert "Test accuracy" in res.stdout


def test_training_path_runs_without_jax():
    """train() with the plain and the packed dedup wire, single-index and
    pooled bags, a hot-tier run and a sorted-wire run: the prefetcher, the
    stager, the pipeline's dedup probe and the eviction writeback all run
    with jax unimportable."""
    res = _run(_TRAIN)
    assert res.returncode == 0, res.stderr
    assert "TRAINED" in res.stdout and "Step 8:" in res.stdout


def test_cli_trains_without_jax():
    res = _run(
        _CLI, "--device", "cpu", "--data-generation", "random",
        "--arch-embedding-size", "1000-500-2000", "--arch-sparse-feature-size", "16",
        "--arch-mlp-bot", "13-32-16", "--arch-mlp-top", "16-8-1",
        "--mini-batch-size", "64", "--num-batches", "8", "--cache-size", "128",
        "--num-ways", "4", "--loss-function", "bce", "--round-targets",
        "--lookahead", "2", "--print-freq", "4",
    )
    assert res.returncode == 0, res.stderr
    assert "Step 8:" in res.stdout and "Test accuracy" in res.stdout


def test_cli_trains_scan_blocks_without_jax():
    """Coalesced scan blocks on the unpacked dedup wire (the random stream is
    near-unique, so dedup is forced on), then eval."""
    res = _run(
        _CLI + "print('BLOCKS', sorted(k for k in _BLOCKS))\n",
        *_SMALL, "--scan-steps", "4", "--no-pack-wire", "--dedup-lookups", "on",
        "--lookahead", "8", "--print-freq", "4",
    )
    assert res.returncode == 0, res.stderr
    assert "Step 8:" in res.stdout and "Test accuracy" in res.stdout
    assert "(4, True, True)" in res.stdout  # a coalesced block of 4 ran


def test_cli_adagrad_checkpoint_without_jax(tmp_path):
    """AdaGrad with the master state on the packed dedup wire, saved with
    --save-model; then the checkpoint loads (--load-model), training resumes
    from its step and the resumed run saves again."""
    ck = str(tmp_path / "ck")
    adagrad = ("--optimizer", "adagrad", "--dedup-lookups", "on", "--adagrad-master-state",
               "--learning-rate", "0.05", "--lr-embeds", "0.05", "--lookahead", "2",
               "--print-freq", "4", "--save-model", ck)
    res = _run(_CLI, *_SMALL, *adagrad)
    assert res.returncode == 0, res.stderr
    assert "Step 8:" in res.stdout and "Test accuracy" in res.stdout
    for name in ("meta.pkl", "embed_acc.npy", "dense_acc.npz", "acc_store.npz", "master.npz"):
        assert os.path.exists(os.path.join(ck, name)), name
    # 8 more batches from the saved cursor: steps 9-16
    longer = list(_SMALL)
    longer[longer.index("--num-batches") + 1] = "16"
    res = _run(_CLI, *longer, *adagrad, "--load-model", ck)
    assert res.returncode == 0, res.stderr
    assert "Step 16:" in res.stdout and "Step 8:" not in res.stdout
    assert "Test accuracy" in res.stdout
    with open(os.path.join(ck, "meta.pkl"), "rb") as f:
        assert pickle.load(f)["global_step"] == 16


def test_cli_trains_fulltable_without_jax():
    res = _run(_CLI, *_SMALL, "--no-use-cache", "--print-freq", "4")
    assert res.returncode == 0, res.stderr
    assert "Epoch 0: 4/8" in res.stdout and "Test accuracy" in res.stdout


@pytest.mark.parametrize("extra,want", [
    (("--wire-rows-bf16", "--wire-x-fp8", "--dedup-lookups", "on", "--lookahead", "2",
      "--print-freq", "4"), "Step 8:"),
    (("--md-flag", "--master-init", "virtual", "--lookahead", "2", "--print-freq", "4"),
     "Step 8:"),
    (("--no-use-cache", "--qr-flag", "--qr-threshold", "600", "--print-freq", "4"),
     "Epoch 0: 4/8"),
    (("--no-use-cache", "--md-flag", "--md-threshold", "600", "--print-freq", "4"),
     "Epoch 0: 4/8"),
], ids=["byte-lean-wires", "cached-md-virtual", "fulltable-qr", "fulltable-md"])
def test_cli_trains_the_variants_without_jax(extra, want):
    """The fp8 and bf16 wires round with torch, never ml_dtypes; cached MD on
    virtual masters takes the port's own row-sharded master class."""
    res = _run(_CLI, *_SMALL, *extra)
    assert res.returncode == 0, res.stderr
    assert want in res.stdout and "Test accuracy" in res.stdout


def test_cli_profiles_without_jax(tmp_path):
    trace_dir = str(tmp_path / "trace")
    res = _run(_CLI, *_SMALL, "--lookahead", "2", "--print-freq", "4", "--enable-profiling",
               "--profile-dir", trace_dir)
    assert res.returncode == 0, res.stderr
    assert "Step 8:" in res.stdout
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0


def test_cli_trains_two_ranks_without_jax(tmp_path):
    """``--world-size 2`` on the CPU: the CLI spawns two ranks, which meet
    over gloo; then a multi-host run, two CLI processes that join a
    coordinator and hold a row shard of the masters each. The interpreters
    inherit no ``sys.modules``, so here jax, ml_dtypes and cdlrm_tpu are
    blocked by modules of those names that raise, placed ahead of the repo
    on the path of the CLI and its ranks."""
    stubs = tmp_path / "stubs"
    for name in ("jax", "jaxlib", "ml_dtypes", "cdlrm_tpu"):
        (stubs / name).mkdir(parents=True)
        (stubs / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked in this test')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(stubs), REPO]), OMP_NUM_THREADS="1")
    # run from another directory: the repo's own cdlrm_tpu must not shadow the stub
    probe = subprocess.run(
        [sys.executable, "-c", "import cdlrm_tpu"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "cdlrm_tpu is blocked" in probe.stderr
    res = subprocess.run(
        [sys.executable, "-m", "cdlrm_tpu_torch.cli", *_SMALL, "--world-size", "2",
         "--lookahead", "2", "--print-freq", "4", "--dedup-lookups", "on"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    # rank 0 alone prints
    assert res.stdout.count("Step 8:") == 1 and res.stdout.count("Test accuracy") == 1
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "cdlrm_tpu_torch.cli", *_SMALL, "--world-size", "2",
         "--lookahead", "2", "--print-freq", "4", "--coordinator-address",
         f"127.0.0.1:{port}", "--num-hosts", "2", "--host-id", str(r)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert f"[multihost] process {r}/2 initialized" in out
    assert outs[0][0].count("Step 8:") == 1 and outs[0][0].count("Test accuracy") == 1


def test_cli_refuses_training():
    """The CLI trains with every field of cdlrm_tpu's; what it refuses is
    training with a combination that cdlrm_tpu refuses, in its words, before
    any data is read."""
    from cdlrm_tpu_torch import cli

    with pytest.raises(ValueError, match="optimizer='adagrad' is incompatible with the hot tier"):
        cli.main(["--device", "cpu", "--arch-embedding-size", "100-200",
                  "--arch-sparse-feature-size", "2", "--hot-tier-rows", "64",
                  "--optimizer", "adagrad", "--dedup-lookups", "on"])


def _fields_equal(a: Config, b: JaxConfig):
    assert [f.name for f in dataclasses.fields(Config)] == [
        f.name for f in dataclasses.fields(JaxConfig)]
    for f in dataclasses.fields(Config):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("op,itself", [("dot", False), ("dot", True), ("cat", False)])
@pytest.mark.parametrize("md", [False, True])
@pytest.mark.parametrize("max_ind_range", [-1, 700])
def test_finalize_matches_config_finalize(op, itself, md, max_ind_range):
    ln_emb = np.array([1000, 50, 3000, 20000])
    kw = dict(arch_sparse_feature_size=16, arch_mlp_bot="13-32-16", arch_mlp_top="16-1",
              arch_interaction_op=op, arch_interaction_itself=itself, md_flag=md,
              max_ind_range=max_ind_range, mini_batch_size=32)
    want = JaxConfig(**kw).finalize(ln_emb=ln_emb, m_den=13)
    got = finalize(Config(**kw), ln_emb=ln_emb, m_den=13)
    _fields_equal(got, want)
    want_d = JaxConfig(arch_embedding_size="40-50-60", **kw).finalize()
    got_d = Config(arch_embedding_size="40-50-60", **kw).finalize()
    _fields_equal(got_d, want_d)


def _forbidden_imports(path):
    """(line, name) of every import of a FORBIDDEN package in one source:
    ``import x``, ``from x import``, and ``importlib.import_module("x")`` or
    ``__import__("x")`` with the name given as a string."""
    return [(line, n) for line, n in _imports(path) if n.split(".")[0] in FORBIDDEN]


def _imports(path):
    """(line, name) of every import in one source, in the forms
    :func:`_forbidden_imports` reads."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if called in ("import_module", "__import__", "run_module") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    names = [arg.value]
        found += [(node.lineno, n) for n in names]
    return found


def _port_sources():
    for root, _, files in os.walk(os.path.join(REPO, "cdlrm_tpu_torch")):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)


def test_port_sources_import_neither_jax_nor_cdlrm_tpu():
    sources = list(_port_sources())
    assert len(sources) > 25, sources  # the walk found the package
    walked = {os.path.relpath(p, os.path.join(REPO, "cdlrm_tpu_torch")) for p in sources}
    assert {os.path.join("parallel", "multihost.py"), os.path.join("utils", "profiling.py"),
            os.path.join("models", "tricks.py"), os.path.join("parallel", "mesh.py")} <= walked
    bad = {os.path.relpath(p, REPO): hits for p in sources if (hits := _forbidden_imports(p))}
    assert not bad, bad


def test_chip_smoke_imports_neither_jax_nor_cdlrm_tpu():
    assert not _forbidden_imports(os.path.join(REPO, "chip_smoke.py"))


HARNESSES = ("bench_torch.py", "bench_step_breakdown_torch.py", "bench_serving_ab_torch.py",
             "bench_block_ab_torch.py", "bench_pressure_torch.py", "bench_collectives_torch.py",
             "bench_scaling_torch.py")


@pytest.mark.parametrize("script", HARNESSES)
def test_harnesses_import_neither_jax_nor_the_reference(script):
    """The port's harnesses import neither jax nor cdlrm_tpu, nor the
    reference's harnesses (bench.py and its siblings), only each other."""
    path = os.path.join(REPO, script)
    assert not _forbidden_imports(path)
    benches = [n for _, n in _imports(path) if n.split(".")[0].startswith("bench")]
    assert all(n.endswith("_torch") for n in benches), benches


_BENCH = _BLOCK_JAX + """
import os, runpy
os.environ["BENCH_CPU"] = "1"
try:
    runpy.run_path("bench_torch.py", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
""" + _JAX_LOADED + "print('BENCHED')\n"


def test_bench_torch_runs_without_jax():
    """bench_torch.py's CPU mode end to end (headline, device step, scan
    block, serving, steady state) with jax and cdlrm_tpu unimportable."""
    res = _run(_BENCH)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "BENCHED"
    rec = json.loads(lines[-2])
    assert rec["metric"] == "cached_dlrm_train_examples_per_sec_per_chip"
    assert rec["backend"] == "cpu" and rec["steady_refills"] >= 3


_BLOCK_AB = _BLOCK_JAX + """
import os, runpy
os.environ.update(BLOCKAB_CPU="1", BLOCKAB_TABLES="2", BLOCKAB_IDS="500", BLOCKAB_BATCH="32",
                  BLOCKAB_CACHE_ROWS="2048")
try:
    runpy.run_path("bench_block_ab_torch.py", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
""" + _JAX_LOADED + "print('BLOCKAB')\n"


def test_bench_block_ab_torch_runs_without_jax():
    """bench_block_ab_torch.py's CPU mode (both streams, both arms, the
    float64 check) with jax and cdlrm_tpu unimportable."""
    res = _run(_BLOCK_AB)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "BLOCKAB"
    recs = [json.loads(ln) for ln in lines[-3:-1]]
    assert [r["stream"] for r in recs] == ["loguniform", "zipf12"]
    assert all(r["backend"] == "cpu" and r["B_over_A"] > 0 for r in recs)


def test_dp_worker_imports_neither_jax_nor_cdlrm_tpu():
    """The ranks of the data-parallel tests run the port alone; the tests
    that launch them make cdlrm_tpu's side themselves."""
    assert not _forbidden_imports(os.path.join(REPO, "tests", "torch_dp_worker.py"))


def test_forbidden_import_walk_sees_every_form(tmp_path):
    """The walk itself: statements at any depth and imports by string."""
    src = tmp_path / "m.py"
    src.write_text(
        "import os, jax.numpy as jnp\n"
        "def f():\n"
        "    from cdlrm_tpu.config import Config\n"
        "    import importlib\n"
        "    importlib.import_module('cdlrm_tpu.ops.native')\n"
        "    __import__('jaxlib')\n"
        "    from cdlrm_tpu_torch.config import Config\n"
        "    from . import jax\n"
    )
    assert _forbidden_imports(str(src)) == [
        (1, "jax.numpy"), (3, "cdlrm_tpu.config"), (5, "cdlrm_tpu.ops.native"), (6, "jaxlib")]
