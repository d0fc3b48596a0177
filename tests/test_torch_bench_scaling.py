"""bench_scaling_torch.py on CPU gloo ranks, against bench_scaling.py.

Both topologies (two data-parallel ranks as one host, two multi-host ranks
through a coordinator) train the reference's worker configuration, and the
three lines parse with rates above zero and the lower-bound note. The
worker's Config is the one bench_scaling.py's ``_WORKER`` script builds: its
``Config(...)`` call is read from the script and finalized by cdlrm_tpu's
Config beside the port's.
"""

import ast
import json
import os
import subprocess
import sys

import pytest

from cdlrm_tpu.config import Config as JaxConfig
from cdlrm_tpu_torch.config import Config
from test_torch_jax_free import _fields_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_scaling  # noqa: E402
import bench_scaling_torch as S  # noqa: E402


def _run(*argv, timeout=300):
    return subprocess.run([sys.executable, os.path.join(REPO, "bench_scaling_torch.py"), *argv],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))


def _reference_worker_kwargs(world, batch):
    """The keyword arguments of the ``Config(...)`` call in
    bench_scaling.py's ``_WORKER``, evaluated at ``world`` and ``batch``."""
    tree = ast.parse(bench_scaling._WORKER)
    [call] = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
              and getattr(n.func, "id", None) == "Config"]
    return {kw.arg: eval(compile(ast.Expression(kw.value), "<_WORKER>", "eval"),
                         {"world": world, "batch": batch})
            for kw in call.keywords}


@pytest.mark.parametrize("world,batch", [(2, 256), (4, 512)])
def test_worker_config_is_the_reference_worker_config(world, batch):
    kw = S.worker_config_kwargs(world, batch)
    assert kw == _reference_worker_kwargs(world, batch)
    port = Config(**kw)
    port.finalize()
    ref = JaxConfig(**kw)
    ref.finalize()
    _fields_equal(port, ref)


def test_both_topologies_run_and_print_the_three_lines():
    p = _run("--backend", "cpu", "--steps", "8", "--hosts", "2")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 3
    single, multi, eff = lines
    assert single["topology"] == "1-host" and multi["topology"] == "2-host"
    for rec in (single, multi):
        assert rec["world"] == rec["ranks"] == 2
        assert rec["examples_per_sec"] > 0 and rec["ms_per_iter"] > 0
    assert eff["metric"] == "multihost_scaling_efficiency" and eff["value"] > 0
    assert "lower bound" in eff["note"] and eff["backend"] == "cpu" and eff["device"] is None
    assert eff["launches"] == dict.fromkeys(
        ("gather_rows", "scatter_set_rows", "scatter_add_rows", "index_add_rows"), 0)


def test_more_than_one_device_per_host_is_refused():
    p = _run("--backend", "cpu", "--devices-per-host", "2")
    assert p.returncode == 2 and not p.stdout.strip()
    assert "a cdlrm_tpu_torch rank holds one device" in p.stderr


def test_without_a_card_exits_nonzero():
    p = subprocess.run([sys.executable, os.path.join(REPO, "bench_scaling_torch.py")],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 1 and not p.stdout.strip(), p.stdout
    assert "no CUDA device" in p.stderr and "--backend cpu" in p.stderr
