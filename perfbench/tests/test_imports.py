"""What the benchmark imports: never JAX nor the JAX package, by top-level
name compared whole; the reference nothing of the program either."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "cdlrm_tpu"}
ROOT_HARNESSES = {"bench", "bench_torch", "bench_block_ab_torch", "bench_collectives_torch",
                  "bench_pressure_torch", "bench_scaling_torch", "bench_serving_ab_torch",
                  "bench_step_breakdown_torch", "chip_smoke"}


def top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                out.add(str(node.args[0].value).split(".")[0])
    return out


def sources(sub=""):
    base = os.path.join(HERE, sub)
    for d, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(d, name)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_jax_package(path):
    names = top_names(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if os.sep + "tests" + os.sep not in path:
        assert not names & ROOT_HARNESSES, names & ROOT_HARNESSES


def test_the_walk_compares_whole_names():
    assert "cdlrm_tpu_torch" not in FORBIDDEN
    assert top_names(os.path.join(HERE, "harness.py")) & {"perfbench"}


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_names(path)
    assert not names & (FORBIDDEN | {"cdlrm_tpu_torch", "perfbench"}), names
