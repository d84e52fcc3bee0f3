"""No module of the benchmark imports JAX or the JAX side (top-level
names compared whole: the port's name begins with the JAX package's);
the reference, the control, the work counts, the call drivers and the
generators import nothing of the port either."""

import ast
import os

import pytest

from spbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "vbcs_tpu", "bench", "bench_tools"}
NO_PORT = ("reference.py", "control.py", "peaks.py", "work", "calls", "gen")


def modules():
    for base, _, files in os.walk(harness.ROOT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_imports(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = os.path.relpath(path, harness.ROOT)
    if rel.split(os.sep)[0] in NO_PORT and not rel.startswith("tests"):
        assert "vbcs_tpu_torch" not in names


def test_forbidden_names_are_whole():
    from spbench import run

    assert set(run.FORBIDDEN) == FORBIDDEN
    assert "vbcs_tpu_torch".split(".")[0] not in FORBIDDEN
