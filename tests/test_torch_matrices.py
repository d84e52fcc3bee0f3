"""The port reads nothing of the JAX side: its copies of the JAX bench's
four generators (``vbcs_tpu_torch/tools/matrices.py``) give ``bench.py``'s
matrices bitwise at the sizes ``chip_smoke.py`` uses, and no port module,
nor ``chip_smoke.py``, imports ``jax``, ``vbcs_tpu``, ``bench`` or
``bench_tools``."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from vbcs_tpu_torch.tools import matrices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench  # noqa: E402

BANNED = {"jax", "jaxlib", "vbcs_tpu", "bench", "bench_tools"}


@pytest.mark.parametrize("name,kw", [
    ("blocky_matrix", {}),
    # the above-L2 case's generator (BLOCKY_ABOVE_L2) at scaled L
    ("blocky_matrix", dict(L=640)),
    ("blocky_matrix", dict(L=6400, seed=3)),
    ("blocky2d_matrix", {}),
    ("blocky2d_matrix", dict(K=300, u=3, w=5, d=4, band=30, seed=4)),
    ("fem_matrix", dict(k=320)),
    ("scattered_matrix", {}),
])
def test_generators_match_the_bench(name, kw):
    got, want = getattr(matrices, name)(**kw), getattr(bench, name)(**kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.format == want.format == "csc"
    for attr in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


def _sources():
    pkg = os.path.join(ROOT, "vbcs_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported(path):
    """Top-level names of the absolute imports in a source, and the string
    arguments of ``import_module``/``__import__`` calls."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            yield node.args[0].value.split(".")[0]


def test_no_port_source_imports_the_jax_side():
    found = {os.path.relpath(p, ROOT): sorted(set(_imported(p)) & BANNED)
             for p in _sources()}
    assert not {k: v for k, v in found.items() if v}, found
    assert "chip_smoke.py" in found


def test_chip_smoke_and_the_new_tools_load_nothing_of_the_jax_side():
    code = ("import sys; import chip_smoke; "
            "import vbcs_tpu_torch.probes.probe_pack, vbcs_tpu_torch.tools.weak_scaling, "
            "vbcs_tpu_torch.tools.stripe_ab, vbcs_tpu_torch.tools.spmm_ab; "
            f"bad = {sorted(BANNED)!r}; "
            "hit = [m for m in sys.modules if m.split('.')[0] in bad]; "
            "assert not hit, hit")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
