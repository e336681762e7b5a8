"""The benchmark loads neither JAX nor the JAX package ``repro``; the
reference loads nothing of the program either.

Module names are compared by their whole top-level name (the part before
the first dot), so the port ``repro_torch`` is not ``repro``.  The loaded
modules are read in a fresh interpreter: a test process of the whole
suite has JAX loaded already."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded_after(code: str):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    script = (f"import sys; sys.path[:0] = [{str(ROOT)!r}, "
              f"{str(ROOT / 'src')!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _loaded_after(
        "import perfbench.harness.runner, perfbench.harness.check, "
        "perfbench.reference.bloom, "
        "perfbench.costs.k1_gemv, perfbench.costs.qmm_tc, "
        "perfbench.costs.k4, perfbench.costs.k5, perfbench.costs.k6\n"
        "from perfbench.harness import bench\n"
        "for m in bench.benchmark()['per_layer']:\n"
        "    bench.metric_reader(m['name'])")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _loaded_after("import perfbench.reference.bloom")
    assert not mods & (FORBIDDEN | {"repro_torch"})


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")
                                        if "tests" not in p.parts))
def test_no_import_statement_names_jax(path):
    names = set(_imports(BENCH / path))
    assert not names & FORBIDDEN
    assert "benchmarks" not in names and "experiments" not in names
    if path.startswith("reference/"):
        assert names <= {"__future__", "contextlib", "math", "typing",
                         "torch"}
