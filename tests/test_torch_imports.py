"""The port's import boundary: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)"
                       r"(\.|\s)(?!_))", re.M)

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib"))
             or n == "repro" or n.startswith("repro."))
print(len(names), ",".join(bad) or "-", ",".join(names))
"""

# the modules of the continuous, fused and recurrent slices, named so that a
# rename or a lost module fails here and not only in the tests that use it
CONTINUOUS = ["repro_torch.serving.slo", "repro_torch.serving.kv_arena",
              "repro_torch.serving.engine", "repro_torch.serving.runtime",
              "repro_torch.kernels.flash_decode", "repro_torch.kernels.ops",
              "repro_torch.models.common", "repro_torch.models.transformer",
              "repro_torch.bridge", "repro_torch.quant.calibration",
              "repro_torch.models.mamba2", "repro_torch.models.zamba",
              "repro_torch.models.xlstm", "repro_torch.models.whisper"]


# the training slice's modules
TRAINING = ["repro_torch.train", "repro_torch.train.data",
            "repro_torch.train.optimizer", "repro_torch.train.trainer",
            "repro_torch.train.checkpoint", "repro_torch.utils.remat",
            "repro_torch.utils.tree", "repro_torch.launch.steps",
            "repro_torch.launch.train"]


def test_training_modules_import_without_jax_or_repro():
    """The training slice's modules exist, import, and load no JAX and no
    ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = ("import importlib, sys\n"
             f"for m in {TRAINING!r}:\n"
             "    importlib.import_module(m)\n"
             "print(sorted(n for n in sys.modules if n == 'jax' or "
             "n.startswith(('jax.', 'jaxlib')) or n == 'repro' or "
             "n.startswith('repro.')))\n")
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, names = out.stdout.split()
    assert int(n) >= 32, out.stdout
    assert bad == "-", f"repro_torch pulled in: {bad}"
    missing = set(CONTINUOUS) - set(names.split(","))
    assert not missing, missing


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_source_names_no_jax_and_no_repro(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.kernels import ops", "import repro",
                 "  from repro import config"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "# mentions repro.kernels in a comment"):
        assert not FORBIDDEN.search(line), line
