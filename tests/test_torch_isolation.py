"""The port stands alone: importing every module of
``deeplearning4j_tpu_torch`` (and the scripts that drive it on the card)
loads neither ``jax``
nor the JAX package, and no source of the port names either."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "deeplearning4j_tpu_torch"

_CHECK = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_kernel_ab, chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 30
    assert bad == "[]"


def test_no_port_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|deeplearning4j_tpu)(\s|\.|$)", re.M)
    sources = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "chip_kernel_ab.py"]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
