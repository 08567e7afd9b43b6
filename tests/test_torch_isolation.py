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
import chip_gen_profile, chip_kernel_ab, chip_smoke, chip_train_profile
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(count) >= 49  # every module of the port, generation included
    assert bad == "[]"


# the generation slice's modules, each imported alone in a fresh process
GENERATION_MODULES = [
    "deeplearning4j_tpu_torch.conf.layers_attention",
    "deeplearning4j_tpu_torch.conf.layers_extra",
    "deeplearning4j_tpu_torch.ops.attention",
    "deeplearning4j_tpu_torch.nn.decoding",
    "deeplearning4j_tpu_torch.parallel.generation",
]


# the transformer training slice's modules (the graph's feature masks, the
# flash backward and its routing, Adam state from the JAX package)
TRAINING_MODULES = [
    "deeplearning4j_tpu_torch.nn.graph",
    "deeplearning4j_tpu_torch.nn.io",
    "deeplearning4j_tpu_torch.conf.graph",
    "deeplearning4j_tpu_torch.kernels.routing",
    "deeplearning4j_tpu_torch.util.convert",
    "deeplearning4j_tpu_torch.zoo.graphs",
]


@pytest.mark.parametrize("module", GENERATION_MODULES + TRAINING_MODULES)
def test_generation_module_alone_loads_no_jax(module):
    code = (f"import sys, {module}\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'deeplearning4j_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_port_source_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|deeplearning4j_tpu)(\s|\.|$)", re.M)
    sources = list(PKG.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "chip_kernel_ab.py",
                                 "chip_train_profile.py",
                                 "chip_gen_profile.py")]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
