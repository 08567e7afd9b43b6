"""The port stands alone: importing every module of
``deeplearning4j_tpu_torch`` (and the scripts that drive it on the card)
loads neither ``jax``
nor the JAX package, and no source of the port names either."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "deeplearning4j_tpu_torch"

_CHECK = """
import importlib, pkgutil, sys
import deeplearning4j_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_data_parallel, chip_gen_profile, chip_kernel_ab
import chip_lenet_spread, chip_platform, chip_sequence, chip_smoke
import chip_train_profile, chip_zoo, chip_layers, chip_moe, chip_transfer
import chip_session
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    # every module of the port, checkpointing, the gradient check, the
    # data-parallel slice's, the serving platform's and the object
    # detection layer's, the MoE slice's and the fine-tuning slice's
    # modules included, and the session slice's
    assert int(count) >= 96
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


# the int8 serving slice's modules (MultiLayerNetwork, calibration and
# quantization, the quantized layers and their kernel's wrapper)
QUANT_MODULES = [
    "deeplearning4j_tpu_torch.conf.multilayer",
    "deeplearning4j_tpu_torch.conf.layers_quant",
    "deeplearning4j_tpu_torch.nn.multilayer",
    "deeplearning4j_tpu_torch.nn.inference_opt",
    "deeplearning4j_tpu_torch.optimize.aot_cache",
    "deeplearning4j_tpu_torch.kernels.impls",
    "deeplearning4j_tpu_torch.zoo.models",
    "deeplearning4j_tpu_torch.parallel.serving",
]


# the MultiLayerNetwork training slice's modules (datasets, normalizers,
# evaluation, listeners, the flat params vector and the serializer)
MLN_TRAINING_MODULES = [
    "deeplearning4j_tpu_torch.datasets.dataset",
    "deeplearning4j_tpu_torch.datasets.iterators",
    "deeplearning4j_tpu_torch.datasets.mnist",
    "deeplearning4j_tpu_torch.datasets.normalizers",
    "deeplearning4j_tpu_torch.eval.evaluation",
    "deeplearning4j_tpu_torch.optimize.listeners",
    "deeplearning4j_tpu_torch.util.params",
    "deeplearning4j_tpu_torch.util.serializer",
    "deeplearning4j_tpu_torch.conf.losses",
    "deeplearning4j_tpu_torch.conf.updaters",
    "deeplearning4j_tpu_torch.resilience.faults",
]


# the bf16-policy training slice's modules (checkpointing, the gradient
# check, the graph DSL's vertices and the s2d stem's layers)
BF16_TRAINING_MODULES = [
    "deeplearning4j_tpu_torch.optimize.checkpoint",
    "deeplearning4j_tpu_torch.util.gradcheck",
    "deeplearning4j_tpu_torch.conf.layers",
    "deeplearning4j_tpu_torch.conf.layers_cnn",
    "deeplearning4j_tpu_torch.resilience.retry",
]


# the kernel registry slice's modules (the registry, the tuner and its
# cache, the package that binds the cache from the environment, telemetry)
TUNING_MODULES = [
    "deeplearning4j_tpu_torch.kernels",
    "deeplearning4j_tpu_torch.kernels.registry",
    "deeplearning4j_tpu_torch.kernels.tuner",
    "deeplearning4j_tpu_torch.telemetry",
]


# the data-parallel slice's modules (the process-group mesh, the
# scheduler, compression, ZeRO, the wrapper, the masters, the launcher,
# the prefetching iterators, spans and the health switch) and the script
# whose ranks chip_smoke.py spawns
DATA_PARALLEL_MODULES = [
    "deeplearning4j_tpu_torch.parallel",
    "deeplearning4j_tpu_torch.parallel.mesh",
    "deeplearning4j_tpu_torch.parallel.compression",
    "deeplearning4j_tpu_torch.parallel.wrapper",
    "deeplearning4j_tpu_torch.parallel.cluster",
    "deeplearning4j_tpu_torch.parallel.launch",
    "deeplearning4j_tpu_torch.comms",
    "deeplearning4j_tpu_torch.comms.scheduler",
    "deeplearning4j_tpu_torch.comms.global_batch",
    "deeplearning4j_tpu_torch.sharding",
    "deeplearning4j_tpu_torch.sharding.zero",
    "deeplearning4j_tpu_torch.datasets.prefetch",
    "deeplearning4j_tpu_torch.telemetry.spans",
    "deeplearning4j_tpu_torch.telemetry.health",
    "chip_data_parallel",
]


# the sequence slice's modules (the recurrent layers, the learned-query and
# recurrent attention layers, tBPTT and rnn_time_step in both networks, the
# zoo's TextGenerationLSTM) and the script of its chip phases
SEQUENCE_MODULES = [
    "deeplearning4j_tpu_torch.conf.layers_rnn",
    "deeplearning4j_tpu_torch.conf",
    "deeplearning4j_tpu_torch.zoo",
    "chip_sequence",
]


# the serving platform slice's modules (the registry and platform,
# ParallelInference, SLOs, the findings log, the fault sites, the envelope
# cache and warmup budgets, the resilience status) and its chip phase
PLATFORM_MODULES = [
    "deeplearning4j_tpu_torch.parallel.platform",
    "deeplearning4j_tpu_torch.parallel.inference",
    "deeplearning4j_tpu_torch.telemetry.slo",
    "deeplearning4j_tpu_torch.analysis.findings",
    "deeplearning4j_tpu_torch.resilience.faults",
    "deeplearning4j_tpu_torch.optimize.aot_cache",
    "deeplearning4j_tpu_torch.resilience",
    "chip_platform",
]


# the zoo slice's new modules (object detection) and its chip phase
ZOO_MODULES = [
    "deeplearning4j_tpu_torch.conf.layers_objdetect",
    "chip_zoo",
]


# the layer DSL and MoE slice's modules (the rest of layers_extra, the MoE
# layer, expert parallelism) and its chip phases
MOE_MODULES = [
    "deeplearning4j_tpu_torch.conf.layers_moe",
    "deeplearning4j_tpu_torch.parallel.expert",
    "chip_layers",
    "chip_moe",
]


# the fine-tuning slice's modules (pretrained weights, transfer learning,
# early stopping, the health layer, its flight recorder, the export
# surfaces) and its chip phase
TRANSFER_MODULES = [
    "deeplearning4j_tpu_torch.zoo.pretrained",
    "deeplearning4j_tpu_torch.nn.transferlearning",
    "deeplearning4j_tpu_torch.earlystopping",
    "deeplearning4j_tpu_torch.telemetry.flightrec",
    "deeplearning4j_tpu_torch.telemetry.export",
    "deeplearning4j_tpu_torch.optimize.solver",
    "chip_transfer",
]


# the session slice's modules (the training session and pod snapshots,
# the training UI, the legacy solvers, the profiler) and its chip phase
SESSION_MODULES = [
    "deeplearning4j_tpu_torch.resilience.session",
    "deeplearning4j_tpu_torch.resilience.pod",
    "deeplearning4j_tpu_torch.ui",
    "deeplearning4j_tpu_torch.ui.stats",
    "deeplearning4j_tpu_torch.ui.server",
    "deeplearning4j_tpu_torch.optimize.legacy",
    "deeplearning4j_tpu_torch.profiler",
    "chip_session",
]


# a module named by two slices runs once, under its first slice's id
@pytest.mark.parametrize("module", list(dict.fromkeys(
    GENERATION_MODULES + TRAINING_MODULES + QUANT_MODULES
    + MLN_TRAINING_MODULES + BF16_TRAINING_MODULES + TUNING_MODULES
    + DATA_PARALLEL_MODULES + SEQUENCE_MODULES + PLATFORM_MODULES
    + ZOO_MODULES + MOE_MODULES + TRANSFER_MODULES + SESSION_MODULES)))
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
        ROOT / name for name in ("chip_smoke.py", "chip_data_parallel.py",
                                 "chip_kernel_ab.py",
                                 "chip_train_profile.py",
                                 "chip_gen_profile.py",
                                 "chip_lenet_spread.py",
                                 "chip_sequence.py", "chip_platform.py",
                                 "chip_zoo.py", "chip_layers.py",
                                 "chip_moe.py", "chip_transfer.py",
                                 "chip_session.py")]
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []
