"""The port's matmul_bias_act wrapper and plain version against the JAX
package's Pallas kernel (interpret mode) and its registry reference.

On the CPU the wrapper runs its plain version (the CUDA kernel itself is
held against that plain version on the card by ``chip_smoke.py``). Inputs
are made with numpy from a seed and handed to both packages.

Tolerances: float32 — both accumulate in f32 in different orders, rtol
1e-5 (as ``tests/test_kernels.py`` holds the Pallas kernel to its
reference); bfloat16 — both round an f32 result once to bf16, agreement to
bf16 resolution (``tests/test_kernels.py``'s rtol 0.05, atol 0.1).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import kernels as jkernels
from deeplearning4j_tpu.conf.activations import Activation as JAct
from deeplearning4j_tpu.kernels import impls as jimpls
from deeplearning4j_tpu.kernels.registry import MatmulEnvelope
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import build, impls, routing

pytestmark = pytest.mark.torch

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=0.05, atol=0.1)

# (m, k, n): aligned and ragged (the ragged one has no divisor tiling but
# the whole problem, and the CUDA kernel masks every edge)
SHAPES = [(32, 24, 16), (37, 19, 11)]


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)  # [K, N]
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


def _jax_kernel(x, w, b, act, dtype):
    m, k = x.shape
    n = w.shape[1]
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return np.asarray(jimpls.matmul_bias_act(
        cast(x), cast(w), cast(b), JAct(act), (m, n, k), True), np.float32)


def _jax_reference(x, w, b, act, dtype):
    m, k = x.shape
    env = MatmulEnvelope(m=m, k=k, n=w.shape[1], dtype=dtype,
                         backend="interpret", act=act)
    ref = jkernels.REGISTRY.get("matmul_bias_act").reference(env)
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return np.asarray(ref(cast(x), cast(w), cast(b)), np.float32)


def _port(x, w, b, act, tdtype):
    # the port takes w as [N, K]
    t = lambda a: torch.tensor(a).to(tdtype)  # noqa: E731
    y = impls.matmul_bias_act(t(x), t(w.T.copy()), t(b), Activation(act))
    assert y.dtype == tdtype and y.shape == (x.shape[0], w.shape[1])
    return y.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "gelu"])
def test_matmul_bias_act_f32_matches_pallas_and_reference(shape, act):
    x, w, b = _inputs(*shape, seed=3)
    got = _port(x, w, b, act, torch.float32)
    np.testing.assert_allclose(got, _jax_kernel(x, w, b, act, "float32"),
                               **F32_TOL)
    np.testing.assert_allclose(got, _jax_reference(x, w, b, act, "float32"),
                               **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["identity", "relu", "tanh", "gelu"])
def test_matmul_bias_act_bf16_matches_pallas_and_reference(shape, act):
    x, w, b = _inputs(*shape, seed=4)
    got = _port(x, w, b, act, torch.bfloat16)
    np.testing.assert_allclose(got, _jax_kernel(x, w, b, act, "bfloat16"),
                               **BF16_TOL)
    np.testing.assert_allclose(got, _jax_reference(x, w, b, act, "bfloat16"),
                               **BF16_TOL)


def test_plain_version_accumulates_bf16_in_f32_and_rounds_once():
    x, w, b = _inputs(16, 64, 8, seed=5)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    got = impls.matmul_bias_act_plain(bf(x), bf(w.T.copy()), bf(b),
                                      Activation.IDENTITY)
    z = (bf(x).double() @ bf(w.T.copy()).double().T + bf(b).double())
    assert got.dtype == torch.bfloat16
    # one rounding of the (near-exact) f32 sum: within half a bf16 ulp
    assert torch.all((got.double() - z).abs() <= z.abs() * 2 ** -8 + 1e-6)


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    x, w, b = _inputs(8, 4, 3, seed=6)
    before = impls.matmul_bias_act.launches
    t = torch.tensor
    y = impls.matmul_bias_act(t(x), t(w.T.copy()), t(b), Activation.RELU)
    ref = impls.matmul_bias_act_plain(t(x), t(w.T.copy()), t(b),
                                      Activation.RELU)
    assert torch.equal(y, ref)
    assert impls.matmul_bias_act.launches == before
    before = impls.probe.launches
    assert torch.equal(impls.probe(torch.zeros(8, 128)), torch.ones(8, 128))
    assert impls.probe.launches == before


@pytest.mark.parametrize("case", ["softmax", "shape", "bias", "dtype",
                                  "mixed", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w, b = (torch.zeros(4, 3), torch.zeros(5, 3), torch.zeros(5))
    act = Activation.IDENTITY
    if case == "softmax":
        act = Activation.SOFTMAX
    elif case == "shape":
        w = torch.zeros(5, 2)
    elif case == "bias":
        b = torch.zeros(4)
    elif case == "dtype":
        x, w, b = x.double(), w.double(), b.double()
    elif case == "mixed":
        w = w.to(torch.bfloat16)
    else:
        x, w, b = x.to("meta"), w.to("meta"), b.to("meta")
    with pytest.raises(ValueError):
        impls.matmul_bias_act(x, w, b, act)


def test_every_elementwise_activation_has_a_kernel_id():
    names = {a.value for a in Activation} - {"softmax"}
    assert set(impls.ACTIVATION_IDS) == names
    assert sorted(impls.ACTIVATION_IDS.values()) == list(range(len(names)))
    assert not impls.elementwise(Activation.SOFTMAX)


def test_activation_ids_match_the_cuda_epilogue():
    """The ids the wrapper passes are the cases of apply_act in the CUDA
    header both GEMM epilogues include, each commented with its
    activation's name."""
    src = (build.CSRC / "activations.cuh").read_text()
    for user in ("matmul_bias_act.cu", "matmul_bias_act_int8.cu"):
        assert '#include "activations.cuh"' in (build.CSRC / user).read_text()
    body = src[src.index("apply_act(int act, float z)"):]
    body = body[:body.index("kNumActs")]
    cases = {name: int(i) for i, name in
             re.findall(r"case (\d+):\s*(?:\{\s*)?//\s*(\w+)", body)}
    assert cases == impls.ACTIVATION_IDS
    assert f"kNumActs = {len(cases)};" in src


def test_capability_on_cpu_builds_nothing():
    assert routing.capability("cpu") == "cpu"
    with pytest.raises(ValueError):
        routing.capability("meta")


def test_build_without_nvcc_names_the_missing_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has the CUDA toolkit at /usr/local/cuda")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(impls.SOURCE)


def test_library_name_follows_source_and_flags(monkeypatch):
    path = build.library_path(impls.SOURCE)
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.library_path(impls.SOURCE) != path
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
