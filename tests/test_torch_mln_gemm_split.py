"""``matmul_bias_act``'s float32 arithmetic at the MultiLayerNetwork
training slice's dense shapes, on the CPU.

LeNet's dense layer is 2450 -> 500 and SimpleCNN's 9216 -> 128, deeper in K
than any ResNet-50 1x1 convolution (K <= 2048). The kernel
(``csrc/matmul_bias_act.cu`` on ``csrc/tc_gemm.cuh``) forms x . w^T on the
TF32 tensor cores through the 3xTF32 split, and the tensor cores round each
accumulation toward zero. ``emulated_stats_gemm`` of
``tests/test_torch_stats_decode_split.py`` emulates exactly that, straight
(one accumulator per output for all of K) or fresh (each 32-deep K step
summed from zero, then added with a round-to-nearest f32 add). The
kernel sums straight up to its ``kStraightMaxK`` and fresh above it; here
its choice holds ``chip_smoke.py``'s ``KERNEL_TOL["float32"]`` against
``matmul_bias_act_plain`` with room at the slice's shapes (0.013 of it at
K = 2450, 0.012 at 9216), while a straight sum uses 0.34 of it at K = 2450
and 1.34 at K = 9216, outside it (on the H100 the straight kernel reached
0.996 of the tolerance on [3]'s draws before it summed fresh there). M is
cut to 16 rows: the bias per output does not depend on M.
"""

import importlib.util
import re
from pathlib import Path

import pytest

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import impls

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

ROOT = Path(__file__).resolve().parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPLIT = _load("_stats_decode_split", ROOT / "test_torch_stats_decode_split.py")
_TC = _load("_tc_split", ROOT / "test_torch_tc_split.py")
ATOL, RTOL = _TC.GEMM_TOL
# matmul_bias_act.cu's kStraightMaxK: float32 sums K steps fresh above it
STRAIGHT_MAX_K = int(re.search(
    r"constexpr int kStraightMaxK = (\d+);",
    (ROOT.parent / "deeplearning4j_tpu_torch" / "csrc"
     / "matmul_bias_act.cu").read_text()).group(1))
# [21]'s dense shapes (chip_smoke.MLN_SHAPES) with M cut to 16
CASES = sorted({(16, k, n) for _, k, n in _SPLIT._CS.MLN_SHAPES})


def _share(case, fresh, act=Activation.RELU):
    """The largest |kernel - plain| / (atol + rtol |plain|) of the emulated
    kernel, as ``chip_smoke.py`` [3] measures it."""
    x, w, b = _TC._gemm(case)
    z = _SPLIT.emulated_stats_gemm(x, w, fresh) + b
    got = act.apply(z)
    ref = impls.matmul_bias_act_plain(x, w, b, act)
    return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())


def test_the_slice_reaches_past_the_straight_limit():
    assert STRAIGHT_MAX_K == 2048
    assert [k > STRAIGHT_MAX_K for _, k, _ in CASES] == [True, True]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_the_kernels_choice_holds_kernel_tol_with_room(case):
    assert _share(case, fresh=case[1] > STRAIGHT_MAX_K) < 0.25


def test_straight_accumulation_leaves_kernel_tol_at_k_9216():
    case = CASES[-1]
    assert case[1] == 9216
    straight, fresh = _share(case, fresh=False), _share(case, fresh=True)
    assert straight > 1.0 and fresh < 0.05 * straight, (straight, fresh)
