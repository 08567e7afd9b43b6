"""Kernel wrappers and their plain PyTorch versions.

Each wrapper checks its inputs, runs the plain version for tensors on the
CPU, and for CUDA tensors launches its hand-written kernel (built from
``csrc/`` at first use, see :mod:`kernels.build`) or raises: there is no
fallback. A wrapper counts its kernel launches in ``<wrapper>.launches`` (a
plain int, never touched by the plain path), so a run can show that its
main path went through the kernel.

``matmul_bias_act`` replaces the JAX package's Pallas kernel
``deeplearning4j_tpu/kernels/impls.py::matmul_bias_act``; ``probe`` replaces
the capability probe's ``pallas_call`` in
``deeplearning4j_tpu/kernels/routing.py::capability``. The CUDA source says
what bounds each kernel on an H100 and what its design does about it.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import build

SOURCE = "matmul_bias_act"  # csrc/matmul_bias_act.cu holds both kernels

_SIGNATURES = {
    "dl4j_matmul_bias_act": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p]),
    "dl4j_probe": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

# the epilogue's activation ids: every elementwise Activation, in the order
# of apply_act's switch in csrc/matmul_bias_act.cu (a test holds the two
# tables equal). Softmax normalizes over the row and cannot run per element.
ACTIVATION_IDS = {
    "identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3, "relu6": 4,
    "leakyrelu": 5, "elu": 6, "selu": 7, "gelu": 8, "softplus": 9,
    "softsign": 10, "swish": 11, "mish": 12, "hardsigmoid": 13,
    "hardtanh": 14, "cube": 15, "rationaltanh": 16, "rectifiedtanh": 17,
    "thresholdedrelu": 18,
}

_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
_COUNT_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    return build.load(SOURCE, _SIGNATURES)


def _count(wrapper) -> None:
    with _COUNT_LOCK:
        wrapper.launches += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on_error(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")


# --------------------------------------------------------------------------
# matmul + bias + elementwise activation (dense / 1x1-conv forward)
# --------------------------------------------------------------------------

def elementwise(act: Activation) -> bool:
    return act.value in ACTIVATION_IDS


def _check_matmul(x, w, b, act):
    if not elementwise(act):
        raise ValueError(f"matmul_bias_act needs an elementwise activation, "
                         f"got {act.value}")
    if x.ndim != 2 or w.ndim != 2 or b.ndim != 1:
        raise ValueError(f"matmul_bias_act takes x [M,K], w [N,K], b [N]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(b.shape)}")
    if w.shape[1] != x.shape[1] or b.shape[0] != w.shape[0]:
        raise ValueError(f"matmul_bias_act shape mismatch: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if not (x.dtype == w.dtype == b.dtype) or x.dtype not in _DTYPE_IDS:
        raise ValueError(f"matmul_bias_act takes float32 or bfloat16 operands "
                         f"of one dtype; got {x.dtype}, {w.dtype}, {b.dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"matmul_bias_act operands on different devices: "
                         f"{x.device}, {w.device}, {b.device}")


def matmul_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          act: Activation) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 accumulation, bias and
    activation on the f32 result, one rounding to the input dtype."""
    z = x.float() @ w.float().T + b.float()
    return act.apply(z).to(x.dtype)


def matmul_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    act: Activation) -> torch.Tensor:
    """``act(x @ w.T + b)``: x [M, K], w [N, K] (both K-contiguous — a 1x1
    OIHW conv weight viewed as [N, K] already is), b [N]; float32 or
    bfloat16, f32 accumulation, output [M, N] in the input dtype. ``act``
    is an elementwise :class:`Activation` (softmax is refused)."""
    _check_matmul(x, w, b, act)
    if x.device.type == "cpu":
        return matmul_bias_act_plain(x, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_bias_act runs on cpu or cuda, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_bias_act needs contiguous operands")
    (m, k), n = x.shape, w.shape[0]
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"matmul_bias_act dimension over 2**31: {(m, k, n)}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y  # nothing to launch
    rc = _library().dl4j_matmul_bias_act(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k,
        _DTYPE_IDS[x.dtype], ACTIVATION_IDS[act.value], x.device.index,
        _stream(x))
    _raise_on_error("matmul_bias_act", rc)
    _count(matmul_bias_act)
    return y


matmul_bias_act.launches = 0


# --------------------------------------------------------------------------
# the capability probe: x + 1
# --------------------------------------------------------------------------

def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def probe(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` over a float32 tensor: the trivial kernel whose build and
    launch :func:`kernels.routing.capability` checks."""
    if x.dtype != torch.float32:
        raise ValueError(f"probe takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"probe runs on cpu or cuda, not {x.device}")
    y = x.contiguous().clone()
    if y.numel() > _INT_MAX:
        raise ValueError("probe takes fewer than 2**31 elements")
    rc = _library().dl4j_probe(y.data_ptr(), y.numel(), y.device.index,
                               _stream(y))
    _raise_on_error("probe", rc)
    _count(probe)
    return y


probe.launches = 0
