"""Kernel wrappers and their plain PyTorch versions.

Each wrapper checks its inputs, runs the plain version for tensors on the
CPU, and for CUDA tensors launches its hand-written kernel (built from
``csrc/`` at first use, see :mod:`kernels.build`) or raises: there is no
fallback. A wrapper counts its kernel launches in ``<wrapper>.launches`` (a
plain int, never touched by the plain path), so a run can show that its
main path went through the kernel.

``matmul_bias_act`` replaces the JAX package's Pallas kernel
``deeplearning4j_tpu/kernels/impls.py::matmul_bias_act``; ``matmul_stats``
replaces ``deeplearning4j_tpu/kernels/impls.py::matmul_stats`` and
``deeplearning4j_tpu/ops/conv_fused.py::matmul_with_stats`` (one function);
``matmul_bias_act_int8`` replaces
``deeplearning4j_tpu/kernels/impls.py::matmul_bias_act_int8`` (the quantized
serving variant, forward only as in the JAX package); ``probe`` replaces the
capability probe's ``pallas_call`` in
``deeplearning4j_tpu/kernels/routing.py::capability``. The CUDA sources say
what bounds each kernel on an H100 and what its design does about it.

Gradients: ``matmul_bias_act`` and ``matmul_stats`` are
``torch.autograd.Function``s whose backward is the JAX package's
``custom_vjp`` (plain matrix products there and here, as XLA ran them), so
the kernel route trains exactly like the stock route.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.kernels import build

SOURCE = "matmul_bias_act"  # csrc/matmul_bias_act.cu: matmul_bias_act, probe
STATS_SOURCE = "matmul_stats"  # csrc/matmul_stats.cu
# the attention kernels' wrappers live in ops/attention.py
FLASH_SOURCE = "flash_attention"  # csrc/flash_attention.cu
FLASH_BWD_SOURCE = "flash_attention_bwd"  # csrc/flash_attention_bwd.cu
DECODE_SOURCE = "paged_decode_attention"  # csrc/paged_decode_attention.cu
INT8_SOURCE = "matmul_bias_act_int8"  # csrc/matmul_bias_act_int8.cu
SOURCES = (SOURCE, STATS_SOURCE, FLASH_SOURCE, FLASH_BWD_SOURCE,
           DECODE_SOURCE, INT8_SOURCE)

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
_STATS_SIGNATURES = {
    "dl4j_matmul_stats_block_m": (
        ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "dl4j_matmul_stats": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}
_INT8_SIGNATURES = {
    "dl4j_matmul_int8_plan": (
        ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "dl4j_matmul_bias_act_int8": (
        ctypes.c_int,
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}

# the epilogue's activation ids: every elementwise Activation, in the order
# of apply_act's switch in csrc/activations.cuh, which both GEMM epilogues
# share (a test holds the two tables equal). Softmax normalizes over the row and cannot run per element.
ACTIVATION_IDS = {
    "identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3, "relu6": 4,
    "leakyrelu": 5, "elu": 6, "selu": 7, "gelu": 8, "softplus": 9,
    "softsign": 10, "swish": 11, "mish": 12, "hardsigmoid": 13,
    "hardtanh": 14, "cube": 15, "rationaltanh": 16, "rectifiedtanh": 17,
    "thresholdedrelu": 18,
}

DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1
# int8 x int8 sums stay within int32: |acc| <= 128 * 128 * K < 2**31
INT8_K_MAX = (2 ** 31 - 1) // 128 ** 2
_COUNT_LOCK = threading.Lock()


def _library() -> ctypes.CDLL:
    return build.load(SOURCE, _SIGNATURES)


def _stats_library() -> ctypes.CDLL:
    return build.load(STATS_SOURCE, _STATS_SIGNATURES)


def _int8_library() -> ctypes.CDLL:
    return build.load(INT8_SOURCE, _INT8_SIGNATURES)


def count(wrapper, counter: str = "launches") -> None:
    with _COUNT_LOCK:
        setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(kernel: str, rc: int) -> None:
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
    if not (x.dtype == w.dtype == b.dtype) or x.dtype not in DTYPE_IDS:
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


def _matmul_bias_act_cuda(x, w, b, act):
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
        DTYPE_IDS[x.dtype], ACTIVATION_IDS[act.value], x.device.index,
        stream(x))
    raise_on_error("matmul_bias_act", rc)
    count(matmul_bias_act)
    return y


class _MatmulBiasAct(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward: the
    JAX package's VJP (``kernels/impls.py::_mm_bias_act_bwd``) — recompute
    ``z = x @ w.T + b`` with the stock ops, pull the cotangent through the
    activation, then ``dx = dz @ w``, ``dw = dz.T @ x`` and ``db`` summed
    in f32."""

    @staticmethod
    def forward(ctx, x, w, b, act):
        ctx.act = act
        ctx.save_for_backward(x, w, b)
        if x.device.type == "cpu":
            return matmul_bias_act_plain(x, w, b, act)
        return _matmul_bias_act_cuda(x, w, b, act)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        if ctx.act is Activation.IDENTITY:
            dz = g.to(x.dtype)
        else:
            with torch.enable_grad():
                z = (x @ w.T + b).detach().requires_grad_()
                (dz,) = torch.autograd.grad(ctx.act.apply(z), z,
                                            g.to(z.dtype))
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = (dz @ w).to(x.dtype) if need_x else None
        dw = (dz.T @ x).to(w.dtype) if need_w else None
        db = dz.float().sum(0).to(b.dtype) if need_b else None
        return dx, dw, db, None


def matmul_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    act: Activation) -> torch.Tensor:
    """``act(x @ w.T + b)``: x [M, K], w [N, K] (both K-contiguous — a 1x1
    OIHW conv weight viewed as [N, K] already is), b [N]; float32 or
    bfloat16, f32 accumulation, output [M, N] in the input dtype. ``act``
    is an elementwise :class:`Activation` (softmax is refused).
    Differentiable in x, w and b."""
    _check_matmul(x, w, b, act)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul_bias_act runs on cpu or cuda, not {x.device}")
    return _MatmulBiasAct.apply(x, w, b, act)


matmul_bias_act.launches = 0


# --------------------------------------------------------------------------
# matmul + per-column sum / sum of squares (fused 1x1 conv + BN statistics)
# --------------------------------------------------------------------------

def _check_stats(x, w):
    if x.ndim != 2 or w.ndim != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"matmul_stats takes x [M,K], w [N,K]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPE_IDS:
        raise ValueError(f"matmul_stats takes float32 or bfloat16 operands "
                         f"of one dtype; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"matmul_stats operands on different devices: "
                         f"{x.device}, {w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul_stats runs on cpu or cuda, not {x.device}")


def matmul_stats_plain(x: torch.Tensor, w: torch.Tensor):
    """The kernel's function in plain PyTorch: ``y = x @ w.T`` accumulated
    in f32 and rounded once to the input dtype, then ``sum(y)`` and
    ``sum(y*y)`` per column over the ROUNDED y, accumulated in f64 and
    returned as f32 (the reference the kernel's f32 sums are held to)."""
    y = (x.float() @ w.float().T).to(x.dtype)
    y64 = y.double()
    return y, y64.sum(0).float(), (y64 * y64).sum(0).float()


def _matmul_stats_cuda(x, w):
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_stats needs contiguous operands")
    (m, k), n = x.shape, w.shape[0]
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"matmul_stats dimension over 2**31: {(m, k, n)}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        zeros = torch.zeros((n,), dtype=torch.float32, device=x.device)
        return y, zeros, zeros.clone()
    lib = _stats_library()
    bm = lib.dl4j_matmul_stats_block_m(m, n, x.device.index)
    if bm <= 0:
        raise_on_error("matmul_stats", -bm)
    rows = -(-m // bm)
    # the sum and sum-of-squares partials, [rows, N] each, in one buffer
    parts = torch.empty((2, rows, n), dtype=torch.float32, device=x.device)
    rc = lib.dl4j_matmul_stats(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), parts.data_ptr(),
        parts.data_ptr() + rows * n * parts.element_size(), m, n, k,
        DTYPE_IDS[x.dtype], x.device.index, stream(x))
    raise_on_error("matmul_stats", rc)
    count(matmul_stats)
    # both partials reduce over their rows in one fixed-order launch, as the
    # JAX package reduces its [row blocks, 1, N] partials in XLA
    s, q = parts.sum(1)
    return y, s, q


class _MatmulStats(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU). Backward: the
    JAX package's VJP (``kernels/impls.py::_mm_stats_bwd``,
    ``ops/conv_fused.py::_bwd``): with ``s = sum(y)`` and ``q = sum(y*y)``
    the cotangent into y is ``g = gy + gs + 2*y*gq`` (f32, then the input
    dtype), and ``dx = g @ w``, ``dw = g.T @ x`` in the [N, K] layout."""

    @staticmethod
    def forward(ctx, x, w):
        if x.device.type == "cpu":
            y, s, q = matmul_stats_plain(x, w)
        else:
            y, s, q = _matmul_stats_cuda(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s, q

    @staticmethod
    def backward(ctx, gy, gs, gq):
        x, w, y = ctx.saved_tensors
        g = (gy.float() + gs.float()[None, :]
             + 2.0 * y.float() * gq.float()[None, :]).to(x.dtype)
        need_x, need_w = ctx.needs_input_grad
        dx = (g @ w).to(x.dtype) if need_x else None
        dw = (g.T @ x).to(w.dtype) if need_w else None
        return dx, dw


def matmul_stats(x: torch.Tensor, w: torch.Tensor):
    """``(y, s, q)``: ``y = x @ w.T`` [M, N] in the input dtype (f32
    accumulation), and per column ``s = sum(y)``, ``q = sum(y*y)`` [N] in
    f32 over the rounded y — the fused 1x1-conv + BN statistics in one pass
    over y. x [M, K], w [N, K] (K-contiguous: a 1x1 OIHW weight viewed as
    [N, K]); float32 or bfloat16. Differentiable in x and w."""
    _check_stats(x, w)
    return _MatmulStats.apply(x, w)


matmul_stats.launches = 0


# --------------------------------------------------------------------------
# int8 matmul + f32 scale/bias + activation (quantized dense / 1x1 conv)
# --------------------------------------------------------------------------

def _check_int8(xq, wq, scale, b, act) -> int:
    """Raises on what the kernel does not take; returns the activation's
    id. Every serving call passes here, so each property is read once."""
    act_id = ACTIVATION_IDS.get(act.value)
    if act_id is None:
        raise ValueError(f"matmul_bias_act_int8 needs an elementwise "
                         f"activation, got {act.value}")
    xs, ws = xq.shape, wq.shape
    if len(xs) != 2 or len(ws) != 2 or scale.dim() != 1 or b.dim() != 1:
        raise ValueError(
            f"matmul_bias_act_int8 takes xq [M,K], wq [K,N], scale [N], b [N]; "
            f"got {tuple(xs)}, {tuple(ws)}, {tuple(scale.shape)}, "
            f"{tuple(b.shape)}")
    n = ws[1]
    if ws[0] != xs[1] or scale.shape[0] != n or b.shape[0] != n:
        raise ValueError(
            f"matmul_bias_act_int8 shape mismatch: xq {tuple(xs)}, wq "
            f"{tuple(ws)}, scale {tuple(scale.shape)}, b {tuple(b.shape)}")
    if (xq.dtype, wq.dtype, scale.dtype, b.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32):
        raise ValueError(
            f"matmul_bias_act_int8 takes int8 xq and wq, float32 scale and b; "
            f"got {xq.dtype}, {wq.dtype}, {scale.dtype}, {b.dtype}")
    if not (xq.device == wq.device == scale.device == b.device):
        raise ValueError(f"matmul_bias_act_int8 operands on different devices: "
                         f"{xq.device}, {wq.device}, {scale.device}, {b.device}")
    if not (xq.is_cuda or xq.is_cpu):
        raise ValueError(f"matmul_bias_act_int8 runs on cpu or cuda, not "
                         f"{xq.device}")
    if xs[1] > INT8_K_MAX:
        raise ValueError(f"matmul_bias_act_int8: K = {xs[1]} could "
                         f"overflow the int32 sums (K <= {INT8_K_MAX})")
    return act_id


def matmul_bias_act_int8_plain(xq: torch.Tensor, wq: torch.Tensor,
                               scale: torch.Tensor, b: torch.Tensor,
                               act: Activation) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the exact int32 sums, then
    ``act(float32(acc) * scale + b)`` with the scale and the bias rounded
    one after the other. On the CPU the sums are an int32 product (an int8
    product would return int8 and wrap); CUDA has no integer matmul, so
    there they are a float64 product, exact since |acc| < 2**53."""
    if xq.device.type == "cpu":
        acc = xq.to(torch.int32) @ wq.to(torch.int32)
    else:
        acc = (xq.double() @ wq.double()).to(torch.int32)
    return act.apply(acc.float() * scale + b)


# (m, n, k, device) -> (the launch function, its plan): the kernel's tile
# config and cluster split depend on the shape and the card only, so each
# shape asks the library once
_INT8_PLANS: dict = {}


def _int8_plan(m: int, n: int, k: int, device: int):
    key = (m, n, k, device)
    plan = _INT8_PLANS.get(key)
    if plan is None:
        lib = _int8_library()
        code = lib.dl4j_matmul_int8_plan(m, n, k, device)
        if code < 0:
            raise_on_error("matmul_bias_act_int8", -code)
        plan = _INT8_PLANS[key] = (lib.dl4j_matmul_bias_act_int8, code)
    return plan


def _matmul_bias_act_int8_cuda(xq, wq, scale, b, act_id):
    if not (xq.is_contiguous() and wq.is_contiguous() and scale.is_contiguous()
            and b.is_contiguous()):
        raise ValueError("matmul_bias_act_int8 needs contiguous operands")
    (m, k), n = xq.shape, wq.shape[1]
    if max(m, n) > _INT_MAX:
        raise ValueError(f"matmul_bias_act_int8 dimension over 2**31: "
                         f"{(m, k, n)}")
    y = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0 or n == 0:
        return y  # nothing to launch
    device = xq.get_device()
    launch, plan = _int8_plan(m, n, k, device)
    # one launch, no workspace; the raw stream handle skips building a
    # torch.cuda.Stream object on every call
    rc = launch(xq.data_ptr(), wq.data_ptr(), scale.data_ptr(), b.data_ptr(),
                y.data_ptr(), m, n, k, act_id, plan, device,
                torch._C._cuda_getCurrentRawStream(device))
    raise_on_error("matmul_bias_act_int8", rc)
    count(matmul_bias_act_int8)
    return y


def matmul_bias_act_int8(xq: torch.Tensor, wq: torch.Tensor,
                         scale: torch.Tensor, b: torch.Tensor,
                         act: Activation) -> torch.Tensor:
    """``act(float32(int32_dot(xq, wq)) * scale + b)`` as float32 [M, N]:
    xq [M, K] int8 (already quantized), wq [K, N] int8 (the contract
    layout), scale and b [N] float32 (``nn.inference_opt``'s effective
    scale and bias). ``act`` is an elementwise :class:`Activation`. Forward
    only: quantized layers never train."""
    act_id = _check_int8(xq, wq, scale, b, act)
    if xq.is_cuda:
        return _matmul_bias_act_int8_cuda(xq, wq, scale, b, act_id)
    return matmul_bias_act_int8_plain(xq, wq, scale, b, act)


matmul_bias_act_int8.launches = 0


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
                               stream(y))
    raise_on_error("probe", rc)
    count(probe)
    return y


probe.launches = 0
