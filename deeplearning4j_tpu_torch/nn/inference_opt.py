"""Inference-graph optimization and post-training int8 quantization.

Counterpart of the JAX package's ``nn/inference_opt.py``.

``optimize_for_inference`` returns a serving copy with its own parameters
(a model that keeps training never changes it). For a
``MultiLayerNetwork`` it also transforms the layer list:

- **BN fold** (``fold_bn``): a ``BatchNormalization`` (not
  ``use_batch_mean_in_eval``) after a layer with ``fold_scale_shift``
  (dense, convolution) whose activation is IDENTITY folds into that
  layer's W/b (``ops.conv_fused.bn_fold_scale_shift``); the layer takes
  the BN's activation;
- **FusedConvBN1x1 unfuse** (``fold_bn``): the train-fused layer becomes a
  plain 1x1 ``ConvolutionLayer`` with the BN folded in;
- **prune** (``prune``): ``DropoutLayer`` and IDENTITY ``ActivationLayer``
  vanish and per-layer ``dropout`` fields are zeroed;
- **bf16** (``bf16=True``): the copy serves its forward in bfloat16.

A quantized artifact passes through as a copy, untouched: its transforms
ran before quantization, and a bf16 pass would corrupt its float32 scales.
A ``ComputationGraph`` gets the copy and the optional bf16 policy only.

Int8 quantization: ``calibrate`` observes per-channel activation ranges of
every quantizable layer (plain dense, 1x1 convolution) of the folded graph
over a calibration set and returns a :class:`CalibrationRecord` with a
deterministic digest; ``quantize_for_inference`` replaces those layers with
their ``conf.layers_quant`` twins, as a pure numpy (float64) function of
the float32 weights and the record, and stamps the conf with a
``QuantizationSpec``. The process-wide registry of calibration records is
the JAX package's (re-registering a restored artifact's record lands with
the model registry). Each calibration batch's range observation runs in a
``quant_calibrate`` telemetry span, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.inputs import Convolutional as _ConvType
from deeplearning4j_tpu_torch.conf.inputs import FeedForward as _FFType
from deeplearning4j_tpu_torch.conf.layers import (
    ActivationLayer,
    DenseLayer,
    DropoutLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
    _pair,
)
from deeplearning4j_tpu_torch.conf.layers_quant import (
    QuantizationSpec,
    QuantizedConv1x1Layer,
    QuantizedDenseLayer,
)
from deeplearning4j_tpu_torch.ops.conv_fused import bn_fold_scale_shift
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.telemetry import spans


def _zero_dropout(layer):
    if getattr(layer, "dropout", 0.0):
        return dataclasses.replace(layer, dropout=0.0)
    return layer


def _prunable(layer) -> bool:
    if isinstance(layer, DropoutLayer):
        return True
    return (isinstance(layer, ActivationLayer)
            and layer.activation is Activation.IDENTITY)


def _foldable_bn(layer) -> bool:
    return (isinstance(layer, BatchNormalization)
            and not layer.use_batch_mean_in_eval)


def _bn_constants(layer, params, state):
    gamma = beta = None
    if not layer.lock_gamma_beta:
        gamma, beta = params["gamma"], params["beta"]
    return bn_fold_scale_shift(gamma, beta, state["mean"], state["var"],
                               layer.eps)


def optimize_for_inference(model, fold_bn: bool = True, prune: bool = True,
                           bf16: bool = False):
    """Return a serving copy of ``model`` (the original is never mutated);
    see the module docstring for the transforms. ``fold_bn=False`` /
    ``prune=False`` turn off one pass each (the copy is still made); the
    arguments are in the JAX package's order."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(model, MultiLayerNetwork) \
            and model.conf.quantization is not None:
        return model.clone()
    if not isinstance(model, MultiLayerNetwork):
        clone = getattr(model, "clone", None)
        if clone is None:
            return model
        out = clone()
        if bf16:
            out.conf = dataclasses.replace(out.conf, compute_dtype="bfloat16")
            out._cdtype = torch.bfloat16
            out._cast_params = None
        return out

    if model.params is None:
        model.init()
    new_layers, new_params, new_state = [], {}, {}

    def append(layer, params=None, state=None):
        idx = str(len(new_layers))
        new_layers.append(layer)
        if params:
            new_params[idx] = params
        if state:
            new_state[idx] = state

    for i, layer in enumerate(model.conf.layers):
        p = model.params.get(str(i), {})
        s = model.state.get(str(i), {})
        if prune and _prunable(layer):
            continue
        if prune:
            layer = _zero_dropout(layer)
        if fold_bn and isinstance(layer, FusedConvBN1x1):
            # unfuse to a plain 1x1 conv with the BN affine baked in
            scale, shift = bn_fold_scale_shift(
                p["gamma"], p["beta"], s["mean"], s["var"], layer.eps)
            conv = ConvolutionLayer(
                name=layer.name, activation=layer.activation,
                updater=layer.updater, n_out=layer.n_out,
                kernel_size=(1, 1), stride=layer.stride,
                convolution_mode=ConvolutionMode.SAME, has_bias=True)
            dt = p["W"].dtype
            w = (p["W"].float() * scale.reshape(-1, 1, 1, 1)).to(dt)
            append(conv, {"W": w, "b": shift.to(dt)})
            continue
        prev = new_layers[-1] if new_layers else None
        if (fold_bn and _foldable_bn(layer) and prev is not None
                and getattr(prev, "fold_scale_shift", None) is not None
                and prev.activation is Activation.IDENTITY):
            scale, shift = _bn_constants(layer, p, s)
            idx = str(len(new_layers) - 1)
            folded, fparams = prev.fold_scale_shift(new_params[idx], scale,
                                                    shift)
            # the host layer takes over the BN's activation
            new_layers[-1] = dataclasses.replace(folded,
                                                 activation=layer.activation)
            new_params[idx] = fparams
            continue
        append(layer, p, s)

    conf = dataclasses.replace(
        model.conf, layers=tuple(new_layers),
        compute_dtype="bfloat16" if bf16 else model.conf.compute_dtype)
    # set_params copies: the serving copy shares no tensor with the model;
    # it never trains, so it holds no updater state
    return MultiLayerNetwork(conf, model.device).set_params(
        new_params, new_state, opt_state={})


# --------------------------------------------------------------------------
# post-training int8 quantization (calibrate -> quantize_for_inference)
# --------------------------------------------------------------------------

QUANT_SCHEMES = ("int8",)


@dataclasses.dataclass
class CalibrationRecord:
    """Per-channel activation ranges for every quantizable layer of the
    BN-folded serving graph, plus the digest that stamps the artifact."""

    scheme: str
    seed: int
    clip_percentile: float
    graph: str                # graph_signature of the folded f32 conf
    batches: int
    ranges: Dict[str, Dict[str, List[float]]]  # layer idx -> {lo, hi}
    digest: str = ""
    restored: bool = False    # re-registered from a restored artifact's spec


_CAL_LOCK = threading.Lock()
_CALIBRATIONS: Dict[str, CalibrationRecord] = {}  # keyed by digest[:8]


def register_calibration(record: CalibrationRecord) -> None:
    with _CAL_LOCK:
        _CALIBRATIONS[record.digest[:8]] = record


def register_restored(spec) -> None:
    """Re-register a calibration from a restored artifact's conf spec
    (``ModelRegistry.load``): the ranges are gone, but the scheme and
    digest mark the restored artifact's calibration as live."""
    with _CAL_LOCK:
        if spec.digest[:8] not in _CALIBRATIONS:
            _CALIBRATIONS[spec.digest[:8]] = CalibrationRecord(
                scheme=spec.scheme, seed=spec.seed,
                clip_percentile=spec.clip_percentile, graph="", batches=0,
                ranges={}, digest=spec.digest, restored=True)


def lookup_calibration(digest: str) -> Optional[CalibrationRecord]:
    """The record for a full digest or its 8-hex prefix, else None."""
    with _CAL_LOCK:
        rec = _CALIBRATIONS.get(digest[:8])
    if rec is not None and len(digest) > 8 and not digest.startswith(
            rec.digest[:len(digest)]):
        return None
    return rec


def clear_calibrations() -> None:
    """Forget every live record (a restarted process's state; tests)."""
    with _CAL_LOCK:
        _CALIBRATIONS.clear()


def _quantizable(layer, input_type) -> bool:
    """Eligible for int8 replacement on the BN-folded graph: a plain dense
    layer (not the loss head, whose score stays float32) with feed-forward
    input, or a plain 1x1 convolution (dilation 1, SAME or pad-free)."""
    if isinstance(layer, OutputLayer):
        return False
    if isinstance(layer, DenseLayer):
        return (type(layer).forward is DenseLayer.forward
                and isinstance(input_type, _FFType))
    if type(layer) is ConvolutionLayer:
        return (_pair(layer.kernel_size) == (1, 1)
                and _pair(layer.dilation) == (1, 1)
                and isinstance(input_type, _ConvType)
                and (layer.convolution_mode is ConvolutionMode.SAME
                     or _pair(layer.padding) == (0, 0)))
    return False


def _range_digest(scheme, seed, clip_percentile, graph, ranges) -> str:
    payload = json.dumps(
        {"scheme": scheme, "seed": seed, "clip_percentile": clip_percentile,
         "graph": graph, "ranges": ranges},
        sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


def _features(batch):
    """The feature array of a calibration batch: an array, a ``(features,
    labels)`` tuple or a DataSet-like."""
    if isinstance(batch, (tuple, list)):
        return batch[0]
    return getattr(batch, "features", batch)


def _host_input(feats, dtype: torch.dtype) -> np.ndarray:
    """A feature batch as the first layer sees it, on the host: uint8
    scaled to [0, 1] in the network dtype, anything else cast to it."""
    t = feats if isinstance(feats, torch.Tensor) else torch.as_tensor(
        np.asarray(feats))
    t = t.cpu()
    if t.dtype == torch.uint8:
        return (t.to(dtype) * (1.0 / 255.0)).float().numpy()
    return t.to(dtype).float().numpy()


def calibrate(model, batches, clip_percentile: float = 99.9,
              scheme: str = "int8", seed: Optional[int] = None
              ) -> CalibrationRecord:
    """Observe per-channel activation ranges for every quantizable layer.

    Runs the inference fold first (BN fold + prune), so the ranges belong
    to the graph :func:`quantize_for_inference` transforms, then feeds
    each batch forward and keeps a running min/max of the per-batch
    ``clip_percentile`` bounds per input channel (numpy on the host). The
    digest is a deterministic function of (ranges, graph, knobs): the same
    calibration set and seed give the same digest. ``batches``: feature
    arrays, ``(features, labels)`` tuples or DataSet-likes.
    """
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if not isinstance(model, MultiLayerNetwork):
        raise TypeError("calibrate() needs a MultiLayerNetwork")
    if model.conf.quantization is not None:
        raise ValueError("model is already quantized")
    if scheme not in QUANT_SCHEMES:
        raise ValueError(f"unknown quantization scheme {scheme!r} "
                         f"(supported: {QUANT_SCHEMES})")

    opt = optimize_for_inference(model)
    itypes = opt.conf.input_types()
    eligible = [i for i, lyr in enumerate(opt.conf.layers)
                if _quantizable(lyr, itypes[i])]
    if not eligible:
        raise ValueError("no quantizable layers (plain Dense / 1x1 conv) "
                         "in the folded serving graph")

    lo_hi: Dict[int, list] = {}
    n_batches = 0
    p_lo, p_hi = 100.0 - clip_percentile, clip_percentile
    for batch in batches:
        feats = _features(batch)
        acts = opt.feed_forward(feats)
        with spans.span("quant_calibrate"):
            n_batches += 1
            for i in eligible:
                x = (_host_input(feats, opt._dtype) if i == 0
                     else acts[i - 1])
                v = x.reshape(-1, x.shape[-1]).astype(np.float64)
                blo = np.percentile(v, p_lo, axis=0)
                bhi = np.percentile(v, p_hi, axis=0)
                if i not in lo_hi:
                    lo_hi[i] = [blo, bhi]
                else:
                    lo_hi[i][0] = np.minimum(lo_hi[i][0], blo)
                    lo_hi[i][1] = np.maximum(lo_hi[i][1], bhi)
    if not n_batches:
        raise ValueError("empty calibration set")

    graph = aot_cache.graph_signature(opt.conf)
    ranges = {
        str(i): {"lo": [float(np.float32(v)) for v in lo],
                 "hi": [float(np.float32(v)) for v in hi]}
        for i, (lo, hi) in sorted(lo_hi.items())
    }
    seed = int(model.conf.seed if seed is None else seed)
    rec = CalibrationRecord(
        scheme=scheme, seed=seed, clip_percentile=float(clip_percentile),
        graph=graph, batches=n_batches, ranges=ranges,
        digest=_range_digest(scheme, seed, float(clip_percentile), graph,
                             ranges))
    register_calibration(rec)
    return rec


def _quantize_linear(W, b, lo, hi):
    """The core affine fold (see ``conf.layers_quant``): returns ``(Wq int8
    [K,N], scale f32 [N], b_eff f32 [N], xs f32 [K], xz f32 [K])`` as a
    deterministic numpy function of the float32 weights + ranges."""
    W = np.asarray(W, np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    xs = np.maximum((hi - lo) / 255.0, 1e-8)
    xz = -128.0 - lo / xs
    W2 = W * xs[:, None]
    ws = np.maximum(np.abs(W2).max(axis=0) / 127.0, 1e-12)
    Wq = np.clip(np.rint(W2 / ws), -127, 127).astype(np.int8)
    corr = ws * (xz @ Wq.astype(np.float64))
    b_eff = np.asarray(b, np.float64) - corr
    return (Wq, ws.astype(np.float32), b_eff.astype(np.float32),
            xs.astype(np.float32), xz.astype(np.float32))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _kn(W: np.ndarray) -> np.ndarray:
    """A weight in the contract's ``[K, N]`` layout, C-contiguous as the
    JAX package's arrays are (so the fold's numpy products run in the
    same order, and ``Wq`` reaches the kernel row-major)."""
    return np.ascontiguousarray(W.T)


def quantize_for_inference(model, calibration: CalibrationRecord):
    """Emit the int8 serving artifact: BN-fold and prune exactly as
    :func:`optimize_for_inference`, then replace every calibrated layer
    with its ``conf.layers_quant`` twin and stamp the conf with a
    :class:`QuantizationSpec` carrying the calibration digest.

    Deterministic: the artifact is a pure function of the float32 model
    and the record (same calibration set and seed, bit-identical quantized
    params). The compute-dtype policy is dropped (the epilogues are
    float32; the hot products are int8 already).
    """
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if not isinstance(model, MultiLayerNetwork):
        raise TypeError("quantize_for_inference() needs a MultiLayerNetwork")
    if model.conf.quantization is not None:
        raise ValueError("model is already quantized")
    if calibration.scheme not in QUANT_SCHEMES:
        raise ValueError(f"unknown scheme {calibration.scheme!r}")

    opt = optimize_for_inference(model)
    graph = aot_cache.graph_signature(opt.conf)
    if calibration.graph != graph:
        raise ValueError(
            "calibration record was built for a different graph "
            f"({calibration.graph[:12]}… != {graph[:12]}…); recalibrate "
            "against this model")

    itypes = opt.conf.input_types()
    new_layers = list(opt.conf.layers)
    params = dict(opt.params)
    for key, rng in calibration.ranges.items():
        i = int(key)
        layer = new_layers[i]
        if not _quantizable(layer, itypes[i]):
            raise ValueError(f"calibrated layer {i} is not quantizable in "
                             "this graph (topology drift?)")
        p = params[key]
        if isinstance(layer, DenseLayer):
            W = _kn(_host(p["W"]))  # [nOut, nIn] -> [K, N]
            qlayer = QuantizedDenseLayer(
                name=layer.name, activation=layer.activation,
                n_out=layer.n_out)
        else:  # plain 1x1 conv, OIHW [Cout, Cin, 1, 1] -> [Cin, Cout]
            W = _kn(_host(p["W"]).reshape(p["W"].shape[0], p["W"].shape[1]))
            qlayer = QuantizedConv1x1Layer(
                name=layer.name, activation=layer.activation,
                n_out=layer.n_out, stride=_pair(layer.stride))
        b = _host(p["b"]) if "b" in p else np.zeros((W.shape[1],), np.float32)
        Wq, ws, b_eff, xs, xz = _quantize_linear(W, b, rng["lo"], rng["hi"])
        new_layers[i] = qlayer
        params[key] = {"Wq": torch.from_numpy(Wq),
                       "scale": torch.from_numpy(ws),
                       "b": torch.from_numpy(b_eff),
                       "xs": torch.from_numpy(xs),
                       "xz": torch.from_numpy(xz)}

    spec = QuantizationSpec(
        scheme=calibration.scheme, digest=calibration.digest,
        seed=calibration.seed, clip_percentile=calibration.clip_percentile)
    conf = dataclasses.replace(
        opt.conf, layers=tuple(new_layers), compute_dtype=None,
        quantization=spec)
    out = MultiLayerNetwork(conf, opt.device).set_params(params, opt.state,
                                                         opt_state={})
    register_calibration(calibration)
    return out
