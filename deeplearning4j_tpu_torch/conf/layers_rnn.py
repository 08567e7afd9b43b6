"""Recurrent layers.

Reference: ``org.deeplearning4j.nn.conf.layers.{SimpleRnn, LSTM, GravesLSTM,
Bidirectional, LastTimeStep, RnnOutputLayer, RnnLossLayer}``,
``org.deeplearning4j.nn.layers.recurrent.*`` (``LSTMHelpers``,
``MaskZeroLayer``); counterpart of the JAX package's
``conf/layers_rnn.py``, with the same fields, ``@type`` tags, param keys
and param layouts, so configurations and weights carry over as they are.

Each recurrent forward is a Python loop over time on tensors (the JAX
package scans the same step with ``lax.scan``). The input projection is
hoisted out of the loop into one ``[batch * time, nIn] x [nIn, G]``
matmul; a step is one ``addmm`` of the previous hidden state with the
recurrent weights and the elementwise gate math. No library RNN is used:
cuDNN's LSTM has neither the per-step mask freeze, the peepholes nor the
IFOG gate order.

Data layout is ``[batch, time, features]``. A ``[batch, time]`` mask gates
both the carried state (a masked step passes ``h``/``c`` through) and the
emitted output (zeroed). Dense layouts are the JAX package's ``[in, out]``:
``W [nIn, G]``, ``RW [nOut, G]``, ``b [G]``. Gate order in the packed LSTM
weights is IFOG (input, forget, output, cell gate); GRU packs Z|R|H as
Keras does.

Carry contract (truncated BPTT and ``rnn_time_step``): layers with
recurrence set ``has_carry = True`` and implement ``zero_carry`` and
``forward_with_carry``; plain ``forward`` starts from the zero carry. The
networks thread carries across tBPTT segments and ``rnn_time_step`` calls
(reference ``rnnTimeStep`` / ``rnnSetPreviousState`` state maps).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import (
    BaseLayer,
    DenseLayer,
    Layer,
    promote,
)
from deeplearning4j_tpu_torch.conf.losses import ILossFunction, LossMCXENT


def _rnn_in_size(input_type) -> int:
    if isinstance(input_type, (it.Recurrent, it.FeedForward)):
        return input_type.size
    raise ValueError(f"recurrent layer needs Recurrent input, got {input_type}")


def _time_major_mask(mask, x):
    """A ``[batch, time]`` mask as ``[time, batch, 1]`` in x's dtype, or
    None."""
    if mask is None:
        return None
    return mask.to(device=x.device, dtype=x.dtype).t().unsqueeze(-1)


def _project(x, w, b):
    """``x @ w + b`` over ``[batch, time, nIn]``, time-major: ``[time,
    batch, G]`` (each step's slice contiguous for the loop)."""
    x, w, b = promote(x, w, b)
    bsz, t, f = x.shape
    xt = x.transpose(0, 1).reshape(t * bsz, f)
    return torch.addmm(b, xt, w).reshape(t, bsz, -1)


def _blend(m_t, new, old):
    """The masked step's state: ``new`` where the step is valid, ``old``
    where it is masked (``m * new + (1 - m) * old``, the JAX package's
    arithmetic)."""
    if m_t is None:
        return new
    return m_t * new + (1.0 - m_t) * old


def _emit(ys, mt):
    """The loop's per-step outputs ``[batch, H]`` stacked to ``[batch,
    time, H]``, zeroed at masked steps."""
    y = torch.stack(ys, dim=1)
    if mt is not None:
        y = y * mt.transpose(0, 1)
    return y


def reverse_sequence(x, mask=None):
    """Reverse the VALID portion of each sequence in place, keeping padding
    where it is (reference ``ReverseTimeSeriesVertex``, used by
    ``Bidirectional``). Both ALIGN_START and ALIGN_END masks: the
    contiguous valid segment ``[first..last]`` is mirrored within its own
    slots; a row with no valid step is reversed whole."""
    if mask is None:
        return x.flip(1)
    t = x.shape[1]
    m = mask.to(device=x.device).to(torch.int32)
    pos = torch.arange(t, device=x.device)[None, :]
    first = torch.argmax(m, dim=1)[:, None]
    last = (t - 1 - torch.argmax(m.flip(1), dim=1))[:, None]
    inside = (pos >= first) & (pos <= last)
    src = torch.where(inside, first + last - pos, pos)
    return torch.gather(x, 1, src[:, :, None].expand(-1, -1, x.shape[2]))


@dataclasses.dataclass
class BaseRecurrentLayer(BaseLayer):
    """Common recurrent conf (reference ``BaseRecurrentLayer``).
    ``go_backwards`` (Keras semantics): process the sequence time-reversed
    and emit outputs in processing order (reversed relative to the
    input). It applies to the whole-sequence forward; truncated BPTT
    resets such a layer every segment and ``rnn_time_step`` refuses it."""

    n_out: int = 0
    activation: Activation = Activation.TANH
    go_backwards: bool = False

    uses_mask = True
    has_carry = True

    def output_type(self, input_type):
        ts = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(size=self.n_out, timesteps=ts)

    def zero_carry(self, batch: int, dtype=torch.float32, device=None) -> dict:
        raise NotImplementedError

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        raise NotImplementedError

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        if self.go_backwards:
            x = x.flip(1)
            mask = None if mask is None else mask.flip(1)
        carry = self.zero_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.forward_with_carry(params, carry, x, mask=mask,
                                       train=train, gen=gen)
        return y, state


def _zeros(batch, n, dtype, device):
    return torch.zeros((batch, n), dtype=dtype, device=device)


@serde.register
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: ``h_t = act(x_t W + h_{t-1} RW + b)`` (reference
    ``SimpleRnn``). W: [nIn, nOut], RW: [nOut, nOut], b: [nOut]."""

    def init(self, gen, input_type, dtype=torch.float32):
        n_in = _rnn_in_size(input_type)
        h = self.n_out
        wi = self.weight_init
        return {
            "W": wi.init(gen, (n_in, h), n_in, h, dtype, self.distribution),
            "RW": wi.init(gen, (h, h), h, h, dtype, self.distribution),
            "b": torch.full((h,), self.bias_init, dtype=dtype),
        }

    def param_order(self):
        return ["W", "RW", "b"]

    def regularized_param_keys(self):
        # recurrent weights are weights for L1/L2 (biases excluded)
        return ["W", "RW"]

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": _zeros(batch, self.n_out, dtype, device)}

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        x = self._dropout_input(x, train, gen)
        xw = _project(x, params["W"], params["b"])
        rw = params["RW"].to(xw.dtype)
        mt = _time_major_mask(mask, xw)
        h = carry["h"].to(xw.dtype)
        ys = []
        for t in range(xw.shape[0]):
            h_new = self.activation.apply(torch.addmm(xw[t], h, rw))
            m_t = None if mt is None else mt[t]
            h = _blend(m_t, h_new, h)
            ys.append(h_new)
        return _emit(ys, mt), {"h": h}


@serde.register
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes (reference ``LSTM`` /
    ``LSTMHelpers#activateHelper``). Packed IFOG weights W: [nIn, 4 nOut],
    RW: [nOut, 4 nOut], b: [4 nOut]; the forget-gate bias starts at
    ``forget_gate_bias_init`` (reference ``forgetGateBiasInit``, 1.0)."""

    forget_gate_bias_init: float = 1.0
    gate_activation: Activation = Activation.SIGMOID

    def init(self, gen, input_type, dtype=torch.float32):
        n_in = _rnn_in_size(input_type)
        h = self.n_out
        wi = self.weight_init
        b = torch.full((4 * h,), self.bias_init, dtype=dtype)
        b[h:2 * h] = self.forget_gate_bias_init
        return {
            "W": wi.init(gen, (n_in, 4 * h), n_in, h, dtype,
                         self.distribution),
            "RW": wi.init(gen, (h, 4 * h), h, h, dtype, self.distribution),
            "b": b,
        }

    def param_order(self):
        return ["W", "RW", "b"]

    def regularized_param_keys(self):
        return ["W", "RW"]

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": _zeros(batch, self.n_out, dtype, device),
                "c": _zeros(batch, self.n_out, dtype, device)}

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        """The LSTM loop. Peepholes (GravesLSTM) are the optional pI/pF/pO
        params: the i and f gates peek at c_{t-1}, the o gate at c_t."""
        x = self._dropout_input(x, train, gen)
        n = self.n_out
        xw = _project(x, params["W"], params["b"])
        dt = xw.dtype
        rw = params["RW"].to(dt)
        p_i, p_f, p_o = (params[k].to(dt) if k in params else None
                         for k in ("pI", "pF", "pO"))
        gate, act = self.gate_activation.apply, self.activation.apply
        mt = _time_major_mask(mask, xw)
        h, c = carry["h"].to(dt), carry["c"].to(dt)
        ys = []
        for t in range(xw.shape[0]):
            z = torch.addmm(xw[t], h, rw)
            if p_i is None:
                i, f, o = gate(z[:, :3 * n]).split(n, dim=1)
            else:
                i = gate(z[:, :n] + p_i * c)
                f = gate(z[:, n:2 * n] + p_f * c)
            g = act(z[:, 3 * n:])
            c_new = f * c + i * g
            if p_i is not None:
                o = gate(z[:, 2 * n:3 * n] + p_o * c_new)
            h_new = o * act(c_new)
            m_t = None if mt is None else mt[t]
            c = _blend(m_t, c_new, c)
            h = _blend(m_t, h_new, h)
            ys.append(h_new)
        return _emit(ys, mt), {"h": h, "c": c}


@serde.register
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peepholes (reference ``GravesLSTM``, Graves 2013): the
    input and forget gates peek at c_{t-1}, the output gate at c_t. The
    peephole weights are separate vectors pI/pF/pO [nOut], as in the JAX
    package (the reference packs them into extra recurrent columns)."""

    def init(self, gen, input_type, dtype=torch.float32):
        params = super().init(gen, input_type, dtype)
        for k in ("pI", "pF", "pO"):
            params[k] = torch.zeros((self.n_out,), dtype=dtype)
        return params

    def param_order(self):
        return ["W", "RW", "b", "pI", "pF", "pO"]

    def regularized_param_keys(self):
        # the reference regularizes its packed peepholes as weights
        return ["W", "RW", "pI", "pF", "pO"]


@serde.register
@dataclasses.dataclass
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit (Cho et al. 2014, Keras-compatible). Packed
    Z|R|H weights W [nIn, 3 nOut], RW [nOut, 3 nOut], b [3 nOut], plus the
    recurrent bias rb [3 nOut] when ``reset_after`` (the Keras 2 variant:
    the reset gate applies after the recurrent matmul)."""

    gate_activation: Activation = Activation.SIGMOID
    reset_after: bool = False

    def init(self, gen, input_type, dtype=torch.float32):
        n_in = _rnn_in_size(input_type)
        h = self.n_out
        wi = self.weight_init
        p = {
            "W": wi.init(gen, (n_in, 3 * h), n_in, h, dtype,
                         self.distribution),
            "RW": wi.init(gen, (h, 3 * h), h, h, dtype, self.distribution),
            "b": torch.full((3 * h,), self.bias_init, dtype=dtype),
        }
        if self.reset_after:
            p["rb"] = torch.zeros((3 * h,), dtype=dtype)
        return p

    def param_order(self):
        return (["W", "RW", "b", "rb"] if self.reset_after
                else ["W", "RW", "b"])

    def regularized_param_keys(self):
        return ["W", "RW"]

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": _zeros(batch, self.n_out, dtype, device)}

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        x = self._dropout_input(x, train, gen)
        n = self.n_out
        xw = _project(x, params["W"], params["b"])
        dt = xw.dtype
        rw = params["RW"].to(dt)
        rb = params["rb"].to(dt) if self.reset_after else None
        gate, act = self.gate_activation.apply, self.activation.apply
        mt = _time_major_mask(mask, xw)
        h = carry["h"].to(dt)
        ys = []
        for t in range(xw.shape[0]):
            xw_t = xw[t]
            if self.reset_after:
                hr = torch.addmm(rb, h, rw)
                z = gate(xw_t[:, :n] + hr[:, :n])
                r = gate(xw_t[:, n:2 * n] + hr[:, n:2 * n])
                hh = act(xw_t[:, 2 * n:] + r * hr[:, 2 * n:])
            else:
                hr = h @ rw[:, :2 * n]
                z = gate(xw_t[:, :n] + hr[:, :n])
                r = gate(xw_t[:, n:2 * n] + hr[:, n:2 * n])
                hh = act(xw_t[:, 2 * n:] + (r * h) @ rw[:, 2 * n:])
            h_new = z * h + (1.0 - z) * hh
            m_t = None if mt is None else mt[t]
            h = _blend(m_t, h_new, h)
            ys.append(h_new)
        return _emit(ys, mt), {"h": h}


@serde.register_enum
class BidirectionalMode(enum.Enum):
    """Reference ``Bidirectional.Mode``."""

    ADD = "ADD"
    MUL = "MUL"
    AVERAGE = "AVERAGE"
    CONCAT = "CONCAT"


class _Delegating:
    """Training hyperparameters a wrapper reads off its wrapped layer (the
    solver reads them off the top-level conf; reference: the wrapper
    extends the wrapped conf)."""

    @property
    def regularization(self):
        return getattr(self.layer, "regularization", ())

    @property
    def regularization_bias(self):
        return getattr(self.layer, "regularization_bias", ())

    @property
    def updater(self):
        return getattr(self.layer, "updater", None)

    @property
    def gradient_normalization(self):
        return getattr(self.layer, "gradient_normalization", None)

    @property
    def gradient_normalization_threshold(self):
        return getattr(self.layer, "gradient_normalization_threshold", 1.0)


@serde.register
@dataclasses.dataclass
class Bidirectional(_Delegating, Layer):
    """Runs a recurrent layer forward and (mask-aware) time-reversed and
    combines the two per ``mode`` (reference ``Bidirectional``). Param keys
    take the reference's ``f``/``b`` prefixes (fW, bW, ...). Streaming is
    undefined for the backward direction, so ``has_carry`` is False: tBPTT
    runs it per segment and ``rnn_time_step`` refuses it."""

    layer: Optional[BaseRecurrentLayer] = None
    mode: BidirectionalMode = BidirectionalMode.CONCAT

    uses_mask = True
    has_carry = False

    def output_type(self, input_type):
        out = self.layer.output_type(input_type)
        if self.mode is BidirectionalMode.CONCAT:
            return it.Recurrent(size=2 * out.size, timesteps=out.timesteps)
        return out

    def init(self, gen, input_type, dtype=torch.float32):
        fwd = self.layer.init(gen, input_type, dtype)
        bwd = self.layer.init(gen, input_type, dtype)
        out = {f"f{k}": v for k, v in fwd.items()}
        out.update({f"b{k}": v for k, v in bwd.items()})
        return out

    def param_order(self):
        inner = self.layer.param_order()
        return [f"f{k}" for k in inner] + [f"b{k}" for k in inner]

    def regularized_param_keys(self):
        inner = self.layer.regularized_param_keys()
        return [f"f{k}" for k in inner] + [f"b{k}" for k in inner]

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        fwd_p = {k[1:]: v for k, v in params.items() if k.startswith("f")}
        bwd_p = {k[1:]: v for k, v in params.items() if k.startswith("b")}
        carry = self.layer.zero_carry(x.shape[0], x.dtype, x.device)
        run = self.layer.forward_with_carry
        if getattr(self.layer, "go_backwards", False):
            # Keras Bidirectional over a go_backwards layer: the forward
            # copy reads the sequence reversed and emits in processing
            # order; the backward copy is the plain-order clone, whose
            # output the wrapper reverses as always
            y_f, _ = run(fwd_p, carry, reverse_sequence(x, mask), mask=mask,
                         train=train, gen=gen)
            y_b, _ = run(bwd_p, carry, x, mask=mask, train=train, gen=gen)
        else:
            y_f, _ = run(fwd_p, carry, x, mask=mask, train=train, gen=gen)
            y_b, _ = run(bwd_p, carry, reverse_sequence(x, mask), mask=mask,
                         train=train, gen=gen)
        y_b = reverse_sequence(y_b, mask)
        if self.mode is BidirectionalMode.ADD:
            return y_f + y_b, state
        if self.mode is BidirectionalMode.MUL:
            return y_f * y_b, state
        if self.mode is BidirectionalMode.AVERAGE:
            return 0.5 * (y_f + y_b), state
        return torch.cat([y_f, y_b], dim=-1), state


def _last_valid_index(mask, total_t):
    """Index of the LAST nonzero mask step per row, for ALIGN_START and
    ALIGN_END padding alike (a row with no valid step gives total_t - 1)."""
    return total_t - 1 - torch.argmax(mask.flip(1), dim=1)


@dataclasses.dataclass
class _RecurrentWrapper(_Delegating, Layer):
    """Shared delegation for wrappers around a recurrent layer: params,
    state, training hyperparameters and the carry protocol all forward to
    the wrapped layer, so tBPTT and ``rnn_time_step`` thread state straight
    through."""

    layer: Optional[Layer] = None

    uses_mask = True

    def __post_init__(self):
        self.has_carry = getattr(self.layer, "has_carry", False)

    def output_type(self, input_type):
        return self.layer.output_type(input_type)

    def init(self, gen, input_type, dtype=torch.float32):
        return self.layer.init(gen, input_type, dtype)

    def init_state(self, input_type, dtype=torch.float32):
        return self.layer.init_state(input_type, dtype)

    def param_order(self):
        return self.layer.param_order()

    def regularized_param_keys(self):
        return self.layer.regularized_param_keys()

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return self.layer.zero_carry(batch, dtype, device)

    def _run_inner(self, params, carry, x, mask, train, gen):
        """The wrapped layer's output and final carry (None for a layer
        without one)."""
        kw = {"mask": mask} if getattr(self.layer, "uses_mask", False) else {}
        if self.has_carry:
            if carry is None:
                carry = self.layer.zero_carry(x.shape[0], x.dtype, x.device)
            return self.layer.forward_with_carry(params, carry, x,
                                                 train=train, gen=gen, **kw)
        y, _ = self.layer.forward(params, {}, x, train=train, gen=gen, **kw)
        return y, None


@serde.register
@dataclasses.dataclass
class LastTimeStep(_RecurrentWrapper):
    """Emits only the wrapped layer's output at the LAST VALID step, as
    ``[batch, nOut]`` (reference ``LastTimeStep``), for ALIGN_START and
    ALIGN_END masks."""

    def output_type(self, input_type):
        return it.FeedForward(size=self.layer.output_type(input_type).size)

    def _select_last(self, y, mask):
        if mask is None:
            return y[:, -1, :]
        idx = _last_valid_index(mask.to(y.device), y.shape[1])
        return y[torch.arange(y.shape[0], device=y.device), idx]

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        y, _ = self._run_inner(params, None, x, mask, train, gen)
        return self._select_last(y, mask), state

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        y, carry_out = self._run_inner(params, carry, x, mask, train, gen)
        return self._select_last(y, mask), carry_out


@serde.register
@dataclasses.dataclass
class MaskZeroLayer(_RecurrentWrapper):
    """Zeroes the wrapped layer's output at steps whose input is the
    sentinel ``mask_value`` in every feature, and at masked steps
    (reference ``MaskZeroLayer``); those steps also hold the carry."""

    mask_value: float = 0.0

    def _step_mask(self, x, mask):
        step = (x != self.mask_value).any(dim=-1).to(x.dtype)
        if mask is not None:
            step = step * mask.to(device=x.device, dtype=x.dtype)
        return step

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        step = self._step_mask(x, mask)
        y, _ = self._run_inner(params, None, x, step, train, gen)
        return y * step[:, :, None], state

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        step = self._step_mask(x, mask)
        y, carry_out = self._run_inner(params, carry, x, step, train, gen)
        return y * step[:, :, None], carry_out


@serde.register
@dataclasses.dataclass
class RnnOutputLayer(DenseLayer):
    """Time-distributed dense + per-step loss (reference
    ``RnnOutputLayer``): ``[batch, time, nIn] -> [batch, time, nOut]``; the
    score averages over the valid steps of the labels mask. W is the
    port's dense layout, ``[nOut, nIn]``."""

    loss_fn: ILossFunction = dataclasses.field(default_factory=LossMCXENT)
    activation: Activation = Activation.SOFTMAX

    def output_type(self, input_type):
        ts = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(size=self.n_out, timesteps=ts)

    def score(self, params, x, labels, mask=None):
        z = self.pre_output(params, x)
        return self.loss_fn.score(labels, z, self.activation, mask)


@serde.register
@dataclasses.dataclass
class RnnLossLayer(Layer):
    """Parameter-free per-step loss head (reference ``RnnLossLayer``)."""

    loss_fn: ILossFunction = dataclasses.field(default_factory=LossMCXENT)
    activation: Activation = Activation.SOFTMAX

    def forward(self, params, state, x, train=False, gen=None):
        return self.activation.apply(x), state

    def score(self, params, x, labels, mask=None):
        return self.loss_fn.score(labels, x, self.activation, mask)

    def regularized_param_keys(self):
        return []
