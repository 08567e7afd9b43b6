"""Tensor parallelism over the mesh ``model`` axis.

Counterpart of the JAX package's ``parallel/tensor.py``. The JAX package
writes the math once, annotates shardings and lets GSPMD insert the
collectives; the port runs one process per rank, so this module writes
those collectives once, as Megatron's operators over the ``model``
subgroup (each a ``torch.autograd.Function``):

- :func:`copy_to` — into the model region: the identity forward, an
  all-reduce of the cotangent backward (the partial input gradients of a
  column-parallel product);
- :func:`reduce_from` — out of it: an all-reduce forward (the partial
  sums of a row-parallel product), the identity backward;
- :func:`gather_from` — the split features of every rank concatenated on
  one dim forward, this rank's slice of the cotangent backward;
- :func:`scatter_to` — this rank's slice forward, the cotangents of every
  rank gathered backward;
- :func:`gather_param` — a sharded parameter whole before use (the
  general route): gathered forward; backward, its slice of the gradient
  every rank computed alike (model and sequence axes) or of the gradients'
  sum (the data axis, whose ranks see other rows).

The Megatron block (:func:`tp_block_init` / :func:`tp_block_apply` /
:func:`tp_train_step`): QKV and FFN-in column-parallel, attention-out and
FFN-out row-parallel, heads on the column-parallel features.

``ParallelWrapper(partition_rules=...)`` trains a network under a
``ShardingPlan``: :func:`plan_splits` reads how each layer's leaves are cut
(:class:`LayerSplit`) and the wrapper sets a :class:`ModelAxis` on the
network for the step. The networks' forwards hand each split layer to it:
dense, convolution, sequence-embedding and self-attention layers whose
split the layer can compute on compute only their shard (their
``forward_sharded``), a column-parallel layer followed only by a
row-parallel one leaves its output split for it, and every other sharded
leaf takes the general route. Both give the unsharded step's math.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.comms import scheduler
from deeplearning4j_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

# --------------------------------------------------------------------------
# the Megatron operators
# --------------------------------------------------------------------------


def _gather_dim(x: torch.Tensor, group, size: int, dim: int):
    """Every rank's ``x`` concatenated on ``dim`` (rank order)."""
    if size == 1:
        return x
    local = x.contiguous()
    out = local.new_empty((size,) + tuple(local.shape))
    scheduler.all_gather(out, local.view(-1), group)
    shape = list(local.shape)
    shape[dim] *= size
    full = out.movedim(0, dim).reshape(shape)
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last) \
            and not x.is_contiguous():
        full = full.contiguous(memory_format=torch.channels_last)
    return full


def _slice_dim(x: torch.Tensor, size: int, rank: int, dim: int):
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        scheduler.all_reduce(g, ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        scheduler.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.size, ctx.rank, ctx.dim = size, rank, dim
        return _gather_dim(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return (_slice_dim(g, ctx.size, ctx.rank, ctx.dim).contiguous(),
                None, None, None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _slice_dim(x, size, rank, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather_dim(g, ctx.group, ctx.size, ctx.dim),
                None, None, None, None)


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim, summed):
        ctx.group, ctx.size, ctx.rank, ctx.dim = group, size, rank, dim
        ctx.summed = summed
        return _gather_dim(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = g.contiguous().clone()
            scheduler.all_reduce(g, ctx.group)
        return (_slice_dim(g, ctx.size, ctx.rank, ctx.dim).contiguous(),
                None, None, None, None, None)


def copy_to(x, group):
    """Into the model region (backward: all-reduce)."""
    return _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Out of the model region (forward: all-reduce)."""
    return _ReduceFrom.apply(x, group)


def gather_from(x, group, size: int, rank: int, dim: int = -1):
    """The split features of every rank (backward: this rank's slice)."""
    return _GatherFrom.apply(x, group, size, rank, dim % x.ndim)


def scatter_to(x, group, size: int, rank: int, dim: int = -1):
    """This rank's slice (backward: every rank's cotangent gathered)."""
    return _ScatterTo.apply(x, group, size, rank, dim % x.ndim)


def gather_param(x, group, size: int, rank: int, dim: int,
                 summed: bool = False):
    """A sharded parameter whole (backward: this rank's slice of the
    gradient; ``summed``: of its sum over the group)."""
    return _GatherParam.apply(x, group, size, rank, dim, summed)


# --------------------------------------------------------------------------
# a network's splits under a plan
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LayerSplit:
    """How one layer's leaves are cut. ``dims``: {param key: ((storage
    dim, mesh axes), ...)} of its sharded leaves; ``kind``: the forward
    that runs it ("column" / "row" dense, "conv" on output channels,
    "embed_cols", "attention", or "general": every sharded
    leaf gathered first); ``split_in``: its input arrives split on the
    last dim (a column-parallel producer kept it so); ``keep_out``: it
    leaves its output split for a row-parallel consumer."""

    dims: dict
    kind: str = "general"
    split_in: bool = False
    keep_out: bool = False


def _model_only(entries, axis=MODEL_AXIS) -> bool:
    return len(entries) == 1 and entries[0][1] == (axis,)


def _leaf_dims(spec, mesh) -> tuple:
    """((dim, axes), ...) of a storage spec's dims that ``mesh`` cuts (an
    axis of size 1 cuts nothing)."""
    out = []
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = tuple(a for a in (e if isinstance(e, (tuple, list)) else (e,))
                     if int(mesh.shape[a]) > 1)
        if axes:
            out.append((d, axes))
    return tuple(out)


def _pointwise(act) -> bool:
    from deeplearning4j_tpu_torch.conf.activations import Activation

    return act is not Activation.SOFTMAX


def _classify(layer, dims: dict, model: int) -> str:
    """The forward a split layer runs (see :class:`LayerSplit`)."""
    from deeplearning4j_tpu_torch.conf.layers import (
        DenseLayer,
        EmbeddingSequenceLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_attention import (
        SelfAttentionLayer,
    )
    from deeplearning4j_tpu_torch.conf.layers_cnn import ConvolutionLayer

    def at(key, dim):
        e = dims.get(key)
        return e is not None and _model_only(e) and e[0][0] == dim

    def bias_ok(key, sharded_ok=True):
        return key not in dims or (sharded_ok and at(key, 0))

    extra = set(dims)
    if isinstance(layer, DenseLayer) and (
            type(layer).forward is DenseLayer.forward
            and type(layer).pre_output is DenseLayer.pre_output):
        extra -= {"W", "b"}
        if not extra and at("W", 0) and bias_ok("b"):
            return "column"
        if not extra and at("W", 1) and bias_ok("b", False):
            return "row"
    elif isinstance(layer, ConvolutionLayer) \
            and type(layer).forward is ConvolutionLayer.forward:
        extra -= {"W", "b"}
        if not extra and at("W", 0) and bias_ok("b"):
            return "conv"
    elif isinstance(layer, EmbeddingSequenceLayer) \
            and type(layer).forward is EmbeddingSequenceLayer.forward:
        if set(dims) == {"W"} and at("W", 1):
            return "embed_cols"
    elif isinstance(layer, SelfAttentionLayer) \
            and type(layer).forward is SelfAttentionLayer.forward \
            and layer.project_input:
        cols = all(at(k, 0) for k in ("Wq", "Wk", "Wv"))
        extra -= {"Wq", "Wk", "Wv", "Wo", "bq", "bk", "bv"}
        if cols and at("Wo", 1) and not extra \
                and all(bias_ok(k) for k in ("bq", "bk", "bv")) \
                and layer.n_heads % model == 0:
            return "attention"
    return "general"


def plan_splits(net, storage_specs, mesh) -> Dict[str, LayerSplit]:
    """{params key: :class:`LayerSplit`} of every layer with a sharded
    leaf under ``storage_specs`` (the plan's specs on the port's storage),
    with a column-parallel layer whose only consumer is a row-parallel one
    marked to leave its output split for it."""
    from deeplearning4j_tpu_torch.sharding.rules import layer_confs

    layers = layer_confs(net.conf)
    model = int(mesh.shape[MODEL_AXIS])
    splits = {}
    for k, specs in storage_specs.items():
        dims = {pk: _leaf_dims(s, mesh) for pk, s in specs.items()}
        dims = {pk: d for pk, d in dims.items() if d}
        if not dims:
            continue
        splits[k] = LayerSplit(dims, _classify(layers[k], dims, model))
    for a, b in _chains(net):
        sa, sb = splits.get(a), splits.get(b)
        la, lb = layers[a], layers[b]
        if (sa is not None and sb is not None and sa.kind == "column"
                and sb.kind == "row" and _pointwise(la.activation)
                and not getattr(lb, "dropout", 0.0)
                and not hasattr(la, "score")):
            sa.keep_out = sb.split_in = True
    return splits


def _chains(net):
    """(producer, consumer) key pairs where the consumer reads the
    producer's output as it is and nothing else reads it."""
    conf = net.conf
    if hasattr(conf, "vertex_map"):
        vmap = conf.vertex_map()
        readers = {}
        for name, spec in vmap.items():
            for src in spec.inputs:
                readers.setdefault(src, []).append(name)
        outs = set(conf.network_outputs)
        for name, spec in vmap.items():
            if len(spec.inputs) != 1 or getattr(
                    spec.vertex, "preprocessor", None) is not None:
                continue
            src = spec.inputs[0]
            if src in vmap and readers.get(src) == [name] \
                    and src not in outs:
                yield src, name
        return
    for i in range(len(conf.layers) - 1):
        yield str(i), str(i + 1)


class ModelAxis:
    """The model axis of one training step: this rank's index and the
    subgroup, the network's :class:`LayerSplit` s, and whether the network
    routes its layers to the kernels. The networks' forwards hand every
    split layer here (``net._model_axis``)."""

    def __init__(self, mesh, splits: Dict[str, LayerSplit],
                 use_kernels: bool = False):
        self.mesh = mesh
        self.group = mesh.axis_group(MODEL_AXIS)
        self.size = int(mesh.shape[MODEL_AXIS])
        self.rank = mesh.index(MODEL_AXIS)
        self.splits = splits
        self.use_kernels = bool(use_kernels)

    # --- the general route ---------------------------------------------------
    def gathered(self, key: str, params: dict) -> dict:
        """``params`` with every sharded leaf whole (the general route)."""
        split = self.splits[key]
        out = dict(params)
        for pk, dims in split.dims.items():
            t = out[pk]
            for dim, axes in reversed(dims):
                for ax in reversed(axes):
                    size = int(self.mesh.shape[ax])
                    t = gather_param(t, self.mesh.axis_group(ax), size,
                                     self.mesh.index(ax), dim,
                                     summed=ax == DATA_AXIS)
            out[pk] = t
        return out

    def direct(self, key: str) -> bool:
        """Whether layer ``key`` computes its own shard."""
        return self.splits[key].kind != "general"

    # --- dispatch ------------------------------------------------------------
    def layer_forward(self, layer, key, params, state, x, train, gen, kw):
        return layer.forward_sharded(params, state, x, self.splits[key],
                                     self, train=train, gen=gen, **kw)

    def vertex_forward(self, vertex, key, params, state, xs, train, gen,
                       mask=None):
        x, kw = vertex._layer_input(xs, mask)
        return self.layer_forward(vertex.layer, key, params, state, x, train,
                                  gen, kw)

    def layer_score(self, layer, key, params, x, labels, mask=None):
        """An output layer's loss on its pre-activations, whole."""
        if not self.direct(key):
            return layer.score(self.gathered(key, params), x, labels, mask)
        z = layer.pre_output_sharded(params, x, self.splits[key], self)
        return layer.loss_fn.score(labels, z, layer.activation, mask)

    def vertex_score(self, vertex, key, params, x, labels, mask=None):
        if vertex.preprocessor is not None:
            x, _ = vertex.preprocessor.forward({}, {}, x)
        return self.layer_score(vertex.layer, key, params, x, labels, mask)

    # --- pieces the layers' sharded forwards share ---------------------------
    def into(self, x):
        return copy_to(x, self.group)

    def reduce(self, x):
        return reduce_from(x, self.group)

    def gather(self, x, dim: int = -1):
        return gather_from(x, self.group, self.size, self.rank, dim)

    def scatter(self, x, dim: int = -1):
        return scatter_to(x, self.group, self.size, self.rank, dim)

    def local_bias(self, split, params, key: str):
        """This rank's columns of a column-parallel layer's bias: its own
        shard, or its slice of the replicated bias (whose gradient then
        sums over the model ranks)."""
        b = params.get(key)
        if b is None or key in split.dims:
            return b
        return _slice_dim(self.into(b), self.size, self.rank, 0)


# --------------------------------------------------------------------------
# the Megatron block
# --------------------------------------------------------------------------


def tp_block_init(seed: int, d_model: int, n_heads: int, d_ff: int,
                  dtype=torch.float32) -> dict:
    """Pre-LN attention + FFN residual block params (one logical copy in
    the JAX package's ``[in, out]`` layouts; cut with
    :func:`shard_tp_params`). ``n_heads`` validates the head split here so
    the apply-time reshape can't fail cryptically. Weights are drawn from
    a ``torch.Generator`` seeded with ``seed``."""
    if d_model % n_heads != 0:
        raise ValueError(
            f"d_model={d_model} must be divisible by n_heads={n_heads}")
    gen = torch.Generator().manual_seed(int(seed))
    s_attn = 1.0 / np.sqrt(d_model)
    s_ff = 1.0 / np.sqrt(d_ff)

    def normal(shape, s):
        return (s * torch.randn(shape, generator=gen)).to(dtype)

    return {
        "ln1_g": torch.ones((d_model,), dtype=dtype),
        "ln1_b": torch.zeros((d_model,), dtype=dtype),
        "w_qkv": normal((d_model, 3 * d_model), s_attn),
        "w_out": normal((d_model, d_model), s_attn),
        "ln2_g": torch.ones((d_model,), dtype=dtype),
        "ln2_b": torch.zeros((d_model,), dtype=dtype),
        "w_ff1": normal((d_model, d_ff), s_attn),
        "b_ff1": torch.zeros((d_ff,), dtype=dtype),
        "w_ff2": normal((d_ff, d_model), s_ff),
    }


def tp_block_shardings(mesh=None) -> dict:
    """The spec of each param: column-parallel weights shard their OUTPUT
    dim over ``model``, row-parallel weights their INPUT dim; layernorm
    params replicate (the JAX package's table; ``mesh`` is accepted for
    its signature)."""
    from deeplearning4j_tpu_torch.sharding.rules import P

    return {
        "ln1_g": P(), "ln1_b": P(),
        "w_qkv": P(None, MODEL_AXIS),     # column-parallel
        "w_out": P(MODEL_AXIS, None),     # row-parallel
        "ln2_g": P(), "ln2_b": P(),
        "w_ff1": P(None, MODEL_AXIS),     # column-parallel
        "b_ff1": P(MODEL_AXIS),
        "w_ff2": P(MODEL_AXIS, None),     # row-parallel
    }


def _qkv_columns(d: int, size: int, rank: int) -> torch.Tensor:
    """The columns of ``w_qkv`` a model rank holds: its share of each of
    the q, k and v thirds (whole heads, as Megatron cuts the fused
    projection)."""
    n = d // size
    return torch.cat([torch.arange(j * d + rank * n, j * d + (rank + 1) * n)
                      for j in range(3)])


def shard_tp_params(params: dict, mesh) -> dict:
    """This rank's slice of each param per :func:`tp_block_shardings`
    (``w_qkv`` cut third by third, see :func:`_qkv_columns`)."""
    size, rank = int(mesh.shape[MODEL_AXIS]), mesh.index(MODEL_AXIS)
    d = params["w_out"].shape[1]
    out = {}
    for k, v in params.items():
        if k == "w_qkv":
            v = v[:, _qkv_columns(d, size, rank)]
        elif k in ("w_ff1",):
            v = _slice_dim(v, size, rank, 1)
        elif k in ("w_out", "w_ff2", "b_ff1"):
            v = _slice_dim(v, size, rank, 0)
        out[k] = v.contiguous().clone()
    return out


def _layernorm(x, g, b, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def tp_block_apply(params: dict, x, n_heads: int, mesh=None,
                   causal: bool = True):
    """``[B, T, D] -> [B, T, D]``. ``params`` whole (``mesh`` None or a
    model axis of 1) or this rank's slices (:func:`shard_tp_params`): the
    rank runs its heads and FFN columns and the row-parallel products are
    summed over the model subgroup."""
    import torch.nn.functional as F

    size = 1 if mesh is None else int(mesh.shape[MODEL_AXIS])
    group = None if mesh is None else mesh.axis_group(MODEL_AXIS)
    b_, t, d = x.shape
    hd = d // n_heads
    heads = n_heads // size

    def into(v):
        return v if size == 1 else copy_to(v, group)

    def out_of(v):
        return v if size == 1 else reduce_from(v, group)

    h = into(_layernorm(x, params["ln1_g"], params["ln1_b"]))
    q, k, v = (h @ params["w_qkv"]).split(heads * hd, dim=-1)

    def split_heads(m):
        return m.reshape(b_, t, heads, hd).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=x.device))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    probs = torch.softmax(scores, dim=-1)
    ctx = (probs @ v).transpose(1, 2).reshape(b_, t, heads * hd)
    x = x + out_of(ctx @ params["w_out"])
    h = into(_layernorm(x, params["ln2_g"], params["ln2_b"]))
    ff = F.gelu(h @ params["w_ff1"] + params["b_ff1"], approximate="tanh")
    return x + out_of(ff @ params["w_ff2"])


def tp_train_step(mesh=None, n_heads: int = 1, lr: float = 1e-2):
    """-> ``step(params, x, targets) -> (new_params, loss)``: an MSE SGD
    step over a data x model mesh. ``params``: this rank's slices; ``x`` /
    ``targets``: this rank's rows of the global batch (every data index an
    equal share). The loss is the global batch's mean; gradients of the
    split weights stay split, and every gradient is summed over the data
    subgroup."""
    data = 1 if mesh is None else int(mesh.shape[DATA_AXIS])
    dgroup = None if mesh is None else mesh.axis_group(DATA_AXIS)

    def step(params, x, targets):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y = tp_block_apply(leaves, x, n_heads, mesh)
        loss = ((y - targets) ** 2).sum() / (y.numel() * data)
        loss.backward()
        grads = [leaves[k].grad for k in sorted(leaves)]
        total = loss.detach().reshape(1).clone()
        if data > 1:
            flat = torch.cat([g.reshape(-1) for g in grads] + [total])
            scheduler.all_reduce(flat, dgroup)
            grads = scheduler.split_flat(
                flat[:-1], [g.shape for g in grads])
            total = flat[-1:]
        new = {k: (leaves[k] - lr * g).detach()
               for k, g in zip(sorted(leaves), grads)}
        return new, total[0]

    return step


__all__ = [
    "copy_to", "reduce_from", "gather_from", "scatter_to", "gather_param",
    "LayerSplit", "ModelAxis", "plan_splits",
    "tp_block_init", "tp_block_shardings", "tp_block_apply",
    "shard_tp_params", "tp_train_step",
]
