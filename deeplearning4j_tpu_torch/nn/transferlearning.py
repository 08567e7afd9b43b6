"""Transfer learning.

Reference: ``org.deeplearning4j.nn.transferlearning``; counterpart of the
JAX package's ``nn/transferlearning.py``: ``TransferLearning.Builder``
(freeze through ``FrozenLayer``, replace / remove / add layers,
``FineTuneConfiguration`` overriding hyperparameters) and
``TransferLearningHelper`` (featurize through the frozen front once,
train the unfrozen tail).

A frozen layer runs its wrapped layer in inference mode on detached
params, so a frozen prefix builds no autograd graph at all (gradients
still flow to a frozen layer's input when something before it trains);
its updater is ``NoOp`` and it has no regularization, so its params stay
bit-identical however long the network trains. ``FrozenLayer`` is
registered for JSON, so a transferred network's configuration and zip
round-trip across the two packages. Kernel routing sees only the wrapper
(``kernels.routing`` checks the exact layer class), so frozen layers run
their stock forwards, as in the JAX package.

Deliberate differences from the JAX package: ``build`` keeps the source
configuration's ``dtype``, ``compute_dtype``, ``use_kernels``,
``gradient_checkpointing`` and ``quantization`` (the JAX builder starts a
fresh configuration and drops them), and copies the retained layers' state
(BN running statistics) with their params; ``TransferLearningHelper``'s
tail keeps the same fields. The networks live on the source network's
device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf.layers import Layer
from deeplearning4j_tpu_torch.conf.layers_rnn import _RecurrentWrapper
from deeplearning4j_tpu_torch.conf.multilayer import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.conf.updaters import IUpdater, NoOp
from deeplearning4j_tpu_torch.conf.weights import WeightInit
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn import io as nn_io

# the configuration fields a transferred network keeps from its source
_CARRIED = ("dtype", "compute_dtype", "use_kernels",
            "gradient_checkpointing", "quantization")


def _detached(params: dict) -> dict:
    return {k: v.detach() for k, v in params.items()}


@serde.register
@dataclasses.dataclass
class FrozenLayer(_RecurrentWrapper):
    """Freeze wrapper (reference ``conf.layers.misc.FrozenLayer``): the
    wrapped layer in inference mode on detached params, a ``NoOp``
    updater and no regularization."""

    @property
    def updater(self):
        return NoOp()

    @property
    def regularization(self):
        return ()

    @property
    def regularization_bias(self):
        return ()

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        # inference mode inside: a frozen layer's dropout and batch
        # statistics stay fixed; its state is read, never updated
        kw = {"mask": mask} if getattr(self.layer, "uses_mask", False) else {}
        y, _ = self.layer.forward(_detached(params), state, x, train=False,
                                  gen=gen, **kw)
        return y, state

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        return self._run_inner(_detached(params), carry, x, mask, False, gen)


@dataclasses.dataclass
class FineTuneConfiguration:
    """Hyperparameter overrides for every layer that is not frozen
    (reference ``FineTuneConfiguration.Builder``); None keeps the layer's
    value."""

    updater: Optional[IUpdater] = None
    seed: Optional[int] = None
    weight_init: Optional[WeightInit] = None
    dropout: Optional[float] = None


def _carry_fields(conf, source) -> MultiLayerConfiguration:
    return dataclasses.replace(conf, **{f: getattr(source, f)
                                        for f in _CARRIED})


class TransferLearning:
    """The reference API's namespace: ``TransferLearning.Builder``."""

    class Builder:
        def __init__(self, net):
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )

            if not isinstance(net, MultiLayerNetwork):
                raise TypeError("TransferLearning.Builder takes a "
                                "MultiLayerNetwork")
            if net.params is None:
                net.init()
            self._net = net
            # [layer, source index (None: added), re-initialize]
            self._items: List[list] = [
                [layer, i, False] for i, layer in enumerate(net.conf.layers)]
            self._ftc: Optional[FineTuneConfiguration] = None
            self._frozen_upto = -1

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers ``[0, layer_idx]`` (the named layer and every
            layer before it become the frozen featurizer)."""
            self._frozen_upto = int(layer_idx)
            return self

        def n_out_replace(self, layer_idx: int, n_out: int,
                          weight_init: Optional[WeightInit] = None):
            """Change layer ``layer_idx``'s width; its params and the next
            parameterized layer's are re-initialized (reference
            ``nOutReplace``)."""
            item = self._items[layer_idx]
            layer = dataclasses.replace(item[0], n_out=int(n_out))
            if weight_init is not None:
                layer = dataclasses.replace(layer, weight_init=weight_init)
            item[0] = layer
            item[2] = True
            for nxt in self._items[layer_idx + 1:]:
                if nxt[0].param_order():
                    nxt[2] = True
                    break
            return self

        def remove_output_layer(self):
            self._items.pop()
            return self

        def remove_layers_from_output(self, n: int):
            for _ in range(int(n)):
                self._items.pop()
            return self

        def add_layer(self, layer: Layer):
            self._items.append([layer, None, False])
            return self

        # -- build -----------------------------------------------------------
        def _apply_ftc(self, layer: Layer) -> Layer:
            if self._ftc is None:
                return layer
            fields = {f.name for f in dataclasses.fields(layer)}
            kw = {f: getattr(self._ftc, f)
                  for f in ("updater", "weight_init", "dropout")
                  if getattr(self._ftc, f) is not None and f in fields}
            return dataclasses.replace(layer, **kw) if kw else layer

        def build(self):
            """The transferred network, on the source network's device:
            retained layers keep their params (copies) and state."""
            from deeplearning4j_tpu_torch.nn.multilayer import (
                MultiLayerNetwork,
            )

            src = self._net
            old_conf = src.conf
            layers: List[Layer] = []
            copy_map: List[Tuple[int, Optional[int]]] = []  # new -> old
            for new_idx, (layer, old_idx, reinit) in enumerate(self._items):
                if old_idx is not None and old_idx <= self._frozen_upto:
                    layer = FrozenLayer(layer=layer)
                else:
                    layer = self._apply_ftc(layer)
                layers.append(layer)
                copy_map.append((new_idx, None if reinit else old_idx))

            seed = (self._ftc.seed if self._ftc and self._ftc.seed
                    is not None else old_conf.seed)
            b = (NeuralNetConfiguration.builder().seed(seed)
                 .updater(old_conf.updater).list())
            for layer in layers:
                b.layer(layer)
            b.set_input_type(old_conf.input_type)
            b.backprop_type(old_conf.backprop_type,
                            old_conf.tbptt_fwd_length,
                            old_conf.tbptt_back_length)
            conf = _carry_fields(b.build(), old_conf)

            new_net = MultiLayerNetwork(conf, src.device).init()
            # the builder re-inserted the preprocessors: map by the ORDER
            # of the parameterized layers (preprocessors are only ever
            # inserted, so that order is kept)
            old_p_idx = [i for i, layer in enumerate(old_conf.layers)
                         if layer.param_order()]
            with torch.no_grad():
                for _, old_idx in copy_map:
                    if old_idx is None or old_idx not in old_p_idx:
                        continue
                    tgt = str(_find_nth_param_layer(
                        conf.layers, old_p_idx.index(old_idx)))
                    for tree, new_tree in ((src.params, new_net.params),
                                           (src.state, new_net.state)):
                        for k, v in tree.get(str(old_idx), {}).items():
                            new_tree[tgt][k].copy_(v)
            new_net._cast_params = None
            return new_net


def _find_nth_param_layer(layers, n: int) -> int:
    seen = 0
    for i, layer in enumerate(layers):
        if layer.param_order():
            if seen == n:
                return i
            seen += 1
    raise IndexError(f"no {n}-th parameterized layer")


class TransferLearningHelper:
    """Featurize-once training (reference ``TransferLearningHelper``):
    split the network at its frozen boundary, run the frozen front once a
    dataset, train only the tail. The tail shares the network's param
    tensors (its updates land in the network) and has its own updater
    state, from zero."""

    def __init__(self, net, frozen_till: Optional[int] = None):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        self._net = net
        layers = net.conf.layers
        if frozen_till is None:
            frozen_till = max((i for i, layer in enumerate(layers)
                               if isinstance(layer, FrozenLayer)),
                              default=-1)
        self._split = int(frozen_till) + 1
        if self._split <= 0:
            raise ValueError("no frozen layers: use net.fit directly")
        b = (NeuralNetConfiguration.builder().seed(net.conf.seed)
             .updater(net.conf.updater).list())
        for layer in layers[self._split:]:
            b.layer(layer)
        b.set_input_type(net.conf.output_types()[self._split - 1])
        self._tail = MultiLayerNetwork(_carry_fields(b.build(), net.conf),
                                       net.device)
        self._tail.set_params(self._tail_tree(net.params),
                              self._tail_tree(net.state))
        self._sync_to_tail()

    def _tail_tree(self, tree) -> dict:
        return {str(j): tree[str(self._split + j)]
                for j in range(len(self._tail.conf.layers))
                if str(self._split + j) in tree}

    def _sync_to_tail(self):
        """The tail on the network's current param and state tensors."""
        self._tail.params.update(self._tail_tree(self._net.params))
        self._tail.state.update(self._tail_tree(self._net.state))
        self._tail._cast_params = None

    def featurize(self, ds: DataSet) -> DataSet:
        """The frozen front's output for ``ds`` (reference ``featurize``):
        a device tensor in the JAX package's layout (NHWC for images), the
        labels and masks passed through."""
        net = self._net
        with torch.no_grad():
            out, _ = net._run(net._fwd_params(), net.state,
                              net._prepare(ds.features),
                              upto=self._split,
                              fmask=net._on_device(ds.features_mask))
        return DataSet(nn_io.to_external(out.to(net._dtype)), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def fit_featurized(self, ds: DataSet):
        """Train the tail on featurized data (reference
        ``fitFeaturized``): one step; the network sees the new params."""
        self._sync_to_tail()
        self._tail.fit_batch(ds)
        self._net._cast_params = None
        return self

    def unfrozen_mln(self):
        return self._tail

    def output_from_featurized(self, features):
        return self._tail.output(features)
