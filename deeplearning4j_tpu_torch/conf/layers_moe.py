"""Mixture-of-experts layer for the conf DSL.

Counterpart of the JAX package's ``conf/layers_moe.py`` (same fields,
defaults and ``@type`` tag). The math is ``parallel/expert.py``'s
``moe_apply``: top-k routing, per-expert capacity with the residual alone
for a dropped token and, when the expert weights arrive sharded (``e_loc <
n_experts`` under ``ParallelWrapper(expert_parallel=True)``), an
all-to-all token exchange over the active process group.

Under the data-parallel trainer's exact mode (``comms.global_batch``) an
unsharded layer routes over the global batch, as the JAX package's one
SPMD step does (``parallel.expert.moe_apply_global``): every rank's router
probabilities are gathered (``[tokens, E]``, not the hidden states), the
top-k, the capacity ``C`` (sized from the global token count), the queue
(rank 0's tokens first) and the auxiliary loss are the global batch's,
each rank runs only its own tokens through the experts, and it adds ``1 /
world`` of the auxiliary loss (:func:`sum_aux_losses`), so the ranks'
summed objective is the global one.

The GShard load-balance loss reaches the training objective through the
reserved state key :data:`AUX_LOSS_KEY`: in train mode the layer writes
its ``aux_weight``-scaled aux into the state it returns, and both
networks' ``_loss`` add every such entry to the score (train mode only:
eval scores never pick up the last step's value).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.comms import global_batch
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import BaseLayer

#: Reserved state key: layers put auxiliary (train-time) loss terms here;
#: the networks' ``_loss`` sums them into the score.
AUX_LOSS_KEY = "__aux_loss__"


def sum_aux_losses(new_state, dtype):
    """Total of every layer's aux-loss entry in a train-mode forward's new
    state (callers gate on ``train``). Each entry is left detached in
    ``new_state``: the state keeps the value, the score keeps the graph.
    Inside ``comms.global_batch`` each entry is the global batch's, which
    every rank computes: a rank adds its ``1 / world`` share."""
    total = 0.0
    share = global_batch.world_share()
    for s in new_state.values():
        if isinstance(s, dict) and AUX_LOSS_KEY in s:
            aux = s[AUX_LOSS_KEY].to(dtype)
            total = total + (aux * share if share != 1.0 else aux)
            s[AUX_LOSS_KEY] = s[AUX_LOSS_KEY].detach()
    return total


@serde.register
@dataclasses.dataclass
class MoELayer(BaseLayer):
    """GShard-style MoE FFN block: router -> top-k dispatch (capacity C)
    -> per-expert relu FFN -> gated combine, with the residual around the
    block unless ``residual=False`` (the zoo transformer wires its own add
    vertex). Output size == input size.

    ``capacity_factor`` sizes ``C = max(1, ceil(top_k * tokens / n_experts
    * capacity_factor))`` over the tokens routed together (this rank's
    under ``expert_parallel``, the global batch's in the exact mode). Params: ``router [d, E]``, ``w1 [E, d,
    h]``, ``w2 [E, h, d]``, ``b1 [E, h]``, ``b2 [E, d]``; under
    ``ParallelWrapper(expert_parallel=True)`` the expert leaves
    (``param_shard_axes``) hold this rank's ``E / world`` experts."""

    n_experts: int = 4
    d_hidden: int = 0          # 0 -> 4 * d_model
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 1e-2
    has_bias: bool = True
    residual: bool = True

    def _dims(self, input_type):
        if isinstance(input_type, (it.Recurrent, it.FeedForward)):
            return input_type.size
        raise ValueError(
            f"MoELayer needs recurrent/feed-forward input, got {input_type}")

    def output_type(self, input_type):
        self._dims(input_type)
        return input_type  # residual block: shape-preserving

    def init(self, gen, input_type, dtype=torch.float32):
        from deeplearning4j_tpu_torch.parallel import expert

        d = self._dims(input_type)
        p = expert.moe_init(gen, d, self.d_hidden or 4 * d, self.n_experts,
                            dtype)
        if self.has_bias:
            p["b1"] = torch.zeros((self.n_experts, p["w1"].shape[2]),
                                  dtype=dtype)
            p["b2"] = torch.zeros((self.n_experts, d), dtype=dtype)
        return p

    def init_state(self, input_type, dtype=torch.float32):
        return {AUX_LOSS_KEY: torch.zeros((), dtype=dtype)}

    def param_order(self):
        return (["router", "w1", "w2", "b1", "b2"] if self.has_bias
                else ["router", "w1", "w2"])

    def regularized_param_keys(self):
        return ["w1", "w2"]

    def param_shard_axes(self):
        """Leaves whose LEADING axis shards over the expert axis (read by
        ``ParallelWrapper``'s expert-parallel set-up)."""
        keys = ["w1", "w2"] + (["b1", "b2"] if self.has_bias else [])
        return {k: "expert" for k in keys}

    def forward(self, params, state, x, train=False, gen=None):
        from deeplearning4j_tpu_torch.parallel import expert

        x = self._dropout_input(x, train, gen)
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        e_loc = params["w1"].shape[0]
        axis = group = None
        if e_loc != self.n_experts:
            axis = expert.current_expert_axis()
            if axis is None:
                raise RuntimeError(
                    f"MoELayer: expert weights arrived sharded "
                    f"({e_loc}/{self.n_experts}) outside an "
                    "active_expert_axis context — run through "
                    "ParallelWrapper(expert_parallel=True)")
            group = expert.current_expert_group()
        if axis is None and global_batch.active() is not None:
            # the exact data-parallel mode: route over the global batch
            y2, aux = expert.moe_apply_global(
                params["router"], params["w1"], params["w2"], x2,
                self.n_experts, self.capacity_factor, self.top_k,
                global_batch.gather_rows, b1=params.get("b1"),
                b2=params.get("b2"), residual=self.residual)
        else:
            capacity = max(1, math.ceil(self.top_k * x2.shape[0]
                                        / self.n_experts
                                        * self.capacity_factor))
            y2, aux = expert.moe_apply(
                params["router"], params["w1"], params["w2"], x2,
                self.n_experts, capacity, top_k=self.top_k,
                axis_name=axis, b1=params.get("b1"), b2=params.get("b2"),
                residual=self.residual, group=group)
        new_state = ({AUX_LOSS_KEY: (self.aux_weight * aux).to(
            state[AUX_LOSS_KEY].dtype)} if train else state)
        return self.activation.apply(y2).reshape(shape), new_state
