"""Self-attention layer (``SelfAttentionLayer`` of the JAX package's
``conf/layers_attention.py``: training, serving and the KV-cached decode).

Reference: ``org.deeplearning4j.nn.conf.layers.SelfAttentionLayer``. The
same fields and ``@type`` tag as the JAX package, so configurations
round-trip. The softmax(QK^T)V core goes through
:func:`ops.attention.dot_product_attention`, or, with ``use_kernels``,
through the flash kernel (``kernels.routing.maybe_flash_attention``) in
eval and train mode alike: ``flash_attention`` is an autograd Function
whose backward is the dq and dk/dv kernels. In a graph the feature mask
reaches :meth:`SelfAttentionLayer.forward` as ``mask`` (``uses_mask``) and
becomes the kernels' key mask.

Weight layout: the port keeps every projection in torch's ``nn.Linear``
layout, ``[out, in]``: ``Wq/Wk/Wv: [nHeads*headSize, nIn]``,
``Wo: [nOut, nHeads*headSize]`` (the JAX package's ``[in, out]`` matrices
transposed; ``util.convert`` does it), biases per projection. Sequence data
is ``[batch, time, features]``; ``mask`` / ``key_mask`` is ``[batch,
time]`` (valid where ``> 0``).

The KV-cached decode path (``init_kv_cache`` / ``prefill`` /
``decode_step``) keeps caches ``[max_batch, max_len, n_heads, head_size]``
and writes them IN PLACE (the JAX package donates them into its compiled
step for the same effect). ``decode_chunk`` and ``prefill_suffix``
(speculative decoding, prefix cache) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.layers import BaseLayer
from deeplearning4j_tpu_torch.ops.attention import (
    cache_update,
    decode_attention,
    dot_product_attention,
)


def _split_heads(x, nheads):
    b, t, e = x.shape
    return x.reshape(b, t, nheads, e // nheads).permute(0, 2, 1, 3)


def _merge_heads(x):
    b, h, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * d)


def _attn_core(q, k, v, key_mask, causal, impl, train, use_kernels):
    """The softmax(QK^T)V core over head-split ``[B, H, T, D]`` inputs: the
    flash kernel when ``use_kernels`` and the routing admits the shape,
    else the stock :func:`dot_product_attention` tier."""
    if use_kernels and impl in ("auto", "flash"):
        from deeplearning4j_tpu_torch.kernels import routing

        o = routing.maybe_flash_attention(q, k, v, key_mask=key_mask,
                                          causal=causal)
        if o is not None:
            return o
    return dot_product_attention(q, k, v, key_mask=key_mask, causal=causal,
                                 impl=impl, train=train)


def _mha(params, q_in, kv_in, nheads, key_mask, causal=False, impl="auto",
         train=True, use_kernels=False):
    """Projected multi-head attention over [B, T, E] inputs."""
    q = F.linear(q_in, params["Wq"], params["bq"])
    k = F.linear(kv_in, params["Wk"], params["bk"])
    v = F.linear(kv_in, params["Wv"], params["bv"])
    o = _attn_core(_split_heads(q, nheads), _split_heads(k, nheads),
                   _split_heads(v, nheads), key_mask, causal, impl, train,
                   use_kernels)
    return F.linear(_merge_heads(o), params["Wo"], params["bo"])


def _rnn_size(input_type) -> int:
    if isinstance(input_type, it.Recurrent):
        return input_type.size
    raise ValueError(f"attention layer needs Recurrent input, got {input_type}")


def _rnn_size_static(input_type):
    return input_type.size if isinstance(input_type, it.Recurrent) else 0


@serde.register
@dataclasses.dataclass
class SelfAttentionLayer(BaseLayer):
    """Self-attention over the sequence (reference ``SelfAttentionLayer``)."""

    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0  # 0 → nOut // nHeads
    project_input: bool = True
    causal: bool = False  # extension (the reference is always bidirectional)
    attention_impl: str = "auto"  # auto|flash|blockwise|reference

    uses_mask = True

    def _head_size(self, n_in):
        if not self.project_input:
            return n_in
        return self.head_size or (self.n_out // self.n_heads)

    def output_type(self, input_type):
        ts = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        n = self.n_out if self.project_input else _rnn_size_static(input_type)
        return it.Recurrent(size=n, timesteps=ts)

    def init(self, gen, input_type, dtype=torch.float32):
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError("project_input=False requires n_heads == 1 "
                                 "(reference SelfAttentionLayer semantics)")
            return {}
        n_in = _rnn_size(input_type)
        e = self.n_heads * self._head_size(n_in)
        wi = self.weight_init

        def w(n_o, n_i):
            return wi.init(gen, (n_o, n_i), n_i, n_o, dtype, self.distribution)

        return {
            "Wq": w(e, n_in), "Wk": w(e, n_in), "Wv": w(e, n_in),
            "Wo": w(self.n_out, e),
            "bq": torch.zeros((e,), dtype=dtype),
            "bk": torch.zeros((e,), dtype=dtype),
            "bv": torch.zeros((e,), dtype=dtype),
            "bo": torch.full((self.n_out,), self.bias_init, dtype=dtype),
        }

    def param_order(self):
        if not self.project_input:
            return []
        return ["Wq", "bq", "Wk", "bk", "Wv", "bv", "Wo", "bo"]

    def regularized_param_keys(self):
        return ["Wq", "Wk", "Wv", "Wo"]

    def forward(self, params, state, x, train=False, gen=None, mask=None,
                use_kernels=False):
        x = self._dropout_input(x, train, gen)
        if not self.project_input:
            q = _split_heads(x, 1)
            o = _attn_core(q, q, q, mask, self.causal, self.attention_impl,
                           train, use_kernels)
            y = _merge_heads(o)
        else:
            y = _mha(params, x, x, self.n_heads, mask, self.causal,
                     self.attention_impl, train=train,
                     use_kernels=use_kernels)
        y = self.activation.apply(y)
        if mask is not None:  # masked-out steps emit zeros, as the reference
            y = y * mask.to(y.dtype)[:, :, None]
        return y, state

    # --- KV-cached autoregressive decode (nn.decoding / generation) -------

    def _decode_check(self):
        if not self.project_input:
            raise ValueError("KV-cached decode requires project_input=True")
        if not self.causal:
            raise ValueError("KV-cached decode requires causal=True "
                             "(bidirectional attention cannot stream)")

    def init_kv_cache(self, max_batch, max_len, n_in, dtype=torch.float32,
                      device=None):
        """Preallocated per-sequence KV buffers for this layer:
        ``{"k","v"}: [max_batch, max_len, n_heads, head_size]`` zeros."""
        self._decode_check()
        shape = (max_batch, max_len, self.n_heads, self._head_size(n_in))
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def prefill(self, params, x, key_mask=None, use_kernels=False):
        """Whole-prompt forward that also returns the projected keys and
        values: ``x [batch, time, features]`` → ``(y, k, v)`` with
        ``k/v [batch, time, n_heads, head_size]`` (cache layout) and ``y``
        equal to :meth:`forward` in eval mode (activation and mask-zeroing
        applied). ``use_kernels`` sends the core through the flash kernel."""
        self._decode_check()
        b, t, _ = x.shape
        nh = self.n_heads
        hs = params["Wk"].shape[0] // nh
        q = F.linear(x, params["Wq"], params["bq"])
        k = F.linear(x, params["Wk"], params["bk"])
        v = F.linear(x, params["Wv"], params["bv"])
        o = _attn_core(_split_heads(q, nh), _split_heads(k, nh),
                       _split_heads(v, nh), key_mask, True,
                       self.attention_impl, False, use_kernels)
        y = self.activation.apply(F.linear(_merge_heads(o), params["Wo"],
                                           params["bo"]))
        if key_mask is not None:
            y = y * key_mask.to(y.dtype)[:, :, None]
        return y, k.reshape(b, t, nh, hs), v.reshape(b, t, nh, hs)

    def decode_step(self, params, x, cache, positions, use_kernels=False):
        """One token of causal attention against the KV cache. ``x [batch,
        features]`` is the new token's representation, ``positions
        [batch]`` the slot it occupies. Projects q/k/v for the token, writes
        k/v into ``cache`` at ``positions`` IN PLACE (clamped as
        :func:`ops.attention.cache_update` says), attends slots
        ``0..positions`` inclusive, and returns ``(y [batch, features_out],
        cache)``. ``use_kernels`` sends the read through the paged decode
        kernel."""
        self._decode_check()
        b = x.shape[0]
        nh = self.n_heads
        hs = params["Wk"].shape[0] // nh
        q = F.linear(x, params["Wq"], params["bq"]).reshape(b, nh, hs)
        k_new = F.linear(x, params["Wk"], params["bk"]).reshape(b, 1, nh, hs)
        v_new = F.linear(x, params["Wv"], params["bv"]).reshape(b, 1, nh, hs)
        cache_update(cache["k"], k_new, positions)
        cache_update(cache["v"], v_new, positions)
        o = None
        if use_kernels:
            from deeplearning4j_tpu_torch.kernels import routing

            o = routing.maybe_decode_attention(q, cache["k"], cache["v"],
                                               positions)
        if o is None:
            o = decode_attention(q, cache["k"], cache["v"], positions)
        y = F.linear(o.reshape(b, nh * hs), params["Wo"], params["bo"])
        return self.activation.apply(y), cache
