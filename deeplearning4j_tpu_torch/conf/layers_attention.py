"""Attention layers (the JAX package's ``conf/layers_attention.py``):
``SelfAttentionLayer`` (training, serving and the KV-cached decode),
``LearnedSelfAttentionLayer`` and ``RecurrentAttentionLayer``.

Reference: ``org.deeplearning4j.nn.conf.layers.{SelfAttentionLayer,
LearnedSelfAttentionLayer, RecurrentAttentionLayer}``. The same fields and
``@type`` tags as the JAX package, so configurations round-trip. The softmax(QK^T)V core goes through
:func:`ops.attention.dot_product_attention`, or, with ``use_kernels``,
through the flash kernel (``kernels.routing.maybe_flash_attention``) in
eval and train mode alike: ``flash_attention`` is an autograd Function
whose backward is the dq and dk/dv kernels. In a graph the feature mask
reaches :meth:`SelfAttentionLayer.forward` as ``mask`` (``uses_mask``) and
becomes the kernels' key mask.

Weight layout: the port keeps the projections of ``SelfAttentionLayer``
and ``LearnedSelfAttentionLayer`` in torch's ``nn.Linear`` layout, ``[out,
in]``: ``Wq/Wk/Wv: [nHeads*headSize, nIn]``, ``Wo: [nOut,
nHeads*headSize]`` (the JAX package's ``[in, out]`` matrices transposed;
``util.convert`` does it), biases per projection; the learned queries
``Q [nQueries, nHeads*headSize]`` are rows in both packages.
``RecurrentAttentionLayer`` is a recurrent cell and keeps the JAX
package's ``[in, out]`` matrices, as the layers of ``conf.layers_rnn``
do. Sequence data
is ``[batch, time, features]``; ``mask`` / ``key_mask`` is ``[batch,
time]`` (valid where ``> 0``).

The KV-cached decode path (``init_kv_cache`` / ``prefill`` /
``decode_step``) keeps caches ``[max_batch, max_len, n_heads, head_size]``
and writes them IN PLACE (the JAX package donates them into its compiled
step for the same effect); ``decode_chunk`` scores a window of tokens
against them (the speculative verifier) and ``prefill_suffix`` prefills a
prompt's suffix against cached prefix pages (the prefix cache).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import serde
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.layers import BaseLayer
from deeplearning4j_tpu_torch.conf.layers_rnn import (
    _blend,
    _emit,
    _project,
    _time_major_mask,
)
from deeplearning4j_tpu_torch.ops.attention import (
    cache_update,
    chunk_decode_attention,
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

    def streaming_safe(self) -> bool:
        # attention needs the WHOLE sequence; per-segment rnn_time_step
        # calls would attend only within each call's window
        return False

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

    def decode_chunk(self, params, x, cache, positions):
        """A ``t``-token window of causal attention against the KV cache,
        the multi-token twin of :meth:`decode_step` (the speculative
        verifier). ``x [batch, t, features]``; token ``i`` of row ``b``
        occupies slot ``positions[b] + i``. Writes the window's k/v block
        into ``cache`` IN PLACE (clamped as :func:`ops.attention
        .cache_update` says), attends through
        :func:`ops.attention.chunk_decode_attention` and returns ``(y
        [batch, t, features_out], cache)``. Stays on the stock core under
        ``use_kernels``, as in the JAX package: the window's per-row cache
        offsets do not fit the flash kernel's single ``Tk - Tq`` causal
        rule."""
        self._decode_check()
        b, t, _ = x.shape
        nh = self.n_heads
        hs = params["Wk"].shape[0] // nh
        q = F.linear(x, params["Wq"], params["bq"]).reshape(b, t, nh, hs)
        k_new = F.linear(x, params["Wk"], params["bk"]).reshape(b, t, nh, hs)
        v_new = F.linear(x, params["Wv"], params["bv"]).reshape(b, t, nh, hs)
        cache_update(cache["k"], k_new, positions)
        cache_update(cache["v"], v_new, positions)
        o = chunk_decode_attention(q, cache["k"], cache["v"], positions)
        y = F.linear(o.reshape(b, t, nh * hs), params["Wo"], params["bo"])
        return self.activation.apply(y), cache

    def prefill_suffix(self, params, x, prefix_k, prefix_v, prefix_mask,
                       key_mask=None, use_kernels=False):
        """Prompt-suffix prefill against an already-projected prefix, the
        prefix-cache twin of :meth:`prefill`. ``x [batch, t_suffix,
        features]``; ``prefix_k/prefix_v [batch, t_prefix, n_heads,
        head_size]`` are the cached pages (padding masked by ``prefix_mask
        [batch, t_prefix]``). The suffix queries attend ``[prefix ;
        suffix]`` with the key mask ``[prefix_mask ; key_mask]`` and the
        causal rule ``j <= i + (Tk - Tq)``: every prefix key is visible to
        every suffix query, the suffix is causal within itself. The core
        goes through the flash kernel under ``use_kernels``. Returns ``(y,
        k, v)`` with ``y`` zeroed on masked suffix rows and ``k/v`` the
        SUFFIX blocks only (cache layout)."""
        self._decode_check()
        b, t, _ = x.shape
        nh = self.n_heads
        hs = params["Wk"].shape[0] // nh
        q = F.linear(x, params["Wq"], params["bq"])
        k = F.linear(x, params["Wk"], params["bk"]).reshape(b, t, nh, hs)
        v = F.linear(x, params["Wv"], params["bv"]).reshape(b, t, nh, hs)
        k_full = torch.cat([prefix_k.to(k.dtype), k], dim=1)
        v_full = torch.cat([prefix_v.to(v.dtype), v], dim=1)
        if key_mask is None:
            key_mask = torch.ones((b, t), dtype=x.dtype, device=x.device)
        mask = torch.cat([prefix_mask.to(x.dtype), key_mask.to(x.dtype)],
                         dim=1)
        o = _attn_core(_split_heads(q, nh), k_full.permute(0, 2, 1, 3),
                       v_full.permute(0, 2, 1, 3), mask, True,
                       self.attention_impl, False, use_kernels)
        y = self.activation.apply(F.linear(_merge_heads(o), params["Wo"],
                                           params["bo"]))
        y = y * key_mask.to(y.dtype)[:, :, None]
        return y, k, v


@serde.register
@dataclasses.dataclass
class LearnedSelfAttentionLayer(BaseLayer):
    """Attention with ``n_queries`` LEARNED query vectors (reference
    ``LearnedSelfAttentionLayer``): the output is a fixed-length ``[batch,
    n_queries, n_out]`` sequence whatever the input length, so it doubles
    as sequence pooling. ``Q [n_queries, n_heads*head_size]`` holds the
    queries in projected space, broadcast over the batch (its gradient is
    the queries' gradient summed over the batch). The core goes through
    :func:`ops.attention.dot_product_attention` with ``attention_impl``:
    ``"flash"`` runs the flash forward kernel and, in training, the dq and
    dk/dv kernels, with the feature mask as the key mask (non-causal)."""

    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    n_queries: int = 1
    project_input: bool = True
    attention_impl: str = "auto"

    uses_mask = True

    def streaming_safe(self) -> bool:
        # attention needs the WHOLE sequence; per-segment rnn_time_step
        # calls would attend only within each call's window
        return False

    def _dims(self, n_in):
        hs = self.head_size or ((self.n_out if self.project_input else n_in)
                                // self.n_heads)
        return hs, self.n_heads * hs

    def output_type(self, input_type):
        n = self.n_out if self.project_input else _rnn_size_static(input_type)
        return it.Recurrent(size=n, timesteps=self.n_queries)

    def init(self, gen, input_type, dtype=torch.float32):
        n_in = _rnn_size(input_type)
        hs, e = self._dims(n_in)
        wi = self.weight_init

        def w(n_o, n_i):
            return wi.init(gen, (n_o, n_i), n_i, n_o, dtype, self.distribution)

        p = {"Q": wi.init(gen, (self.n_queries, e), e, e, dtype,
                          self.distribution)}
        if not self.project_input:
            if self.n_heads != 1:
                raise ValueError("project_input=False requires n_heads == 1")
            if self.head_size and self.head_size != n_in:
                raise ValueError(
                    f"project_input=False: learned queries attend directly "
                    f"over the {n_in}-wide input, so head_size must be "
                    f"{n_in} (or 0 for automatic), got {self.head_size}")
            return p
        p.update({
            "Wk": w(e, n_in), "Wv": w(e, n_in), "Wo": w(self.n_out, e),
            "bk": torch.zeros((e,), dtype=dtype),
            "bv": torch.zeros((e,), dtype=dtype),
            "bo": torch.full((self.n_out,), self.bias_init, dtype=dtype),
        })
        return p

    def param_order(self):
        if not self.project_input:
            return ["Q"]
        return ["Q", "Wk", "bk", "Wv", "bv", "Wo", "bo"]

    def regularized_param_keys(self):
        return ["Q", "Wk", "Wv", "Wo"] if self.project_input else ["Q"]

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        x = self._dropout_input(x, train, gen)
        q = params["Q"][None].expand(x.shape[0], -1, -1)
        if self.project_input:
            k = F.linear(x, params["Wk"], params["bk"])
            v = F.linear(x, params["Wv"], params["bv"])
        else:
            k = v = x
        nh = self.n_heads
        o = dot_product_attention(
            _split_heads(q, nh), _split_heads(k, nh), _split_heads(v, nh),
            key_mask=mask, impl=self.attention_impl, train=train)
        y = _merge_heads(o)
        if self.project_input:
            y = F.linear(y, params["Wo"], params["bo"])
        return self.activation.apply(y), state


@serde.register
@dataclasses.dataclass
class RecurrentAttentionLayer(BaseLayer):
    """A recurrent cell that attends over the whole input sequence at
    every step, with the previous hidden state as the query (reference
    ``RecurrentAttentionLayer``)::

        ctx_t = MHA(q = h_{t-1} Wq, K = x Wk, V = x Wv)
        h_t   = act(x_t W + h_{t-1} RW + ctx_t Wc + b)

    Keys, values and the input projection are computed once before the
    loop; each step projects its query and attends one ``[1, T]`` row per
    head in plain PyTorch, masked keys SET to -1e30 (a row with no valid
    key averages its values)."""

    n_out: int = 0
    n_heads: int = 1
    head_size: int = 0
    activation: Activation = Activation.TANH

    uses_mask = True
    has_carry = True

    def streaming_safe(self) -> bool:
        # attention needs the WHOLE sequence; per-segment rnn_time_step
        # calls would attend only within each call's window
        return False

    def _dims(self):
        hs = self.head_size or (self.n_out // self.n_heads)
        return hs, self.n_heads * hs

    def output_type(self, input_type):
        ts = input_type.timesteps if isinstance(input_type, it.Recurrent) else -1
        return it.Recurrent(size=self.n_out, timesteps=ts)

    def init(self, gen, input_type, dtype=torch.float32):
        n_in = _rnn_size(input_type)
        _, e = self._dims()
        n = self.n_out
        wi = self.weight_init

        def w(rows, cols):
            return wi.init(gen, (rows, cols), rows, cols, dtype,
                           self.distribution)

        return {"W": w(n_in, n), "RW": w(n, n), "Wq": w(n, e),
                "Wk": w(n_in, e), "Wv": w(n_in, e), "Wc": w(e, n),
                "b": torch.full((n,), self.bias_init, dtype=dtype)}

    def param_order(self):
        return ["W", "RW", "Wq", "Wk", "Wv", "Wc", "b"]

    def regularized_param_keys(self):
        return ["W", "RW", "Wq", "Wk", "Wv", "Wc"]

    def zero_carry(self, batch, dtype=torch.float32, device=None):
        return {"h": torch.zeros((batch, self.n_out), dtype=dtype,
                                 device=device)}

    def forward_with_carry(self, params, carry, x, mask=None, train=False,
                           gen=None):
        x = self._dropout_input(x, train, gen)
        b, t, _ = x.shape
        hs, e = self._dims()
        nh = self.n_heads
        xw = _project(x, params["W"], params["b"])
        dt = xw.dtype
        wq, rw, wc = (params[k].to(dt) for k in ("Wq", "RW", "Wc"))
        # keys [b, nh, hs, t] and values [b, nh, t, hs] for batched products
        k = (x @ params["Wk"].to(dt)).reshape(b, t, nh, hs).permute(0, 2, 3, 1)
        v = (x @ params["Wv"].to(dt)).reshape(b, t, nh, hs).transpose(1, 2)
        keep = None if mask is None else (mask.to(x.device) > 0)[:, None, None]
        mt = _time_major_mask(mask, xw)
        scale = 1.0 / math.sqrt(hs)
        h = carry["h"].to(dt)
        ys = []
        for step in range(t):
            q = (h @ wq).reshape(b, nh, 1, hs)
            s = (q @ k) * scale                              # [b, nh, 1, t]
            if keep is not None:
                s = s.masked_fill(~keep, -1e30)
            ctx = (torch.softmax(s, dim=-1) @ v).reshape(b, e)
            h_new = self.activation.apply(
                xw[step] + h @ rw + ctx @ wc)
            h = _blend(None if mt is None else mt[step], h_new, h)
            ys.append(h_new)
        return _emit(ys, mt), {"h": h}

    def forward(self, params, state, x, train=False, gen=None, mask=None):
        carry = self.zero_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.forward_with_carry(params, carry, x, mask=mask,
                                       train=train, gen=gen)
        return y, state
