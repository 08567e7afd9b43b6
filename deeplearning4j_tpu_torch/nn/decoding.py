"""KV-cached autoregressive decode for causal Transformer graphs.

Counterpart of the JAX package's ``deeplearning4j_tpu/nn/decoding.py``. A
causal ``zoo.TransformerEncoder(lm_head=True)`` graph (embedding → position
embedding → pre-LN causal-attention blocks → LN → time-distributed output
head) gets the two phases of a serving decoder:

- ``prefill``: a join group's prompts in one pass — full causal attention
  (the flash kernel under ``use_kernels``), every layer's projected keys
  and values captured in cache layout and written into the preallocated
  per-sequence KV buffers (``[max_batch, kv_bucket, heads, head_dim]``),
  the first token sampled from the last valid position;
- ``decode``: one token per sequence per step against the cache (the paged
  decode kernel under ``use_kernels``), ``fused_steps=K`` steps per window
  with EOS / max-token masking, so rows that finish inside the window
  become no-ops.

Eager PyTorch has no compiled executables: the ``*_fn`` factories keep the
JAX package's names and bucket arguments and return plain callables, and
``warmup()`` runs one prefill and one window per bucket instead of
compiling them (the first launches build the kernel library and cuBLAS's
workspaces). State is a dict of device tensors updated IN PLACE (the JAX
package donates it into each executable for the same effect); every entry
point runs under ``torch.inference_mode``.

Semantics kept from the JAX package where torch differs:

- out-of-range indices: the cache write clamps its start to ``S - t``
  (``dynamic_update_slice``), the position-embedding gather clamps to
  ``max_len - 1`` (a jnp gather), and join rows ``>= max_batch`` are
  dropped (``mode="drop"``) — each done explicitly;
- greedy ties: ``torch.argmax`` returns the first maximum, as
  ``jnp.argmax`` does;
- sampling: each request draws from its own ``torch.Generator`` (seeded
  per request; ``jax.random`` bits cannot be matched), one draw per
  emitted token, so a row's tokens never depend on its co-tenants.

Scheduling lives in ``parallel.generation``; :meth:`TransformerDecoder
.generate` is the sequential one-request reference the engine is held to.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.conf.layers import (
    EmbeddingSequenceLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.conf.layers_attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import GlobalPoolingLayer
from deeplearning4j_tpu_torch.conf.layers_extra import PositionEmbeddingLayer


def pow2_ladder(lo: int, hi: int) -> List[int]:
    """Power-of-two bucket ladder from ``lo`` up, capped at (and always
    including) ``hi``."""
    lo, hi = int(lo), int(hi)
    if lo >= hi:
        return [hi]
    out = []
    b = lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


def bucket_for(n: int, ladder: List[int]) -> int:
    """Smallest ladder entry >= n (raises when n exceeds the ladder)."""
    for b in ladder:
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {ladder[-1]}")


def request_generator(seed: int, device) -> torch.Generator:
    """The per-request sampling stream (the counterpart of the JAX
    package's per-request ``PRNGKey(seed)``)."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def _sample_tokens(logits, temps: List[float], gens: List):
    """Greedy (temp == 0: the first maximum) or temperature sampling per
    row: Gumbel-max over ``logits / temp`` with uniforms from the row's own
    generator (``jax.random.categorical``'s method, not its bits)."""
    tok = torch.argmax(logits, dim=-1)
    for b, (t, g) in enumerate(zip(temps, gens)):
        if t > 0 and g is not None:
            u = torch.rand(logits.shape[-1], generator=g, device=logits.device)
            u = u.clamp_min(torch.finfo(torch.float32).tiny)
            z = logits[b].float() / max(t, 1e-6) - torch.log(-torch.log(u))
            tok[b] = torch.argmax(z)
    return tok


def _inference(fn):
    """Run ``fn`` under ``torch.inference_mode`` (the decode state's
    tensors are inference tensors, updated in place)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapped


class TransformerDecoder:
    """KV-cached generation path over an initialized causal-LM
    ``ComputationGraph`` (on its device).

    ``max_batch`` rows of KV cache are preallocated; the cache LENGTH is
    bucketed (``kv_bucket_min`` doubling to ``max_len``) and grows with the
    longest live sequence. ``net.conf.use_kernels`` sends prefill attention
    through the flash kernel and each decode step's attention through the
    paged decode kernel.
    """

    def __init__(self, net, max_batch: int = 8, max_len: Optional[int] = None,
                 kv_bucket_min: int = 32, prompt_bucket_min: int = 8,
                 pad_id: int = 0):
        self._net = net
        if net.params is None:
            net.init()
        self.max_batch = int(max_batch)
        self.pad_id = int(pad_id)
        self.device = net.device
        self._dtype = net._dtype
        self.use_kernels = bool(getattr(net.conf, "use_kernels", False))
        conf = net.conf
        if len(conf.network_inputs) != 1 or len(conf.network_outputs) != 1:
            raise ValueError("KV-cached decode requires exactly one input "
                             "and one output vertex")
        self._input = conf.network_inputs[0]
        types = conf.vertex_output_types()
        self._plan = []
        self._attn: Dict[str, int] = {}  # name -> n_in (cache head dims)
        derived_max = None
        for name in net._topo:
            spec = net._vmap[name]
            layer = getattr(spec.vertex, "layer", None)
            if isinstance(layer, GlobalPoolingLayer):
                raise ValueError(
                    f"vertex {name!r} ({type(layer).__name__}) is not "
                    "supported in the KV-cached decode path")
            if isinstance(layer, SelfAttentionLayer):
                layer._decode_check()  # causal + projected, or raise
                self._attn[name] = types[spec.inputs[0]].size
                kind = "attn"
            elif isinstance(layer, PositionEmbeddingLayer):
                derived_max = layer.max_len if derived_max is None \
                    else min(derived_max, layer.max_len)
                kind = "pos"
            elif name in conf.network_outputs:
                if not isinstance(layer, OutputLayer):
                    raise ValueError("the output vertex must be an "
                                     "OutputLayer emitting vocab logits")
                kind = "head"
            else:
                kind = "gen"
            self._plan.append((kind, name, spec))
        if not self._attn:
            raise ValueError("graph has no causal SelfAttentionLayer — "
                             "nothing to KV-cache")
        first = self._plan[0]
        if tuple(first[2].inputs) != (self._input,) or not isinstance(
                getattr(first[2].vertex, "layer", None),
                EmbeddingSequenceLayer):
            raise ValueError("generation needs token-id inputs: the vertex "
                             "consuming the network input must be an "
                             "EmbeddingSequenceLayer (vocab_size > 0)")
        self.vocab_size = first[2].vertex.layer.n_in
        if max_len is None:
            max_len = derived_max
        if not max_len:
            raise ValueError("pass max_len= (no PositionEmbeddingLayer to "
                             "derive it from)")
        self.max_len = int(max_len if derived_max is None
                           else min(max_len, derived_max))
        self.kv_ladder = pow2_ladder(min(kv_bucket_min, self.max_len),
                                     self.max_len)
        self.prompt_ladder = pow2_ladder(min(prompt_bucket_min, self.max_len),
                                         self.max_len)
        self.join_ladder = pow2_ladder(1, self.max_batch)
        stateful = [n for _, n, _ in self._plan if net.state.get(n)]
        if stateful:
            raise ValueError(f"stateful layers unsupported in decode: "
                             f"{stateful}")

    # --- state --------------------------------------------------------------
    @_inference
    def new_state(self, s: int) -> dict:
        """Fresh decode state at KV bucket ``s``: zeroed caches and per-row
        scheduler arrays on the device (all rows inactive), plus the host
        lists ``temps_host`` and ``rng`` (per-row generators)."""
        b, dev = self.max_batch, self.device

        def full(v, dtype):
            return torch.full((b,), v, dtype=dtype, device=dev)

        caches = {name: self._layer(name).init_kv_cache(
            b, s, n_in, self._dtype, dev)
            for name, n_in in self._attn.items()}
        return {
            "caches": caches,
            "tokens": full(0, torch.long),
            "positions": full(0, torch.long),
            "prompt_lens": full(1, torch.long),
            "max_new": full(1, torch.long),
            "eos": full(-1, torch.long),
            "active": full(False, torch.bool),
            "temps_host": [0.0] * b,
            "rng": [None] * b,
        }

    def _layer(self, name):
        return self._net._vmap[name].vertex.layer

    @property
    def net(self):
        """The wrapped ComputationGraph (shares live params)."""
        return self._net

    @property
    def params(self):
        return self._net.params

    # --- model walks --------------------------------------------------------
    def _run_token(self, params, tokens, positions, caches):
        """One token per row through the graph against the caches:
        ``tokens [B]`` → (vocab logits ``[B, V]``, caches updated in
        place)."""
        acts = {self._input: tokens}
        logits = None
        for kind, name, spec in self._plan:
            xs = [acts[src] for src in spec.inputs]
            if kind == "attn":
                y, caches[name] = self._layer(name).decode_step(
                    params[name], xs[0], caches[name], positions,
                    use_kernels=self.use_kernels)
            elif kind == "pos":
                # a jnp gather clamps out-of-range positions
                idx = positions.clamp(0, self.max_len - 1)
                y = xs[0] + params[name]["P"][idx]
            elif kind == "head":
                logits = self._layer(name).pre_output(params[name], xs[0])
                continue
            else:
                y, _ = spec.vertex.forward(params.get(name, {}), {}, xs)
            acts[name] = y
        return logits, caches

    def _run_prompt(self, params, prompts, lengths):
        """Whole-prompt prefill walk: ``prompts [Bp, Tp]`` → (logits at
        each row's last valid position ``[Bp, V]``, per-layer kv blocks in
        cache layout). The head runs on those positions only (the JAX
        package computes every position's logits and then gathers)."""
        tp = prompts.shape[1]
        key_mask = (torch.arange(tp, device=prompts.device)[None, :]
                    < lengths[:, None]).to(self._dtype)
        acts = {self._input: prompts}
        kv = {}
        logits = None
        for kind, name, spec in self._plan:
            xs = [acts[src] for src in spec.inputs]
            if kind == "attn":
                y, k, v = self._layer(name).prefill(
                    params[name], xs[0], key_mask,
                    use_kernels=self.use_kernels)
                kv[name] = {"k": k, "v": v}
            elif kind == "head":
                idx = (lengths - 1).clamp_min(0)
                last = xs[0][torch.arange(xs[0].shape[0],
                                          device=idx.device), idx]
                logits = self._layer(name).pre_output(params[name], last)
                continue
            else:  # pos + generic both run the ordinary layer forward
                y, _ = spec.vertex.forward(params.get(name, {}), {}, xs)
            acts[name] = y
        return logits, kv

    # --- steps ----------------------------------------------------------------
    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=self.device,
                                                 dtype=dtype)

    def decode_fn(self, s: int, k: int):
        """K decode steps at KV bucket ``s``: ``fn(params, state) ->
        (state, tokens [K, B], emitted [K, B])``, state updated in place;
        finished rows stop advancing (their token and position freeze).
        ``emitted[i, b]`` is True where row b was live going into step i
        (the host appends exactly those tokens)."""
        return functools.partial(self._decode_window, k=int(k))

    @_inference
    def _decode_window(self, params, state, k):
        st = state
        toks, emitted = [], []
        for _ in range(k):
            active = st["active"]
            logits, _ = self._run_token(params, st["tokens"], st["positions"],
                                        st["caches"])
            tok = _sample_tokens(logits, st["temps_host"], st["rng"])
            tok = torch.where(active, tok, st["tokens"])
            new_pos = st["positions"] + active.long()
            gen = new_pos - st["prompt_lens"] + 1
            st["active"] = active & (tok != st["eos"]) & (gen < st["max_new"])
            st["tokens"], st["positions"] = tok, new_pos
            toks.append(tok)
            emitted.append(active)
        return st, torch.stack(toks), torch.stack(emitted)

    def prompt_fn(self, tp: int, bp: int):
        """Prefill of a ``[bp, tp]`` join group: ``fn(params, prompts,
        lengths, max_new, eos, temps, rng) -> (kv, first tokens, active,
        rng)``; rows whose first token is EOS or whose ``max_new == 1`` are
        born retired. ``rng``: the rows' generators (None for greedy)."""
        return self._prompt

    @_inference
    def _prompt(self, params, prompts, lengths, max_new, eos, temps, rng):
        prompts = self._tensor(prompts, torch.long)
        lengths = self._tensor(lengths, torch.long)
        logits, kv = self._run_prompt(params, prompts, lengths)
        tok = _sample_tokens(logits, [float(t) for t in np.asarray(temps)],
                             list(rng))
        active = ((tok != self._tensor(eos, torch.long))
                  & (self._tensor(max_new, torch.long) > 1))
        return kv, tok, active, rng

    def join_fn(self, s: int, tp: int, bp: int):
        """Write a prefilled group into the running state at ``rows`` (host
        ints; rows ``>= max_batch`` are padding and dropped, as the JAX
        scatter's ``mode="drop"``): ``fn(state, kv, rows, tok, lengths,
        max_new, eos, temps, rng, active) -> state``. A row's cache slots
        past the prompt bucket are zeroed."""
        return functools.partial(self._join, tp=int(tp))

    @_inference
    def _join(self, state, kv, rows, tok, lengths, max_new, eos, temps, rng,
              active, tp):
        rows = np.asarray(rows).reshape(-1)
        keep = np.nonzero(rows < self.max_batch)[0]
        if keep.size == 0:
            return state
        dst = torch.as_tensor(rows[keep], dtype=torch.long, device=self.device)
        src = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        for name, c in state["caches"].items():
            for key in ("k", "v"):
                c[key][dst, :tp] = kv[name][key][src].to(c[key].dtype)
                c[key][dst, tp:] = 0
        lengths_t = self._tensor(lengths, torch.long)[src]
        state["tokens"][dst] = torch.as_tensor(tok, device=self.device)[src]
        state["positions"][dst] = lengths_t
        state["prompt_lens"][dst] = lengths_t.clamp_min(1)
        state["max_new"][dst] = self._tensor(max_new, torch.long)[src]
        state["eos"][dst] = self._tensor(eos, torch.long)[src]
        state["active"][dst] = torch.as_tensor(active,
                                               device=self.device)[src]
        temps = np.asarray(temps)
        for i in keep:
            state["temps_host"][rows[i]] = float(temps[i])
            state["rng"][rows[i]] = rng[i]
        return state

    def grow_fn(self, s: int, s2: int):
        """Pad every cache from KV bucket ``s`` to ``s2`` with zeros:
        ``fn(state) -> state`` with new cache tensors (the old ones are
        freed when the caller drops them)."""
        return functools.partial(self._grow, s2=int(s2))

    @_inference
    def _grow(self, state, s2):
        caches = {}
        for name, c in state["caches"].items():
            caches[name] = {}
            for key in ("k", "v"):
                b, s, h, d = c[key].shape
                t = c[key].new_zeros((b, s2, h, d))
                t[:, :s] = c[key]
                caches[name][key] = t
        return dict(state, caches=caches)

    def release_fn(self, s: int):
        """Deactivate rows (deadline aborts): ``fn(state, keep) -> state``
        with ``active &= keep``."""
        return self._release

    @_inference
    def _release(self, state, keep):
        state["active"] &= self._tensor(keep, torch.bool)
        return state

    # --- warmup -------------------------------------------------------------
    def warmup(self, prompt_buckets=None, join_buckets=None, kv_buckets=None,
               fused_steps=(1,)) -> dict:
        """Run one prefill per (prompt bucket, join bucket) and one decode
        window per (KV bucket, K) on zero prompts, so the first request of
        each shape finds the kernel libraries built and cuBLAS's workspaces
        allocated (eager PyTorch has no executables to compile). The
        defaults are every bucket of the ladders."""
        pbs = list(prompt_buckets or self.prompt_ladder)
        jbs = list(join_buckets or self.join_ladder)
        kbs = list(kv_buckets or self.kv_ladder)
        params = self._net.params
        for tp in pbs:
            for bp in jbs:
                ones = np.ones((bp,), np.int64)
                self.prompt_fn(tp, bp)(
                    params, np.full((bp, tp), self.pad_id, np.int64),
                    ones * tp, ones * 2, -ones, np.zeros((bp,)), [None] * bp)
        for s in kbs:
            state = self.new_state(s)
            for k in fused_steps:
                self.decode_fn(s, int(k))(params, state)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return {"prompt_buckets": pbs, "join_buckets": jbs, "kv_buckets": kbs,
                "fused_steps": [int(k) for k in fused_steps]}

    # --- sequential reference ----------------------------------------------
    def validate_request(self, tokens, max_new: int):
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if not toks:
            raise ValueError("prompt must contain at least one token")
        if any(t < 0 or t >= self.vocab_size for t in toks):
            raise ValueError(f"token ids must be in [0, {self.vocab_size})")
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(toks) + max_new > self.max_len:
            raise ValueError(
                f"prompt ({len(toks)}) + max_new_tokens ({max_new}) "
                f"exceeds max_len={self.max_len}")
        return toks

    def generate(self, tokens, max_new: int, eos_id: Optional[int] = None,
                 temperature: float = 0.0, seed: int = 0,
                 fused_steps: int = 1) -> List[int]:
        """Sequential single-request generation through the same steps the
        continuous engine uses (one live row, the other ``max_batch - 1``
        rows inactive): the reference the engine is held to."""
        toks = self.validate_request(tokens, max_new)
        ln = len(toks)
        tp = bucket_for(ln, self.prompt_ladder)
        # the KV bucket covers the prompt bucket too: the join writes the
        # [tp]-long prompt KV into the [s]-long cache
        s = bucket_for(max(min(ln + max_new, self.max_len), tp),
                       self.kv_ladder)
        state = self.new_state(s)
        prompts = np.full((1, tp), self.pad_id, np.int64)
        prompts[0, :ln] = toks
        rng = [request_generator(seed, self.device)
               if temperature > 0 else None]
        eos = np.asarray([-1 if eos_id is None else int(eos_id)])
        lengths = np.asarray([ln])
        mn = np.asarray([int(max_new)])
        temps = np.asarray([float(temperature)])
        params = self._net.params
        kv, tok, active, rng2 = self.prompt_fn(tp, 1)(
            params, prompts, lengths, mn, eos, temps, rng)
        state = self.join_fn(s, tp, 1)(state, kv, np.asarray([0]), tok,
                                       lengths, mn, eos, temps, rng2, active)
        out = [int(tok[0])]
        alive = bool(active[0])
        step = self.decode_fn(s, int(fused_steps))
        while alive:
            state, toks_w, emitted = step(params, state)
            toks_w = toks_w.cpu().numpy()
            emitted = emitted.cpu().numpy()
            for i in range(toks_w.shape[0]):
                if not emitted[i, 0]:
                    alive = False
                    break
                t = int(toks_w[i, 0])
                out.append(t)
                if (eos_id is not None and t == eos_id) \
                        or len(out) >= max_new:
                    alive = False
                    break
        return out
