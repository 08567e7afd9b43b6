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

Two serving features ride on these: speculative decoding (``spec_draft_fn``
runs a draft decoder's window from the target's cursor, ``spec_verify_fn``
scores the K drafted tokens in one wide step and emits what the target's
own sampling rule gives) and the prefix cache (``prefix_attach_fn`` copies
cached KV pages into a row, ``suffix_prompt_fn`` prefills only the
prompt's suffix against them, ``suffix_join_fn`` writes the suffix behind
the prefix).

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
  emitted token, so a row's tokens never depend on its co-tenants; the
  verifier draws for each of its K+1 positions and then puts the
  generator back to its state after the emitted ones, so a speculated
  stream is the sequential one.

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
from deeplearning4j_tpu_torch.conf.layers_attention import (
    LearnedSelfAttentionLayer,
    RecurrentAttentionLayer,
    SelfAttentionLayer,
)
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


# the JAX decoder's refusals: pooling and learned-query attention do not
# decode token by token, recurrent attention and every carry-bearing vertex
# (recurrent layers, a streaming AttentionVertex) keep state the KV cache
# does not hold
_REFUSED = (GlobalPoolingLayer, LearnedSelfAttentionLayer,
            RecurrentAttentionLayer)


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
            if isinstance(layer, _REFUSED) or getattr(spec.vertex,
                                                      "has_carry", False):
                raise ValueError(
                    f"vertex {name!r} ({type(layer or spec.vertex).__name__})"
                    " is not supported in the KV-cached decode path")
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

    def _ktag(self) -> str:
        """The wrapped graph's kernel-registry tag (``kernels.cache_tag``;
        empty unless ``conf.use_kernels``): a retune changes it, and the
        next prefill or decode step resolves the new winners."""
        return self._net._ktag()

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

    def _run_chunk(self, params, tokens, positions, caches):
        """A ``[B, T]`` window of tokens through the graph against the
        caches in one wide step: token ``i`` of row ``b`` sits at slot
        ``positions[b] + i``. Returns (per-position logits ``[B, T, V]``,
        caches updated in place); the speculative verifier scores every
        drafted position from one call."""
        t = tokens.shape[1]
        acts = {self._input: tokens}
        logits = None
        for kind, name, spec in self._plan:
            xs = [acts[src] for src in spec.inputs]
            if kind == "attn":
                y, caches[name] = self._layer(name).decode_chunk(
                    params[name], xs[0], caches[name], positions)
            elif kind == "pos":
                idx = (positions[:, None]
                       + torch.arange(t, device=positions.device)[None, :])
                y = xs[0] + params[name]["P"][idx.clamp(0, self.max_len - 1)]
            elif kind == "head":
                logits = self._layer(name).pre_output(params[name], xs[0])
                continue
            else:
                y, _ = spec.vertex.forward(params.get(name, {}), {}, xs)
            acts[name] = y
        return logits, caches

    def _run_suffix(self, params, suffix, suf_lens, prefix_kv, prefix_lens):
        """Prompt-suffix prefill walk against cached prefix KV pages:
        ``suffix [Bp, Ts]`` holds each prompt's uncached tail,
        ``prefix_kv[name]{k,v} [Bp, Tpre, heads, hd]`` the pages (valid up
        to ``prefix_lens[b]``). Position embeddings are gathered at the
        suffix tokens' true positions (``prefix_lens + i``) and every
        attention layer attends ``[prefix ; suffix]``. Returns (logits at
        each row's last valid suffix position ``[Bp, V]``, suffix-only kv
        blocks)."""
        ts = suffix.shape[1]
        tpre = next(iter(prefix_kv.values()))["k"].shape[1]
        dev = suffix.device
        key_mask = (torch.arange(ts, device=dev)[None, :]
                    < suf_lens[:, None]).to(self._dtype)
        prefix_mask = (torch.arange(tpre, device=dev)[None, :]
                       < prefix_lens[:, None]).to(self._dtype)
        acts = {self._input: suffix}
        kv = {}
        logits = None
        for kind, name, spec in self._plan:
            xs = [acts[src] for src in spec.inputs]
            if kind == "attn":
                y, k, v = self._layer(name).prefill_suffix(
                    params[name], xs[0], prefix_kv[name]["k"],
                    prefix_kv[name]["v"], prefix_mask, key_mask,
                    use_kernels=self.use_kernels)
                kv[name] = {"k": k, "v": v}
            elif kind == "pos":
                idx = (prefix_lens[:, None]
                       + torch.arange(ts, device=dev)[None, :])
                y = xs[0] + params[name]["P"][idx.clamp(0, self.max_len - 1)]
            elif kind == "head":
                idx = (suf_lens - 1).clamp_min(0)
                last = xs[0][torch.arange(xs[0].shape[0], device=dev), idx]
                logits = self._layer(name).pre_output(params[name], last)
                continue
            else:
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
        rows, keep, dst, src = self._kept_rows(rows)
        if keep.size == 0:
            return state
        for name, c in state["caches"].items():
            for key in ("k", "v"):
                c[key][dst, :tp] = kv[name][key][src].to(c[key].dtype)
                c[key][dst, tp:] = 0
        return self._seed_rows(state, rows, keep, dst, src, tok, lengths,
                               max_new, eos, temps, rng, active)

    def _kept_rows(self, rows):
        """Host row indices, the kept group slots (rows ``>= max_batch``
        are padding and dropped, as the JAX scatter's ``mode="drop"``), and
        both as device index tensors (``dst`` rows, ``src`` slots)."""
        rows = np.asarray(rows).reshape(-1)
        keep = np.nonzero(rows < self.max_batch)[0]
        dst = torch.as_tensor(rows[keep], dtype=torch.long, device=self.device)
        src = torch.as_tensor(keep, dtype=torch.long, device=self.device)
        return rows, keep, dst, src

    def _seed_rows(self, state, rows, keep, dst, src, tok, lengths, max_new,
                   eos, temps, rng, active):
        """Seed the joined rows' scheduler arrays: the first token, the
        position and prompt length (the whole prompt's), max_new, eos,
        liveness, temperature and generator."""
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

    # --- speculative decoding (draft K, verify K+1 in one step) -----------
    def spec_draft_fn(self, s: int, k: int):
        """The draft side of a speculative iteration: ``fn(params, state,
        tokens, positions, active) -> (state, drafts [K, B], emitted)``
        sets the draft's cursor to the target's (``tokens``, ``positions``,
        ``active`` come from the target's state and are copied, never
        aliased) and runs the K-step window from there. The draft's k/v
        for accepted slots are already right (an accepted draft token is
        the emitted token), so the sync is pure bookkeeping."""
        return functools.partial(self._spec_draft, k=int(k))

    @_inference
    def _spec_draft(self, params, state, tokens, positions, active, k):
        self._spec_sync(state, tokens, positions, active)
        return self._decode_window(params, state, k)

    def spec_sync_fn(self, s: int):
        """Set a draft state's cursor to the target's: ``fn(state, tokens,
        positions, active) -> state`` (copies; caches untouched)."""
        return self._spec_sync

    @_inference
    def _spec_sync(self, state, tokens, positions, active):
        state["tokens"] = tokens.clone()
        state["positions"] = positions.clone()
        state["active"] = active.clone()
        return state

    def spec_verify_fn(self, s: int, k: int):
        """The verifier: ``fn(params, state, drafts [K, B]) -> (state,
        tokens [K+1, B], emitted [K+1, B], accepted [B])``. The window
        ``[current token ; drafts]`` goes through :meth:`_run_chunk` in one
        step; position ``i`` emits the token the TARGET samples there
        (greedy, or a draw from the row's own generator, the rule
        sequential decode applies), and emission goes on only while the
        draft agreed at every earlier position and the row is live, so the
        stream is the non-speculative one at any acceptance rate. All K+1
        k/v blocks are written; ``positions`` advances by the emitted
        count, and a sampled row's generator is set back to its state after
        exactly that many draws. ``accepted`` counts the drafted tokens
        that survived (emitted less the always-emitted first)."""
        return functools.partial(self._spec_verify, k=int(k))

    @_inference
    def _spec_verify(self, params, state, drafts, k):
        w = k + 1
        active, p0 = state["active"], state["positions"]
        drafts = torch.as_tensor(drafts, device=self.device).long()
        window = torch.cat([state["tokens"][:, None], drafts.t()], dim=1)
        logits, _ = self._run_chunk(params, window, p0, state["caches"])
        temps, gens = state["temps_host"], state["rng"]
        sampled = [b for b, (t, g) in enumerate(zip(temps, gens))
                   if t > 0 and g is not None]
        # one draw per position, one position at a time: a single draw of
        # (K+1)·V uniforms would not reproduce K+1 separate draws
        snaps = {b: [gens[b].get_state()] for b in sampled}
        tstar = []
        for i in range(w):
            tstar.append(_sample_tokens(logits[:, i], temps, gens))
            for b in sampled:
                snaps[b].append(gens[b].get_state())
        tstar = torch.stack(tstar)  # [K+1, B]
        a = torch.cumprod((drafts == tstar[:k]).long(), dim=0).sum(dim=0)
        emit, emits = active, []
        for i in range(w):
            if i > 0:
                gen_prev = p0 + i + 1 - state["prompt_lens"]
                emit = (emit & (a >= i) & (tstar[i - 1] != state["eos"])
                        & (gen_prev < state["max_new"]))
            emits.append(emit)
        emitted = torch.stack(emits)  # [K+1, B]
        e = emitted.long().sum(dim=0)
        positions = p0 + e
        last = tstar.gather(0, (e - 1).clamp_min(0)[None])[0]
        tokens = torch.where(e > 0, last, state["tokens"])
        gen_now = positions - state["prompt_lens"] + 1
        state["active"] = ((e > 0) & (tokens != state["eos"])
                           & (gen_now < state["max_new"]))
        state["tokens"], state["positions"] = tokens, positions
        if sampled:
            e_host = e.cpu()
            for b in sampled:
                gens[b].set_state(snaps[b][int(e_host[b])])
        return state, tstar, emitted, (e - 1).clamp_min(0)

    # --- prefix cache -------------------------------------------------------
    def prefix_attach_fn(self, s: int, tpre: int, bp: int):
        """Copy cached prefix pages into joining rows: ``fn(state,
        prefix_kv, rows, prefix_lens) -> state`` writes ``prefix_kv[name]
        {k,v} [bp, tpre, heads, hd]`` into slots ``[0, tpre)`` of each kept
        row (a copy: the cache keeps its pages) and sets the row's position
        to its prefix length."""
        return functools.partial(self._prefix_attach, tpre=int(tpre))

    @_inference
    def _prefix_attach(self, state, prefix_kv, rows, prefix_lens, tpre):
        rows, keep, dst, src = self._kept_rows(rows)
        if keep.size == 0:
            return state
        for name, c in state["caches"].items():
            for key in ("k", "v"):
                c[key][dst, :tpre] = prefix_kv[name][key][src].to(c[key].dtype)
        state["positions"][dst] = self._tensor(prefix_lens, torch.long)[src]
        return state

    def suffix_prompt_fn(self, ts: int, tpre: int, bp: int):
        """Suffix-only prefill of a prefix-cache hit group: like
        :meth:`prompt_fn` over ``[bp, ts]`` suffix tokens attending the
        prefix pages (:meth:`_run_suffix`): ``fn(params, suffix, suf_lens,
        prefix_kv, prefix_lens, max_new, eos, temps, rng) -> (suffix kv,
        first tokens, active, rng)``."""
        return self._suffix_prompt

    @_inference
    def _suffix_prompt(self, params, suffix, suf_lens, prefix_kv,
                       prefix_lens, max_new, eos, temps, rng):
        logits, kv = self._run_suffix(
            params, self._tensor(suffix, torch.long),
            self._tensor(suf_lens, torch.long), prefix_kv,
            self._tensor(prefix_lens, torch.long))
        tok = _sample_tokens(logits, [float(t) for t in np.asarray(temps)],
                             list(rng))
        active = ((tok != self._tensor(eos, torch.long))
                  & (self._tensor(max_new, torch.long) > 1))
        return kv, tok, active, rng

    def suffix_join_fn(self, s: int, ts: int, bp: int):
        """Join a suffix-prefilled group behind its attached prefix:
        ``fn(state, kv, rows, tok, prefix_lens, lengths, max_new, eos,
        temps, rng, active) -> state`` writes row ``i``'s suffix block at
        its own offset ``prefix_lens[i]`` (clamped to ``[0, s - ts]``, as
        ``dynamic_update_slice``) and seeds the row as :meth:`join_fn` does,
        with the position at the whole prompt's length. Padding slots
        (rows ``>= max_batch``) are dropped."""
        return functools.partial(self._suffix_join, ts=int(ts))

    @_inference
    def _suffix_join(self, state, kv, rows, tok, prefix_lens, lengths,
                     max_new, eos, temps, rng, active, ts):
        rows, keep, dst, src = self._kept_rows(rows)
        if keep.size == 0:
            return state
        s = next(iter(state["caches"].values()))["k"].shape[1]
        off = self._tensor(np.asarray(prefix_lens).reshape(-1)[keep],
                           torch.long).clamp(0, s - ts)
        slots = off[:, None] + torch.arange(ts, device=self.device)[None, :]
        for name, c in state["caches"].items():
            for key in ("k", "v"):
                c[key][dst[:, None], slots] = kv[name][key][src].to(
                    c[key].dtype)
        return self._seed_rows(state, rows, keep, dst, src, tok, lengths,
                               max_new, eos, temps, rng, active)

    # --- warmup -------------------------------------------------------------
    def _ladder_floor(self, ladder: List[int], b: int) -> int:
        """Smallest real length that maps to bucket ``b`` (one past the
        previous ladder entry; 1 for the first)."""
        i = ladder.index(b)
        return 1 if i == 0 else ladder[i - 1] + 1

    def warmup(self, prompt_buckets=None, join_buckets=None, kv_buckets=None,
               fused_steps=(1,), spec_steps=(), spec_draft=(),
               prefix=False) -> dict:
        """Run one prefill per (prompt bucket, join bucket) and one decode
        window per (KV bucket, K) on zero prompts, so the first request of
        each shape finds the kernel libraries built and cuBLAS's workspaces
        allocated (eager PyTorch has no executables to compile). The
        defaults are every bucket of the ladders. ``spec_steps`` adds one
        verify window per KV bucket that holds K+1 slots, ``spec_draft`` one
        draft window per KV bucket, and ``prefix`` one suffix prefill per
        feasible (prefix bucket, suffix bucket) pair of the prompt buckets
        (some real prefix and suffix lengths map to it within ``max_len``),
        padded to ``max_batch`` rows as the engine pads them."""
        pbs = list(prompt_buckets or self.prompt_ladder)
        jbs = list(join_buckets or self.join_ladder)
        kbs = list(kv_buckets or self.kv_ladder)
        params = self._net.params
        nb = self.max_batch
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
            for k in spec_steps:
                if s >= int(k) + 1:  # the engine never verifies past S
                    self.spec_verify_fn(s, int(k))(
                        params, state, torch.zeros((int(k), nb),
                                                   dtype=torch.long,
                                                   device=self.device))
            for k in spec_draft:
                self.spec_draft_fn(s, int(k))(
                    params, state, state["tokens"], state["positions"],
                    state["active"])
        pairs = []
        if prefix:
            ones = np.ones((nb,), np.int64)
            for tpre in pbs:
                m = self._ladder_floor(self.prompt_ladder, tpre)
                pkv = {name: {key: torch.zeros(
                    (nb, tpre, self._layer(name).n_heads,
                     self._layer(name)._head_size(n_in)),
                    dtype=self._dtype, device=self.device)
                    for key in ("k", "v")}
                    for name, n_in in self._attn.items()}
                for ts in pbs:
                    if m + self._ladder_floor(self.prompt_ladder, ts) \
                            > self.max_len:
                        continue
                    self.suffix_prompt_fn(ts, tpre, nb)(
                        params, np.full((nb, ts), self.pad_id, np.int64),
                        ones * ts, pkv, ones * m, ones * 2, -ones,
                        np.zeros((nb,)), [None] * nb)
                    pairs.append((tpre, ts))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {"prompt_buckets": pbs, "join_buckets": jbs, "kv_buckets": kbs,
               "fused_steps": [int(k) for k in fused_steps]}
        if spec_steps:
            out["spec_steps"] = [int(k) for k in spec_steps]
        if spec_draft:
            out["spec_draft"] = [int(k) for k in spec_draft]
        if prefix:
            out["prefix"] = pairs  # (prefix bucket, suffix bucket)
        return out

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
