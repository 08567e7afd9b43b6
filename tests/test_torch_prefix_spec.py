"""The port's prefix cache and speculative decoding against the JAX package,
on the CPU.

The small causal language model of ``test_torch_decoding.py`` (vocab 64,
width 32, 4 heads, 2 blocks, max_len 64) is built by the JAX package's
``TransformerEncoder``; the port loads its configuration JSON and weights
(``util.convert.params_from_jax``). Held against the JAX package's stock
route: ``chunk_decode_attention``, ``SelfAttentionLayer.decode_chunk`` and
``prefill_suffix`` (a holed prefix mask and a fully masked padding row; the
port's flash route too, whose wrapper runs its plain version on the CPU),
and the decoder walks ``_run_chunk`` / ``_run_suffix`` (logits and kv).
Then the JAX package's engine tests re-run on the port: the radix trie,
prefix hits token-identical to a cold miss and to sequential ``generate``,
pins released on every terminal edge, speculative greedy streams with an
oracle and a disagreeing draft, seeded sampling through the verifier equal
to the port's sequential sampler, the fallback window at the context edge,
the draft geometry check and the telemetry series.

Tolerances: float32, atol = rtol = 1e-4 on logits and layer outputs, as
``test_torch_decoding.py``. Streams within the port are compared exactly
(the same arithmetic on the CPU); the port's engine against the JAX
decoder under that file's near-tie rule.
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops.attention import (
    chunk_decode_attention as j_chunk_decode_attention,
)
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops.attention import chunk_decode_attention
from deeplearning4j_tpu_torch.parallel.batcher import DeadlineExpiredError
from deeplearning4j_tpu_torch.parallel.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.parallel.prefix_cache import PrefixCache
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan
from deeplearning4j_tpu_torch.telemetry import REGISTRY
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    params_from_jax,
)
from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

VOCAB, E, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 64
HS = E // HEADS
MAX_BATCH, K = 4, 2
LOGIT_ATOL = 1e-4
TOL = dict(atol=LOGIT_ATOL, rtol=LOGIT_ATOL)
DEC_KW = dict(max_batch=MAX_BATCH, kv_bucket_min=16, prompt_bucket_min=4)


def _zoo(cls, **kw):
    kw.setdefault("n_layers", LAYERS)
    kw.setdefault("seed", 7)
    return cls(vocab_size=VOCAB, embed_dim=E, n_heads=HEADS,
               max_len=MAX_LEN, causal=True, lm_head=True, **kw)


@functools.lru_cache(maxsize=None)
def _jax_net():
    """The JAX reference network, LN gains and attention biases spread so
    that no layer is an identity."""
    net = _zoo(JTransformer).init()
    rng = np.random.default_rng(0)
    for p in net.params.values():
        if "gain" in p:
            p["gain"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal(
                p["gain"].shape), jnp.float32)
            p["b"] = jnp.asarray(0.1 * rng.standard_normal(p["b"].shape),
                                 jnp.float32)
        for key in ("bq", "bk", "bv", "bo"):
            if key in p:
                p[key] = jnp.asarray(0.1 * rng.standard_normal(p[key].shape),
                                     jnp.float32)
    return net


def _np_tree(tree):
    return {k: {pk: np.asarray(v) for pk, v in vp.items()}
            for k, vp in tree.items()}


def _port_net(use_kernels=False):
    jnet = _jax_net()
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    conf.use_kernels = use_kernels
    net = ComputationGraph(conf, device="cpu")
    return net.set_params(*params_from_jax(conf, _np_tree(jnet.params),
                                           _np_tree(jnet.state)))


@functools.lru_cache(maxsize=None)
def _decoder(use_kernels=False):
    return TransformerDecoder(_port_net(use_kernels), max_len=MAX_LEN,
                              **DEC_KW)


@functools.lru_cache(maxsize=None)
def _oracle_draft():
    """The target's weights in a decoder of its own: it agrees with the
    target at every position."""
    return TransformerDecoder(_port_net(), max_len=MAX_LEN, **DEC_KW)


@functools.lru_cache(maxsize=None)
def _draft_decoder():
    """A 1-layer draft with the target's bucket geometry and its own seed:
    it disagrees with the target nearly everywhere."""
    return _zoo(TransformerEncoder, n_layers=1, seed=99).decoder(
        device="cpu", **DEC_KW)


@functools.lru_cache(maxsize=None)
def _jax_decoder():
    return _zoo(JTransformer).decoder(net=_jax_net(), **DEC_KW)


def _layer_pair(name):
    jnet, net = _jax_net(), _port_net()
    jl = jnet.conf.vertex_map()[name].vertex.layer
    pl = net.conf.vertex_map()[name].vertex.layer
    jp = _np_tree({name: jnet.params[name]})[name]
    return jl, jnet.params[name], pl, convert_layer_params(pl, jp)


def _engine(**over):
    cfg = dict(max_batch=MAX_BATCH, fused_steps=K, kv_bucket_min=16,
               prompt_bucket_min=4)
    cfg.update(over)
    return GenerationEngine(_decoder(), GenerationConfig(**cfg))


def _pinned(pc):
    with pc._lock:
        total, stack = 0, [pc._root]
        while stack:
            nd = stack.pop()
            for ch in nd.children.values():
                stack.append(ch)
                total += ch.refs
        return total


# --- attention and the layer -------------------------------------------------

@pytest.mark.parametrize("t", [1, 3])
def test_chunk_decode_attention_matches_jax(t):
    rng = np.random.default_rng(20 + t)
    q = rng.standard_normal((4, t, HEADS, HS)).astype(np.float32)
    kc, vc = (rng.standard_normal((4, 16, HEADS, HS)).astype(np.float32)
              for _ in range(2))
    pos = np.asarray([0, 5, 16 - t, 13], np.int32)
    ref = j_chunk_decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos))
    got = chunk_decode_attention(torch.tensor(q), torch.tensor(kc),
                                 torch.tensor(vc), torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_decode_chunk_matches_jax_and_writes_in_place():
    rng = np.random.default_rng(21)
    x = rng.standard_normal((4, 3, E)).astype(np.float32)
    kc, vc = (rng.standard_normal((4, 16, HEADS, HS)).astype(np.float32)
              for _ in range(2))
    pos = np.asarray([0, 6, 13, 15], np.int32)  # 15: the write clamps
    jl, jp, pl, pp = _layer_pair("b1_attn")
    ref, rc = jl.decode_chunk(jp, jnp.asarray(x), {"k": jnp.asarray(kc),
                                                   "v": jnp.asarray(vc)},
                              jnp.asarray(pos))
    cache = {"k": torch.tensor(kc), "v": torch.tensor(vc)}
    got, gc = pl.decode_chunk(pp, torch.tensor(x), cache, torch.tensor(pos))
    assert gc is cache
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(gc["k"].numpy(), np.asarray(rc["k"]), **TOL)
    np.testing.assert_allclose(gc["v"].numpy(), np.asarray(rc["v"]), **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_prefill_suffix_matches_jax(use_kernels):
    """A holed key mask (prefix valid to each row's length, padding up to
    Tpre, then the suffix) and a fully masked padding row (row 3)."""
    rng = np.random.default_rng(22)
    b, ts, tpre = 4, 5, 8
    x = rng.standard_normal((b, ts, E)).astype(np.float32)
    pk, pv = (rng.standard_normal((b, tpre, HEADS, HS)).astype(np.float32)
              for _ in range(2))
    pmask = (np.arange(tpre)[None, :] < np.asarray([8, 4, 1, 0])[:, None]
             ).astype(np.float32)
    kmask = (np.arange(ts)[None, :] < np.asarray([5, 3, 1, 0])[:, None]
             ).astype(np.float32)
    jl, jp, pl, pp = _layer_pair("b0_attn")
    ry, rk, rv = jl.prefill_suffix(jp, jnp.asarray(x), jnp.asarray(pk),
                                   jnp.asarray(pv), jnp.asarray(pmask),
                                   jnp.asarray(kmask))
    gy, gk, gv = pl.prefill_suffix(pp, torch.tensor(x), torch.tensor(pk),
                                   torch.tensor(pv), torch.tensor(pmask),
                                   torch.tensor(kmask),
                                   use_kernels=use_kernels)
    assert torch.isfinite(gy).all()
    assert torch.all(gy[3] == 0)  # the padding row is zeroed
    np.testing.assert_allclose(gy.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), **TOL)
    assert gk.shape == (b, ts, HEADS, HS)  # the suffix's own k/v


def test_prefill_suffix_equals_prefill_of_the_whole_prompt():
    """Prefix pages from a prefill plus the suffix through
    ``prefill_suffix`` give the whole prompt's prefill on the suffix."""
    rng = np.random.default_rng(23)
    x = torch.tensor(rng.standard_normal((2, 12, E)).astype(np.float32))
    _, _, pl, pp = _layer_pair("b1_attn")
    y, k, v = pl.prefill(pp, x)
    ys, ks, vs = pl.prefill_suffix(pp, x[:, 8:], k[:, :8], v[:, :8],
                                   torch.ones(2, 8))
    np.testing.assert_allclose(ys.numpy(), y[:, 8:].numpy(), **TOL)
    assert torch.allclose(ks, k[:, 8:]) and torch.allclose(vs, v[:, 8:])
    assert pl.streaming_safe() is False


# --- the decoder walks -------------------------------------------------------

def test_run_chunk_matches_jax():
    jd, pd = _jax_decoder(), _decoder()
    rng = np.random.default_rng(24)
    toks = rng.integers(0, VOCAB, (MAX_BATCH, K + 1))
    pos = np.asarray([0, 7, 13, MAX_LEN - 1])  # the last gathers clamped
    jst, st = jd.new_state(16), pd.new_state(16)
    seed = rng.standard_normal((MAX_BATCH, 16, HEADS, HS)).astype(np.float32)
    jc = {n: {"k": jnp.asarray(seed), "v": jnp.asarray(-seed)}
          for n in jst["caches"]}
    with torch.inference_mode():
        for c in st["caches"].values():
            c["k"].copy_(torch.tensor(seed))
            c["v"].copy_(torch.tensor(-seed))
        got, gc = pd._run_chunk(pd.params, torch.tensor(toks),
                                torch.tensor(pos), st["caches"])
    ref, rc = jd._run_chunk(jd.params, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos, jnp.int32), jc)
    assert got.shape == (MAX_BATCH, K + 1, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for name in rc:
        for key in ("k", "v"):
            np.testing.assert_allclose(gc[name][key].numpy(),
                                       np.asarray(rc[name][key]), **TOL)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_run_suffix_matches_jax(use_kernels):
    """Suffixes against prefix pages from the JAX prefill: per-row prefix
    lengths below the page block (a hole), and a padding row."""
    jd, pd = _jax_decoder(), _decoder(use_kernels)
    rng = np.random.default_rng(25)
    tpre, ts = 16, 8
    prompts = rng.integers(0, VOCAB, (MAX_BATCH, tpre))
    plens = np.asarray([16, 12, 5, 0])
    slens = np.asarray([8, 3, 6, 0])
    _, jkv = jd._run_prompt(jd.params, jnp.asarray(prompts, jnp.int32),
                            jnp.asarray(plens, jnp.int32))
    suffix = rng.integers(0, VOCAB, (MAX_BATCH, ts))
    ref, rkv = jd._run_suffix(jd.params, jnp.asarray(suffix, jnp.int32),
                              jnp.asarray(slens, jnp.int32), jkv,
                              jnp.asarray(plens, jnp.int32))
    pkv = {n: {k: torch.tensor(np.asarray(b[k])) for k in ("k", "v")}
           for n, b in jkv.items()}
    with torch.inference_mode():
        got, gkv = pd._run_suffix(pd.params, torch.tensor(suffix),
                                  torch.tensor(slens), pkv,
                                  torch.tensor(plens))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(ref)[:3], **TOL)
    for name in rkv:
        for key in ("k", "v"):
            np.testing.assert_allclose(gkv[name][key].numpy()[:3],
                                       np.asarray(rkv[name][key])[:3], **TOL)


def test_suffix_logits_equal_the_whole_prompts_prefill():
    pd = _decoder()
    rng = np.random.default_rng(26)
    prompts = torch.tensor(rng.integers(0, VOCAB, (2, 14)))
    lengths = torch.tensor([14, 11])
    with torch.inference_mode():
        want, _ = pd._run_prompt(pd.params, prompts, lengths)
        _, pkv = pd._run_prompt(pd.params, prompts[:, :8],
                                torch.tensor([8, 8]))
        got, _ = pd._run_suffix(pd.params, prompts[:, 8:], lengths - 8, pkv,
                                torch.tensor([8, 8]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# --- the decoder's steps ------------------------------------------------------

def test_spec_verify_restores_each_sampled_generator():
    """A sampled row's generator ends in the state after exactly the
    emitted count of draws; a greedy row has none."""
    pd = _decoder()
    state = pd.new_state(16)
    g = torch.Generator().manual_seed(3)
    prompts = np.asarray([[5, 6, 7, 8], [1, 2, 3, 0]])
    lengths, mn = np.asarray([4, 3]), np.asarray([20, 20])
    eos, temps = np.asarray([-1, -1]), np.asarray([0.7, 0.0])
    kv, tok, active, rng = pd.prompt_fn(4, 2)(pd.params, prompts, lengths,
                                              mn, eos, temps, [g, None])
    pd.join_fn(16, 4, 2)(state, kv, np.asarray([0, 1]), tok, lengths, mn,
                         eos, temps, rng, active)
    before = g.get_state()
    drafts = torch.full((K, MAX_BATCH), VOCAB - 1)
    state, toks, emitted, accepted = pd.spec_verify_fn(16, K)(
        pd.params, state, drafts)
    e = int(emitted[:, 0].sum())
    g2 = torch.Generator()
    g2.set_state(before)
    for _ in range(e):
        torch.rand(VOCAB, generator=g2)
    assert torch.equal(g.get_state(), g2.get_state())
    assert state["positions"][0] == 4 + e
    assert int(accepted[0]) == e - 1


def test_prefix_attach_copies_pages_and_suffix_join_writes_at_offsets():
    pd = _decoder()
    state = pd.new_state(16)
    name = next(iter(state["caches"]))
    pkv = {n: {k: torch.full((2, 8, HEADS, HS), 5.0) for k in ("k", "v")}
           for n in state["caches"]}
    rows = np.asarray([1, MAX_BATCH])  # the second is padding: dropped
    pd.prefix_attach_fn(16, 8, 2)(state, pkv, rows, np.asarray([6, 8]))
    c = state["caches"][name]["k"]
    assert torch.all(c[1, :8] == 5.0) and torch.all(c[[0, 2, 3]] == 0)
    with torch.inference_mode():
        c[1, 0] = 9.0
    assert torch.all(pkv[name]["k"] == 5.0)  # the page was copied
    kv = {n: {k: torch.full((2, 4, HEADS, HS), 2.0) for k in ("k", "v")}
          for n in state["caches"]}
    pd.suffix_join_fn(16, 4, 2)(
        state, kv, rows, torch.tensor([11, 12]), np.asarray([6, 8]),
        np.asarray([9, 12]), np.asarray([5, 5]), np.asarray([-1, -1]),
        np.zeros(2), [None, None], torch.tensor([True, True]))
    assert torch.all(c[1, 6:10] == 2.0) and torch.all(c[1, 10:] == 0)
    assert torch.all(c[1, 1:6] == 5.0)
    assert state["positions"].tolist() == [0, 9, 0, 0]
    assert state["tokens"].tolist() == [0, 11, 0, 0]
    assert state["active"].tolist() == [False, True, False, False]
    # an offset past S - ts clamps, as dynamic_update_slice does
    pd.suffix_join_fn(16, 4, 1)(
        state, {n: {k: b[k][:1] for k in b} for n, b in kv.items()},
        np.asarray([2]), torch.tensor([3]), np.asarray([15]),
        np.asarray([15]), np.asarray([5]), np.asarray([-1]), np.zeros(1),
        [None], torch.tensor([True]))
    assert torch.all(c[2, 12:16] == 2.0) and torch.all(c[2, :12] == 0)


def test_decoder_warmup_runs_spec_and_prefix_geometries():
    pd = _decoder(use_kernels=True)
    out = pd.warmup(prompt_buckets=[4, 64], join_buckets=[1],
                    kv_buckets=[16, 64], fused_steps=(K,), spec_steps=(K,),
                    spec_draft=(K,), prefix=True)
    assert out["spec_steps"] == [K] and out["spec_draft"] == [K]
    # (prefix bucket, suffix bucket): lengths 33 + 33 > 64 never fit
    assert out["prefix"] == [(4, 4), (4, 64), (64, 4)]


# --- the prefix cache --------------------------------------------------------

def test_prefix_cache_radix_unit():
    """Trie mechanics in isolation: page-aligned match with pins,
    limit / fits backoff, insert once, LRU eviction of refcount-0 leaves
    only."""
    made = []

    def slicer(start, stop):
        made.append((start, stop))
        return torch.full((stop - start, 16), float(start))  # [t, width]

    pc = PrefixCache(page_tokens=4, max_pages=2)
    toks = list(range(12))
    path = pc.insert(toks, 12, slicer)          # 3 pages, over budget
    assert made == [(0, 4), (4, 8), (8, 12)]
    assert pc.stats()["pages"] == 3              # all pinned: no eviction
    pc.release(path)
    m, nodes = pc.match(toks, limit=11)          # page-aligned, <= limit
    assert m == 8 and len(nodes) == 2
    assert nodes[0].kv[0, 0] == 0.0
    m2, nodes2 = pc.match(toks, limit=11, fits=lambda mm: mm <= 4)
    assert m2 == 4 and len(nodes2) == 1          # fits() backs off a page
    pc.release(nodes + nodes2)
    pc.insert(toks, 12, slicer)                  # re-pin forces eviction
    assert pc.stats()["pages"] <= 3
    assert made == [(0, 4), (4, 8), (8, 12)]     # nothing re-sliced
    blk = torch.zeros((12, 16))
    assert pc.assemble(nodes, blk) == 8          # in place, tail untouched
    assert blk[:, 0].tolist() == [0.0] * 4 + [4.0] * 4 + [0.0] * 4
    with pytest.raises(ValueError):
        pc.assemble([], blk)


def test_prefix_hit_token_identical_to_cold_miss():
    """Requests sharing a cached prefix produce exactly the tokens of a
    cold-cache run and of the sequential reference."""
    dec = _decoder()
    shared = [3, 1, 4, 1, 5, 9, 2, 6]
    prompts = [shared + [i + 1, i + 2] for i in range(5)]
    refs = [dec.generate(p, 6) for p in prompts]
    with _engine(prefix_cache=True, prefix_page=4) as eng:
        cold = [eng.generate(p, max_new_tokens=6) for p in prompts]
        hot = [eng.generate(p, max_new_tokens=6) for p in prompts]
        st = eng.stats()
    assert cold == refs and hot == refs
    assert st["prefix_cache"]["hits"] >= 5
    assert st["prefix_cache"]["pages"] >= 2
    assert sum(st["suffix_prefills"].values()) >= 4


def test_prefix_hits_in_one_batch_with_the_kernel_route():
    """Hits of several prefix lengths join in one group (a holed prefix
    mask), on the kernel route (the wrappers' plain versions here)."""
    dec = _decoder(use_kernels=True)
    shared = list(range(1, 13))
    first = [shared + [40, 41, 42, 43, 44]]
    prompts = [shared[:8] + [50, 51], shared + [52], shared[:4] + [53, 54, 55]]
    refs = [dec.generate(p, 5) for p in first + prompts]
    eng = GenerationEngine(dec, GenerationConfig(
        max_batch=MAX_BATCH, fused_steps=K, kv_bucket_min=16,
        prompt_bucket_min=4, prefix_cache=True, prefix_page=4))
    with eng:
        outs = [eng.generate(first[0], max_new_tokens=5)]
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        assert [r.prefix_len for r in reqs] == [8, 12, 4]
        outs += [eng.result(r) for r in reqs]
        st = eng.stats()
    assert outs == refs
    assert st["prefix_cache"]["hits"] == 3


def test_prefix_pages_released_on_all_edges():
    """After finish, queued-deadline expiry, mid-generation expiry,
    dispatch failure and close, every pin is returned."""
    prompt = [5, 4, 3, 2, 1, 6, 7, 8, 2, 2]
    eng = GenerationEngine(
        _decoder(),
        GenerationConfig(max_batch=MAX_BATCH, fused_steps=K,
                         kv_bucket_min=16, prompt_bucket_min=4,
                         prefix_cache=True, prefix_page=4),
        retry=None)
    try:
        pc = eng._prefix
        eng.generate(prompt, max_new_tokens=4)          # normal finish
        eng.generate(prompt, max_new_tokens=4)          # a hit finishes too
        assert _pinned(pc) == 0
        # queued-deadline expiry: the loop is held so the request expires
        # in the queue holding its pins
        eng._ensure_thread = lambda: None
        req = eng.submit(prompt, max_new_tokens=4, timeout_ms=1)
        assert _pinned(pc) > 0
        time.sleep(0.01)
        eng._ensure_thread = type(eng)._ensure_thread.__get__(eng)
        with eng._cond:
            eng._expire_queued_locked(time.monotonic())
        with pytest.raises(DeadlineExpiredError):
            eng.result(req)
        assert _pinned(pc) == 0
        # mid-generation expiry
        plan = FaultPlan()
        plan.inject("decode.launch", action="delay", delay_s=0.02)
        with plan.armed():
            req = eng.submit(prompt, max_new_tokens=40, timeout_ms=60)
            with pytest.raises(DeadlineExpiredError):
                eng.result(req)
        deadline = time.monotonic() + 5
        while eng.stats()["rows_in_use"] and time.monotonic() < deadline:
            time.sleep(0.005)
        assert _pinned(pc) == 0
        # dispatch failure: the in-flight row fails
        plan = FaultPlan()
        plan.inject("decode.launch", action="raise")  # every launch
        with plan.armed():
            req = eng.submit(prompt, max_new_tokens=4)
            with pytest.raises(Exception):
                eng.result(req)
        assert _pinned(pc) == 0
        # close with a pinned request still queued
        eng._ensure_thread = lambda: None
        req = eng.submit(prompt, max_new_tokens=4)
        assert _pinned(pc) > 0
    finally:
        eng.close()
    assert _pinned(pc) == 0
    with pytest.raises(RuntimeError):
        eng.result(req)


# --- speculative decoding ----------------------------------------------------

def test_speculative_greedy_token_identical():
    """Speculation never changes tokens: with an oracle draft and with a
    disagreeing one, the engine's output equals the sequential
    reference."""
    dec = _decoder()
    prompts = [[3, 9, 1], [5, 6, 7, 8, 2, 11], [1], [14, 13, 12, 2]]
    mns = [6, 9, 4, 12]
    refs = [dec.generate(p, mn) for p, mn in zip(prompts, mns)]
    with _engine(draft_conf=_oracle_draft()) as eng:
        outs = [eng.generate(p, max_new_tokens=mn)
                for p, mn in zip(prompts, mns)]
        st = eng.stats()
    assert outs == refs
    assert st["speculative"]["accepted"] > 0     # the oracle agrees
    with _engine(draft_conf=_draft_decoder(), spec_tokens=3) as eng:
        reqs = [eng.submit(p, max_new_tokens=mn)
                for p, mn in zip(prompts, mns)]
        outs2 = [eng.result(r) for r in reqs]
        st2 = eng.stats()
    assert outs2 == refs                         # ~0% acceptance
    assert st2["speculative"]["windows"] > 0
    assert st2["speculative"]["k"] == 3


def test_speculative_engine_matches_jax_generate():
    """The slice as a whole: the port's speculating, prefix-caching
    engine against the JAX package's sequential decoder."""
    jd = _jax_decoder()
    shared = [7, 3, 7, 3, 7, 3, 7, 3]
    prompts = [shared + [i + 1] for i in range(3)] + [[9, 9, 2]]
    with _engine(draft_conf=_oracle_draft(), prefix_cache=True,
                 prefix_page=4) as eng:
        outs = [eng.generate(p, max_new_tokens=7) for p in prompts]
        outs += [eng.generate(p, max_new_tokens=7) for p in prompts]
    for p, got in zip(prompts + prompts, outs):
        ref = jd.generate(p, 7)
        if got != ref:  # the near-tie rule of test_torch_decoding.py
            i = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            logits, _ = jd._run_prompt(
                jd.params, jnp.asarray([list(p) + list(ref[:i])], jnp.int32),
                jnp.asarray([len(p) + i], jnp.int32))
            top2 = np.sort(np.asarray(logits[0]))[-2:]
            assert top2[1] - top2[0] < 2 * LOGIT_ATOL, (got, ref)


def test_speculative_sampled_matches_reference():
    """Seeded sampling through the verifier consumes the row's generator
    as sequential decode does: same (seed, temperature), same tokens, at
    any acceptance rate, beside greedy co-tenants."""
    dec = _decoder()
    ref = dec.generate([2, 4, 6], 7, temperature=0.8, seed=42)
    ref2 = dec.generate([9, 1], 9, temperature=1.3, seed=7)
    greedy = dec.generate([3, 3, 3], 8)
    for draft in (_draft_decoder(), _oracle_draft()):
        with _engine(draft_conf=draft) as eng:
            reqs = [eng.submit([2, 4, 6], max_new_tokens=7, temperature=0.8,
                               seed=42),
                    eng.submit([9, 1], max_new_tokens=9, temperature=1.3,
                               seed=7),
                    eng.submit([3, 3, 3], max_new_tokens=8)]
            assert [eng.result(r) for r in reqs] == [ref, ref2, greedy]


def test_spec_prefix_compose_with_warmup_and_growth():
    """Both features together under mixed traffic (hits and misses,
    accepted and rejected windows, a KV bucket hop) match the sequential
    reference."""
    dec = _decoder()
    shared = [7, 3, 7, 3, 7, 3, 7, 3]
    prompts = [shared + [i + 1] for i in range(3)] + [[9, 9, 2]]
    refs = [dec.generate(p, 5) for p in prompts]
    grow = dec.generate([2] * 20, 8)
    with _engine(draft_conf=_oracle_draft(), prefix_cache=True,
                 prefix_page=4) as eng:
        warm = eng.warmup(prompt_buckets=[4, 16], join_buckets=[1, 4],
                          kv_buckets=[16, 32])
        outs = [eng.generate(p, max_new_tokens=5) for p in prompts]
        outs += [eng.generate(p, max_new_tokens=5) for p in prompts]
        out_grow = eng.generate([2] * 20, max_new_tokens=8)
        st = eng.stats()
    assert outs == refs + refs and out_grow == grow
    assert warm["spec_steps"] == [K] and warm["draft"]["spec_draft"] == [K]
    assert warm["prefix"] == [(4, 4), (4, 16), (16, 4), (16, 16)]
    assert st["prefix_cache"]["hits"] >= 1
    assert st["kv_bucket"] == 32


def test_spec_fallback_near_context_limit():
    """Within K+1 slots of max_len the iteration falls back to the plain
    window; output matches the sequential reference up to the edge."""
    dec = _decoder()
    prompt = [1, 2, 3, 4]
    mn = MAX_LEN - len(prompt)                    # decode to the edge
    ref = dec.generate(prompt, mn)
    for draft in (_oracle_draft(), _draft_decoder()):
        with _engine(draft_conf=draft) as eng:
            out = eng.generate(prompt, max_new_tokens=mn)
            st = eng.stats()
        assert out == ref
    assert st["windows"], "the disagreeing draft never reached the fallback"


def test_draft_geometry_mismatch_rejected():
    bad = TransformerEncoder(vocab_size=VOCAB, embed_dim=16, n_heads=2,
                             n_layers=1, max_len=32, causal=True,
                             lm_head=True, seed=1).decoder(
        device="cpu", **DEC_KW)                   # max_len 32 != 64
    with pytest.raises(ValueError, match="geometry"):
        _engine(draft_conf=bad)
    other = TransformerEncoder(vocab_size=VOCAB + 1, embed_dim=16, n_heads=2,
                               n_layers=1, max_len=MAX_LEN, causal=True,
                               lm_head=True, seed=1).decoder(
        device="cpu", **DEC_KW)
    with pytest.raises(ValueError, match="vocab"):
        _engine(draft_conf=other)
    with pytest.raises(TypeError):
        _engine(draft_conf=object())


def test_prefix_and_spec_telemetry_series():
    snap0 = REGISTRY.snapshot(run_collectors=False)
    shared = [4, 4, 4, 4, 8, 8, 8, 8]
    with _engine(draft_conf=_oracle_draft(), prefix_cache=True,
                 prefix_page=4) as eng:
        eng.generate(shared + [1], max_new_tokens=5)
        eng.generate(shared + [2], max_new_tokens=5)
        snap1 = REGISTRY.snapshot(run_collectors=False)
        st = eng.stats()
    for name in ("dl4j_prefix_cache_hits_total",
                 "dl4j_prefix_cache_misses_total",
                 "dl4j_prefix_cache_hit_tokens_total",
                 "dl4j_spec_draft_tokens_total",
                 "dl4j_spec_accepted_tokens_total",
                 "dl4j_spec_emitted_tokens_total"):
        assert snap1.get(name, 0) > snap0.get(name, 0), name
    assert "dl4j_prefix_cache_pages" in snap1
    assert snap1["dl4j_spec_accepted_tokens"]["count"] > 0
    spec = st["speculative"]
    assert spec["drafted"] == K * spec["windows"]
    assert spec["acceptance"] == spec["accepted"] / spec["drafted"]
    assert spec["draft_prefills"] == 2
