"""The port's generation slice against the JAX package, on the CPU.

A small causal language model (vocab 64, width 32, 4 heads, 2 blocks,
max_len 64) is built by the JAX package's ``TransformerEncoder``; the port
loads its configuration JSON and its weights (``util.convert
.params_from_jax``) and is held to it layer by layer (embedding, layer
norm, position embedding, self-attention ``forward`` / ``prefill`` /
``decode_step``), as a whole graph (``output``), through the decoder
(prefill logits and teacher-forced decode logits against the JAX
decoder's ``_run_prompt`` / ``_run_token``) and token by token (greedy
``generate``). The port's ``GenerationEngine`` is held to its own
sequential ``generate``, and its admission control is exercised.

Tolerances: float32 everywhere, both packages summing in different orders
over at most 128 terms per product and 2 blocks: logits atol = rtol = 1e-4
(outputs of softmax 1e-5). Greedy streams are compared under the near-tie
rule: they must be identical, or diverge only at a step where the JAX
reference's top-2 logit gap is below 2 * LOGIT_ATOL (two logits within the
tolerance each can swap order); the gap is printed.
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.graph import (
    ComputationGraphConfiguration as JConf,
)
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu_torch.conf import inputs as it
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.decoding import (
    TransformerDecoder,
    bucket_for,
    pow2_ladder,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel.batcher import (
    BadRequestError,
    DeadlineExpiredError,
    ServerOverloadedError,
)
from deeplearning4j_tpu_torch.parallel.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.resilience.faults import FaultPlan
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    params_from_jax,
)
from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

pytestmark = pytest.mark.torch

VOCAB, E, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 64
MAX_BATCH, K = 4, 2
LOGIT_ATOL = 1e-4
TOL = dict(atol=LOGIT_ATOL, rtol=LOGIT_ATOL)
DEC_KW = dict(max_batch=MAX_BATCH, kv_bucket_min=16, prompt_bucket_min=4)


def _zoo(cls, **kw):
    return cls(vocab_size=VOCAB, embed_dim=E, n_heads=HEADS, n_layers=LAYERS,
               max_len=MAX_LEN, causal=True, lm_head=True, seed=7, **kw)


@functools.lru_cache(maxsize=None)
def _jax_net():
    """The JAX reference network (random weights from its seed)."""
    net = _zoo(JTransformer).init()
    # spread the LN gains and biases so the layer norms are not identities
    rng = np.random.default_rng(0)
    for name, p in net.params.items():
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
def _jax_decoder():
    return _zoo(JTransformer).decoder(net=_jax_net(), **DEC_KW)


def _tokens(seed, b, t):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t))


def _layer_pair(name):
    jnet, net = _jax_net(), _port_net()
    jl = jnet.conf.vertex_map()[name].vertex.layer
    pl = net.conf.vertex_map()[name].vertex.layer
    jp = _np_tree({name: jnet.params[name]})[name]
    return jl, jnet.params[name], pl, convert_layer_params(pl, jp)


def _near_tie_or_equal(got, ref, prompt, logits_at):
    """Greedy streams: identical, or the first divergence sits at a step
    whose reference top-2 logit gap is below 2 * LOGIT_ATOL."""
    if got == ref:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, ref)) if a != b),
             min(len(got), len(ref)))
    top2 = np.sort(logits_at(list(prompt) + list(ref[:i])))[-2:]
    gap = float(top2[1] - top2[0])
    print(f"streams diverge at step {i}: reference top-2 gap {gap:.3e}")
    assert gap < 2 * LOGIT_ATOL, (got, ref, gap)


def _jax_last_logits(seq):
    dec = _jax_decoder()
    logits, _ = dec._run_prompt(dec.params, jnp.asarray([seq], jnp.int32),
                                jnp.asarray([len(seq)], jnp.int32))
    return np.asarray(logits[0])


# --- layers ------------------------------------------------------------------

def test_embedding_and_position_layers_match_jax():
    ids = _tokens(1, 2, 9)
    jl, jp, pl, pp = _layer_pair("embed")
    ref, _ = jl.forward(jp, {}, jnp.asarray(ids, jnp.int32))
    got, _ = pl.forward(pp, {}, torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    x = np.asarray(ref)
    jl, jp, pl, pp = _layer_pair("pos")
    ref, _ = jl.forward(jp, {}, jnp.asarray(x))
    got, _ = pl.forward(pp, {}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError):
        pl.forward(pp, {}, torch.zeros(1, MAX_LEN + 1, E))


def test_layer_normalization_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 7, E)).astype(np.float32)
    jl, jp, pl, pp = _layer_pair("b0_ln1")
    ref, _ = jl.forward(jp, {}, jnp.asarray(x))
    got, _ = pl.forward(pp, {}, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_attention_weights_are_transposed_to_out_in():
    jl, jp, pl, pp = _layer_pair("b1_attn")
    for key in ("Wq", "Wk", "Wv", "Wo"):
        np.testing.assert_array_equal(pp[key].numpy(), np.asarray(jp[key]).T)
    for key in ("bq", "bk", "bv", "bo"):
        np.testing.assert_array_equal(pp[key].numpy(), np.asarray(jp[key]))
    _, jd, _, pd = _layer_pair("b1_ff1")
    np.testing.assert_array_equal(pd["W"].numpy(), np.asarray(jd["W"]).T)
    _, je, _, pe = _layer_pair("embed")
    np.testing.assert_array_equal(pe["W"].numpy(), np.asarray(je["W"]))


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_forward_and_prefill_match_jax(masked):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 12, E)).astype(np.float32)
    mask = (np.arange(12)[None, :] < np.asarray([12, 5, 0])[:, None]
            ).astype(np.float32) if masked else None
    jl, jp, pl, pp = _layer_pair("b0_attn")
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    ref, _ = jl.forward(jp, {}, jnp.asarray(x), mask=jm)
    got, _ = pl.forward(pp, {}, torch.tensor(x), mask=tm)
    rows = slice(None) if mask is None else slice(0, 2)  # row 2 is empty
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(ref)[rows],
                               **TOL)
    ry, rk, rv = jl.prefill(jp, jnp.asarray(x), jm)
    gy, gk, gv = pl.prefill(pp, torch.tensor(x), tm)
    assert torch.isfinite(gy).all()
    np.testing.assert_allclose(gy.numpy()[rows], np.asarray(ry)[rows], **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(rk), **TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), **TOL)
    # the kernel route (the flash wrapper's plain version on the CPU)
    ky, kk, kv = pl.prefill(pp, torch.tensor(x), tm, use_kernels=True)
    np.testing.assert_allclose(ky.numpy()[rows], gy.numpy()[rows], **TOL)
    assert torch.equal(kk, gk) and torch.equal(kv, gv)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_self_attention_decode_step_matches_jax(use_kernels):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, E)).astype(np.float32)
    kc = rng.standard_normal((4, 16, HEADS, E // HEADS)).astype(np.float32)
    vc = rng.standard_normal((4, 16, HEADS, E // HEADS)).astype(np.float32)
    pos = np.asarray([0, 5, 15, 20], np.int32)  # 20: clamped write
    jl, jp, pl, pp = _layer_pair("b1_attn")
    ref, rc = jl.decode_step(jp, jnp.asarray(x), {"k": jnp.asarray(kc),
                                                  "v": jnp.asarray(vc)},
                             jnp.asarray(pos))
    cache = {"k": torch.tensor(kc), "v": torch.tensor(vc)}
    got, gc = pl.decode_step(pp, torch.tensor(x), cache, torch.tensor(pos),
                             use_kernels=use_kernels)
    assert gc is cache  # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(gc["k"].numpy(), np.asarray(rc["k"]), **TOL)
    np.testing.assert_allclose(gc["v"].numpy(), np.asarray(rc["v"]), **TOL)


# --- the graph ---------------------------------------------------------------

def test_graph_output_matches_jax():
    ids = _tokens(5, 3, 20)
    ref = np.asarray(_jax_net().output(ids.astype(np.int32)))
    got = _port_net().output(ids)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-4)
    kern = _port_net(use_kernels=True).output(ids)
    np.testing.assert_allclose(kern, got, atol=1e-5, rtol=1e-4)


def test_token_ids_cross_as_long():
    net = _port_net()
    x = net._prepare([_tokens(6, 2, 5).astype(np.int32)])[0]
    assert x.dtype == torch.long
    assert net._ids == [True]


def test_config_json_round_trips_both_ways():
    jconf = _jax_net().conf
    port = ComputationGraphConfiguration.from_json(jconf.to_json())
    assert port == _zoo(TransformerEncoder).conf()
    back = JConf.from_json(port.to_json())
    assert back.to_json() == jconf.to_json()


def test_recurrent_shape_inference_matches_jax():
    jtypes = _jax_net().conf.vertex_output_types()
    ptypes = _zoo(TransformerEncoder).conf().vertex_output_types()
    assert set(jtypes) == set(ptypes)
    for name, t in ptypes.items():
        assert type(t).__name__ == type(jtypes[name]).__name__, name
        assert t.size == jtypes[name].size, name
    assert ptypes["output"] == it.Recurrent(size=VOCAB, timesteps=MAX_LEN)
    # no preprocessor between the recurrent and dense layers, as in JAX
    vmap = _zoo(TransformerEncoder).conf().vertex_map()
    assert all(v.vertex.preprocessor is None for v in vmap.values()
               if hasattr(v.vertex, "preprocessor"))


def test_classifier_head_matches_jax():
    kw = dict(num_classes=3, vocab_size=VOCAB, embed_dim=16, n_heads=2,
              n_layers=1, max_len=16, seed=3)
    jnet = JTransformer(**kw).init()
    conf = TransformerEncoder(**kw).conf()
    net = ComputationGraph(conf, device="cpu").set_params(
        *params_from_jax(conf, _np_tree(jnet.params), _np_tree(jnet.state)))
    ids = _tokens(7, 2, 16)
    np.testing.assert_allclose(net.output(ids),
                               np.asarray(jnet.output(ids.astype(np.int32))),
                               atol=1e-5, rtol=1e-4)


def test_moe_and_bad_heads_refused():
    with pytest.raises(NotImplementedError, match="slice"):
        TransformerEncoder(vocab_size=16, moe_experts=4)
    with pytest.raises(ValueError):
        TransformerEncoder(vocab_size=16, lm_head=True)
    with pytest.raises(ValueError):
        TransformerEncoder(vocab_size=16, causal=True).decoder(device="cpu")


# --- the decoder -------------------------------------------------------------

def test_pow2_ladder_and_bucket_for():
    assert pow2_ladder(8, 64) == [8, 16, 32, 64]
    assert pow2_ladder(32, 48) == [32, 48]
    assert pow2_ladder(64, 32) == [32]
    assert bucket_for(9, [8, 16, 32]) == 16
    with pytest.raises(ValueError):
        bucket_for(33, [8, 16, 32])


def test_prefill_logits_match_jax_run_prompt():
    prompts = _tokens(8, 4, 16)
    lengths = np.asarray([16, 9, 1, 0])  # a length-0 join-padding row
    jd, pd = _jax_decoder(), _decoder()
    ref, rkv = jd._run_prompt(jd.params, jnp.asarray(prompts, jnp.int32),
                              jnp.asarray(lengths, jnp.int32))
    with torch.inference_mode():
        got, gkv = pd._run_prompt(pd.params, torch.tensor(prompts),
                                  torch.tensor(lengths))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy()[:3], np.asarray(ref)[:3], **TOL)
    for name in rkv:
        np.testing.assert_allclose(gkv[name]["k"].numpy()[:3],
                                   np.asarray(rkv[name]["k"])[:3], **TOL)


def test_teacher_forced_decode_logits_match_jax_run_token():
    jd, pd = _jax_decoder(), _decoder()
    seqs = _tokens(9, MAX_BATCH, 10)
    jcaches = jd.new_state(16)["caches"]
    state = pd.new_state(16)
    for t in range(10):
        tok, pos = seqs[:, t], np.full((MAX_BATCH,), t)
        pos[3] = min(t, 2)  # a row that keeps rewriting one slot
        ref, jcaches = jd._run_token(jd.params, jnp.asarray(tok, jnp.int32),
                                     jnp.asarray(pos, jnp.int32), jcaches)
        with torch.inference_mode():
            got, _ = pd._run_token(pd.params, torch.tensor(tok),
                                   torch.tensor(pos), state["caches"])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_position_gather_clamps_like_jax():
    jd, pd = _jax_decoder(), _decoder()
    tok = np.asarray([1, 2, 3, 4])
    pos = np.asarray([0, MAX_LEN - 1, MAX_LEN, MAX_LEN + 5])
    jc = jd.new_state(16)["caches"]
    ref, _ = jd._run_token(jd.params, jnp.asarray(tok, jnp.int32),
                           jnp.asarray(pos, jnp.int32), jc)
    with torch.inference_mode():
        got, _ = pd._run_token(pd.params, torch.tensor(tok),
                               torch.tensor(pos), pd.new_state(16)["caches"])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_greedy_generate_matches_jax_generate():
    jd, pd = _jax_decoder(), _decoder()
    for prompt, n in (([3, 9, 1, 14, 2], 9), (list(_tokens(10, 1, 13)[0]), 7)):
        ref = jd.generate(prompt, n, fused_steps=K)
        got = pd.generate(prompt, n, fused_steps=K)
        _near_tie_or_equal(got, ref, prompt, _jax_last_logits)
        assert pd.generate(prompt, n) == got  # K = 1 and K = 2 agree


def test_generate_matches_full_forward_oracle():
    pd = _decoder()
    prompt = [5, 6, 7, 8, 2, 11]
    out = pd.generate(prompt, 6)
    seq, ref = list(prompt), []
    for _ in range(6):
        y = pd.net.output(np.asarray([seq]))
        ref.append(int(np.argmax(y[0, len(seq) - 1])))
        seq.append(ref[-1])
    assert out == ref


def test_generate_stops_at_eos_and_sampling_is_seeded():
    pd = _decoder()
    ref = pd.generate([4, 8, 15], 8)
    eos = ref[2]
    out = pd.generate([4, 8, 15], 8, eos_id=eos)
    assert out == ref[:ref.index(eos) + 1]
    a = pd.generate([1, 2, 3], 8, temperature=0.9, seed=123)
    assert a == pd.generate([1, 2, 3], 8, temperature=0.9, seed=123)
    assert all(0 <= t < VOCAB for t in a) and len(a) == 8


def test_greedy_ties_take_the_first_maximum_like_jnp_argmax():
    from deeplearning4j_tpu_torch.nn.decoding import _sample_tokens

    logits = np.zeros((3, 8), np.float32)
    logits[0, [2, 5]] = 1.0
    logits[1, [0, 7]] = 3.0  # row 2: all equal
    ref = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    got = _sample_tokens(torch.tensor(logits), [0.0] * 3, [None] * 3)
    assert got.tolist() == ref.tolist() == [2, 0, 0]


def test_join_drops_padding_rows_and_zeroes_the_tail():
    pd = _decoder()
    state = pd.new_state(16)
    with torch.inference_mode():
        for c in state["caches"].values():
            c["k"].fill_(7.0)
    prompts = _tokens(11, 2, 4)
    kv, tok, active, rng = pd.prompt_fn(4, 2)(
        pd.params, prompts, np.asarray([4, 3]), np.asarray([5, 5]),
        np.asarray([-1, -1]), np.zeros(2), [None, None])
    rows = np.asarray([2, MAX_BATCH])  # the second is padding: dropped
    pd.join_fn(16, 4, 2)(state, kv, rows, tok, np.asarray([4, 3]),
                         np.asarray([5, 5]), np.asarray([-1, -1]), np.zeros(2),
                         rng, active)
    k0 = next(iter(state["caches"].values()))["k"]
    name0 = next(iter(state["caches"]))
    assert torch.equal(k0[2, :4], kv[name0]["k"][0])
    assert torch.all(k0[2, 4:] == 0)
    assert torch.all(k0[[0, 1, 3]] == 7.0)  # other rows untouched
    assert state["positions"].tolist() == [0, 0, 4, 0]
    assert state["active"].tolist() == [False, False, True, False]


def test_rejects_graphs_it_cannot_decode():
    with pytest.raises(ValueError):
        _zoo(TransformerEncoder).decoder(
            net=ComputationGraph(TransformerEncoder(
                vocab_size=16, embed_dim=8, n_heads=2, n_layers=1,
                max_len=8).conf(), device="cpu").init())


# --- the engine --------------------------------------------------------------

def _engine(**over):
    cfg = dict(max_batch=MAX_BATCH, fused_steps=K, kv_bucket_min=16,
               prompt_bucket_min=4)
    cfg.update(over)
    return GenerationEngine(_decoder(), GenerationConfig(**cfg))


def test_engine_matches_sequential_generate_for_mixed_lengths():
    rng = np.random.default_rng(12)
    prompts = [list(rng.integers(0, VOCAB, n)) for n in (1, 3, 17, 30, 8, 5,
                                                         12)]
    max_new = [int(n) for n in (9, 1, 12, 20, 4, 33, 6)]
    pd = _decoder()
    with _engine() as eng:
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, max_new)]
        reqs.append(eng.submit([4, 8, 15], max_new_tokens=8, temperature=0.9,
                               seed=5))
        got = [eng.result(r) for r in reqs]
        stats = eng.stats()
    for p, n, g in zip(prompts, max_new, got):
        assert len(g) == n
        assert g == pd.generate(p, n)
    # seeded sampling: a row's draws do not depend on its co-tenants
    assert got[-1] == pd.generate([4, 8, 15], 8, temperature=0.9, seed=5)
    assert stats["joined_total"] == stats["retired_total"] == 8
    assert stats["tokens_total"] == sum(max_new) + 8
    assert stats["kv_bucket"] in (32, 64)  # grown past the first bucket


def test_engine_eos_on_first_token_retires_at_prefill():
    pd = _decoder()
    prompt = [9, 9, 2]
    first = pd.generate(prompt, 1)[0]
    with _engine() as eng:
        out = eng.generate(prompt, max_new_tokens=10, eos_id=first)
        assert out == [first]
        assert eng.stats()["rows_in_use"] == 0


def test_engine_bad_requests_and_overload():
    eng = _engine(max_queue=2)
    eng._ensure_thread = lambda: None  # keep requests queued
    try:
        for bad in ([], [VOCAB], [1] * MAX_LEN):
            with pytest.raises(BadRequestError):
                eng.submit(bad, max_new_tokens=2)
        with pytest.raises(BadRequestError):
            eng.submit([1], max_new_tokens=2, temperature=-1.0)
        eng.submit([1], max_new_tokens=2)
        eng.submit([2], max_new_tokens=2)
        with pytest.raises(ServerOverloadedError):
            eng.submit([3], max_new_tokens=2)
    finally:
        eng.close()


def test_engine_deadlines_queued_and_mid_generation():
    eng = _engine()
    eng._ensure_thread = lambda: None
    try:
        req = eng.submit([1, 2], max_new_tokens=4, timeout_ms=5)
        time.sleep(0.02)
        eng._expire_queued_locked(time.monotonic())
        with pytest.raises(DeadlineExpiredError):
            eng.result(req)
    finally:
        eng.close()
    plan = FaultPlan()
    plan.inject("decode.launch", action="delay", delay_s=0.02)
    with _engine() as eng:
        with plan.armed():
            req = eng.submit([1, 2, 3], max_new_tokens=28, timeout_ms=60)
            with pytest.raises(DeadlineExpiredError):
                eng.result(req)
        deadline = time.monotonic() + 5
        while eng.stats()["rows_in_use"] and time.monotonic() < deadline:
            time.sleep(0.005)
        assert eng.stats()["rows_in_use"] == 0


def test_engine_failure_fails_requests_then_recovers():
    plan = FaultPlan()
    plan.inject("decode.launch", on_calls=[2], action="raise")  # a window
    with GenerationEngine(_decoder(), GenerationConfig(
            max_batch=MAX_BATCH, fused_steps=K, kv_bucket_min=16,
            prompt_bucket_min=4), retry=None) as eng:
        with plan.armed():
            req = eng.submit([1, 2], max_new_tokens=4)
            with pytest.raises(Exception):
                eng.result(req)
            out = eng.generate([1, 2], max_new_tokens=4)
        assert out == _decoder().generate([1, 2], 4)


def test_engine_refuses_unported_features_and_closes():
    with pytest.raises(NotImplementedError):
        GenerationEngine(_decoder(), GenerationConfig(prefix_cache=True))
    with pytest.raises(NotImplementedError):
        GenerationEngine(_decoder(), GenerationConfig(draft_conf=object()))
    eng = _engine()
    eng._ensure_thread = lambda: None
    req = eng.submit([1, 2], max_new_tokens=3)
    eng.close()
    with pytest.raises(RuntimeError):
        eng.result(req)
    with pytest.raises(RuntimeError):
        eng.submit([1], max_new_tokens=1)


def test_decoder_warmup_runs_each_bucket():
    pd = _decoder(use_kernels=True)
    out = pd.warmup(prompt_buckets=[4], join_buckets=[1, 2], kv_buckets=[16],
                    fused_steps=(1, K))
    assert out == {"prompt_buckets": [4], "join_buckets": [1, 2],
                   "kv_buckets": [16], "fused_steps": [1, K]}
    assert pd.generate([3, 1], 5) == _decoder().generate([3, 1], 5)
