"""The port's transformer training slice against the JAX package, on the CPU.

- ``flash_attention_bwd_plain`` (the backward kernels' function) against
  ``jax.vjp`` of the JAX package's Pallas ``flash_attention`` in interpret
  mode (``block_q = block_k = 32``) and against autograd of the port's
  ``reference_attention`` in float64; ``flash_attention`` trains through its
  autograd Function.
- The feature-mask repair: the same ``TransformerEncoder`` in both packages
  (the JAX weights carried by ``util.convert.params_from_jax``), ``output``
  with ``fmasks``, ``score`` and ``compute_gradient_and_score`` of a
  ``DataSet`` with a ``features_mask``, and 3 Adam ``fit`` steps: a
  bidirectional classifier (pooling unmasked, as the JAX graph pools) and
  the causal LM with a left-padding mask as its label mask; the unmasked LM (vocab 37, 32 wide, 4
  heads, 2 blocks, max_len 16) too. ``use_kernels=True`` trains through the
  flash Function (its plain versions on the CPU).
- The LM's layers in train mode (embedding with repeated ids, position
  embedding, layer norm, tanh-GELU dense, the time-distributed softmax
  output with a [B, T] label mask): values and gradients.
- Adam's state carried by ``opt_state_from_jax``: a run started in the JAX
  package resumes in the port.

Tolerances, float32: attention and its gradients sum <= 72 products in
other orders (the Pallas kernel blockwise with rescaling, the port in one
pass): 2e-5 absolute on O(1) values, 1e-4 relative. Graph outputs, scores
and gradients of the 2-block model: rtol 1e-4, atol 1e-6 (gradients) /
1e-5 (outputs). After Adam steps, each param's update (params minus the
starting params) is held to a relative L2 error of 1e-3, and every element
to Adam's largest move, 2 lr per step: a gradient element within rounding
of 0 can take the other sign in the other package, and Adam's normalized
step then moves it the other way. Each block's key bias ``bk`` is held to
the elementwise bound only: its gradient is exactly 0 in exact arithmetic
(it adds the same q . bk to every score of a row, which softmax ignores),
so both packages see rounding noise there; bk changes no output. bfloat16
(one case): both round p and ds to bf16 before their products, and the
two forwards' o (which di reads) may differ by a bf16 ulp: 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf.updaters import Adam as JAdam
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.ops import attention as jatt
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.ops import attention as att
from deeplearning4j_tpu_torch.util.convert import (
    convert_layer_params,
    opt_state_from_jax,
    params_from_jax,
)

pytestmark = pytest.mark.torch

VOCAB, E, HEADS, LAYERS, MAX_LEN = 37, 32, 4, 2, 16
BATCH, CLASSES, STEPS = 4, 3, 3
LENGTHS = (16, 11, 5, 1)
ATTN_TOL = dict(atol=2e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
UPDATE_L2 = 1e-3
LR = 1e-3  # the zoo's default Adam
ZERO_GRAD = "bk"  # the key bias: exactly 0 gradient (module docstring)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------
# flash attention's backward
# --------------------------------------------------------------------------

# (batch, heads, Tq, Tk, head_dim, causal, masked); causal only with
# Tq <= Tk, so every query row has a valid key
BWD_CASES = [
    (2, 2, 64, 64, 16, True, False),
    (2, 2, 64, 64, 16, True, True),
    (2, 2, 64, 64, 64, True, True),
    (2, 2, 64, 64, 64, False, False),
    (2, 2, 64, 64, 16, False, True),
    (2, 2, 40, 72, 16, True, True),
    (2, 2, 72, 40, 64, False, True),
]


def _bwd_inputs(seed, b, h, tq, tk, d, masked, zero_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    do = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    km = None
    if masked:
        lengths = rng.integers(1, tk + 1, b)
        if zero_row:
            lengths[-1] = 0
        km = (np.arange(tk)[None, :] < lengths[:, None]).astype(np.float32)
    return q, k, v, do, km


def _jax_vjp(q, k, v, do, km, causal, dtype=jnp.float32):
    def f(q_, k_, v_):
        return jatt.flash_attention(q_, k_, v_, None if km is None
                                    else jnp.asarray(km), causal,
                                    block_q=32, block_k=32, interpret=True)

    args = [jnp.asarray(a, dtype) for a in (q, k, v)]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(do, dtype))]


def _port_bwd(q, k, v, do, km, causal, dtype=torch.float32):
    tq, tk, tv, tdo = (torch.tensor(a).to(dtype) for a in (q, k, v, do))
    tkm = None if km is None else torch.tensor(km)
    o, l, m = att.flash_attention_plain(tq, tk, tv, tkm, causal)
    return [g.float().numpy() for g in att.flash_attention_bwd_plain(
        tq, tk, tv, tkm, o, l, m, tdo, causal)]


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_plain_matches_the_jax_flash_vjp(case):
    b, h, tq, tk, d, causal, masked = case
    q, k, v, do, km = _bwd_inputs(3, b, h, tq, tk, d, masked)
    for name, got, want in zip(("dq", "dk", "dv"),
                               _port_bwd(q, k, v, do, km, causal),
                               _jax_vjp(q, k, v, do, km, causal)):
        np.testing.assert_allclose(got, want, err_msg=name, **ATTN_TOL)


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_plain_matches_reference_autograd_in_float64(case):
    b, h, tq, tk, d, causal, masked = case
    q, k, v, do, km = _bwd_inputs(4, b, h, tq, tk, d, masked)
    leaves = [torch.tensor(a, dtype=torch.float64, requires_grad=True)
              for a in (q, k, v)]
    out = att.reference_attention(*leaves, None if km is None
                                  else torch.tensor(km, dtype=torch.float64),
                                  causal)
    want = torch.autograd.grad(out, leaves, torch.tensor(do).double())
    for name, got, w in zip(("dq", "dk", "dv"),
                            _port_bwd(q, k, v, do, km, causal), want):
        np.testing.assert_allclose(got, w.numpy(), err_msg=name, **ATTN_TOL)


def test_flash_bwd_plain_bfloat16_matches_the_jax_flash_vjp():
    q, k, v, do, km = _bwd_inputs(5, 2, 2, 64, 64, 64, True)
    for name, got, want in zip(
            ("dq", "dk", "dv"),
            _port_bwd(q, k, v, do, km, True, torch.bfloat16),
            _jax_vjp(q, k, v, do, km, True, jnp.bfloat16)):
        np.testing.assert_allclose(got, want, err_msg=name, **BF16_TOL)


def test_flash_attention_trains_through_its_function():
    """The output's grad_fn is the Function's; its gradients are the plain
    backward's; the key mask gets none; on the CPU no kernel counts."""
    q, k, v, do, km = _bwd_inputs(6, 2, 2, 24, 24, 16, True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    mask = torch.tensor(km, requires_grad=True)
    counts = (att.flash_attention_bwd.dq_launches,
              att.flash_attention_bwd.dkv_launches)
    out = att.flash_attention(*leaves, mask, True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    grads = torch.autograd.grad(out, leaves + [mask], torch.tensor(do),
                                allow_unused=True)
    assert grads[3] is None
    for got, want in zip(grads[:3], _port_bwd(q, k, v, do, km, True)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert counts == (att.flash_attention_bwd.dq_launches,
                      att.flash_attention_bwd.dkv_launches)
    # the statistics carry no gradient
    o, l, m = att.flash_attention(*leaves, mask, True, return_stats=True)
    assert not l.requires_grad and not m.requires_grad


@pytest.mark.parametrize("bad", ["o_shape", "do_dtype", "l_shape",
                                 "m_dtype"])
def test_flash_bwd_refuses_mismatched_operands(bad):
    """The kernels read o, do, l and m through raw pointers: a shape, dtype
    or device other than q's layout raises before any launch."""
    q, k, v, do, _ = (torch.tensor(a) if a is not None else None
                      for a in _bwd_inputs(9, 1, 2, 8, 8, 16, False))
    o, l, m = att.flash_attention_plain(q, k, v, None, True)
    args = {"o": o, "l": l, "m": m, "do": do}
    name, what = bad.split("_")
    t = args[name]
    args[name] = t[..., :-1] if what == "shape" else t.double()
    with pytest.raises(ValueError, match=rf"\b{name} must"):
        att.flash_attention_bwd(q, k, v, None, args["o"], args["l"],
                                args["m"], args["do"], True)


def test_a_length_0_row_gives_finite_gradients():
    q, k, v, do, km = _bwd_inputs(7, 3, 2, 32, 32, 16, True, zero_row=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = att.flash_attention(*leaves, torch.tensor(km), True)
    grads = torch.autograd.grad(out, leaves, torch.tensor(do))
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0][-1].abs().max()) > 0  # its ds is not 0 (the rule)


# --------------------------------------------------------------------------
# the graph: feature masks, fit, gradients (the JAX package as reference)
# --------------------------------------------------------------------------

def _zoo(cls, lm, **kw):
    if lm:
        return cls(vocab_size=VOCAB, embed_dim=E, n_heads=HEADS,
                   n_layers=LAYERS, max_len=MAX_LEN, causal=True,
                   lm_head=True, seed=7, **kw)
    return cls(num_classes=CLASSES, vocab_size=VOCAB, embed_dim=E,
               n_heads=HEADS, n_layers=LAYERS, max_len=MAX_LEN, causal=False,
               seed=7, **kw)


def _spread(jnet):
    """LN gains and biases and attention biases off their init values, so
    no layer is an identity."""
    rng = np.random.default_rng(0)
    for p in jnet.params.values():
        for key, scale, base in (("gain", 0.2, 1.0), ("b", 0.1, 0.0),
                                 ("bq", 0.1, 0.0), ("bk", 0.1, 0.0),
                                 ("bv", 0.1, 0.0), ("bo", 0.1, 0.0)):
            if key in p:
                p[key] = jnp.asarray(base + scale * rng.standard_normal(
                    p[key].shape), jnp.float32)


def _batch(lm, masked, seed):
    """Token ids, labels and the [B, T] mask of LENGTHS valid steps: at
    the start of each row for the classifier, at its end (left padding)
    for the LM. A causal row never sees a key past itself, so only left
    padding makes the LM's key mask matter."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (BATCH, MAX_LEN + 1))
    steps = np.arange(MAX_LEN)[None, :]
    if lm:
        steps = MAX_LEN - 1 - steps
    m = ((steps < np.array(LENGTHS)[:, None]).astype(np.float32)
         if masked else None)
    if lm:
        y = np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]
    else:
        y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, BATCH)]
    return ids[:, :MAX_LEN], y, m


# (language model?, feature mask?): the classifier, the LM with its mask as
# features and labels mask, and the unmasked LM
RUNS = [(False, True), (True, True), (True, False)]


@functools.lru_cache(maxsize=None)
def _jax_run(lm, masked):
    """The JAX graph's outputs, score, gradients and 3 Adam fit steps on
    one batch."""
    jnet = _zoo(JTransformer, lm).init()
    _spread(jnet)
    params, state = _np(jnet.params), _np(jnet.state)
    x, y, m = _batch(lm, masked, 1)
    ds = JDataSet(x, y, features_mask=m, labels_mask=m if lm else None)
    grads, gscore = jnet.compute_gradient_and_score(ds)
    return {
        "conf": jnet.conf.to_json(), "params": params, "state": state,
        "x": x, "y": y, "m": m,
        "out_masked": np.asarray(jnet.output(x, fmasks=[m])),
        "out": np.asarray(jnet.output(x)), "score": jnet.score(ds),
        "grads": _np(grads), "gscore": float(gscore),
        "losses": [jnet.fit_batch(ds) for _ in range(STEPS)],
        "params_after": _np(jnet.params)}


def _port_net(r, use_kernels=False):
    conf = ComputationGraphConfiguration.from_json(r["conf"])
    conf.use_kernels = use_kernels
    net = ComputationGraph(conf, device="cpu")
    return net.set_params(*params_from_jax(conf, r["params"], r["state"]))


def _port_ds(r, lm):
    return DataSet(r["x"], r["y"], features_mask=r["m"],
                   labels_mask=r["m"] if lm else None)


def _assert_params_close(got, want, start, lr, steps, what):
    """Params after ``steps`` Adam steps from ``start``: each tensor's
    update within UPDATE_L2 relative L2 error (bk aside), every element
    within Adam's largest move (module docstring)."""
    for k, vp in want.items():
        for p, v in vp.items():
            g = got[k][p].detach().double()
            w, s = v.double(), start[k][p].double()
            assert float((g - w).abs().max()) <= 2 * lr * steps, (what, k, p)
            if p == ZERO_GRAD:
                continue
            err = float((g - w).norm() / (w - s).norm().clamp_min(1e-30))
            assert err <= UPDATE_L2, (what, k, p, err)


@pytest.mark.parametrize("lm", [False, True], ids=["classifier", "lm"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_output_honours_feature_masks_as_the_jax_graph(lm, use_kernels):
    r = _jax_run(lm, True)
    net = _port_net(r, use_kernels)
    got = net.output(r["x"], fmasks=[r["m"]])
    np.testing.assert_allclose(got, r["out_masked"], **OUT_TOL)
    np.testing.assert_allclose(net.output(r["x"]), r["out"], **OUT_TOL)
    assert np.abs(r["out_masked"] - r["out"]).max() > 1e-3  # the mask acts
    # feed_forward takes the masks too: the attention output of a masked
    # step is zeroed
    ff = net.feed_forward(r["x"], fmasks=[r["m"]])
    np.testing.assert_allclose(ff["output"], r["out_masked"], **OUT_TOL)
    assert np.all(ff["b0_attn"][r["m"] == 0] == 0)


def test_the_classifier_pools_unmasked_as_the_jax_graph():
    """A GlobalPoolingLayer in a graph gets no mask (the JAX package's
    LayerVertex hands masks only to layers with uses_mask): the pooled
    features are the plain mean over every step, masked ones included."""
    r = _jax_run(False, True)
    net = _port_net(r)
    ff = net.feed_forward(r["x"], fmasks=[r["m"]])
    np.testing.assert_allclose(ff["pool"], ff["final_ln"].mean(axis=1),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lm", [False, True], ids=["classifier", "lm"])
def test_score_honours_feature_masks_as_the_jax_graph(lm):
    r = _jax_run(lm, True)
    net = _port_net(r, use_kernels=True)
    np.testing.assert_allclose(net.score(_port_ds(r, lm)), r["score"],
                               rtol=1e-5)


@pytest.mark.parametrize("run", RUNS, ids=["classifier", "lm-masked", "lm"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_compute_gradient_and_score_matches_jax(run, use_kernels):
    lm, masked = run
    r = _jax_run(lm, masked)
    net = _port_net(r, use_kernels)
    grads, score = net.compute_gradient_and_score(_port_ds(r, lm))
    np.testing.assert_allclose(score, r["gscore"], rtol=1e-5)
    want, _ = params_from_jax(net.conf, r["grads"], {})
    assert set(grads) == set(want)
    for k, vp in want.items():
        for p, v in vp.items():
            np.testing.assert_allclose(grads[k][p].numpy(), v.numpy(),
                                       err_msg=f"{k}.{p}", **GRAD_TOL)


@pytest.mark.parametrize("run", RUNS, ids=["classifier", "lm-masked", "lm"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_three_adam_fit_steps_match_jax(run, use_kernels, monkeypatch):
    """Losses and params after 3 steps; with use_kernels every step's
    attention backward is the flash Function's (its plain version on the
    CPU), once per block."""
    lm, masked = run
    r = _jax_run(lm, masked)
    net = _port_net(r, use_kernels)
    calls = []
    plain = att.flash_attention_bwd_plain

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(att, "flash_attention_bwd_plain", spy)
    ds = _port_ds(r, lm)
    losses = [net.fit_batch(ds) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, r["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    assert len(calls) == (LAYERS * STEPS if use_kernels else 0)
    want, _ = params_from_jax(net.conf, r["params_after"], {})
    start, _ = params_from_jax(net.conf, r["params"], {})
    _assert_params_close(net.params, want, start, LR, STEPS, "3 steps")


def test_adam_state_from_jax_resumes_lm_training():
    """A JAX LM takes one Adam step; the port takes its params, Adam m/v
    (embedding, LN, attention and dense params, each by its rule) and
    iteration, and its next step lands where the JAX package's next step
    does. Without the m/v state it lands elsewhere."""
    jnet = _zoo(JTransformer, True, updater=JAdam(learning_rate=0.01)).init()
    _spread(jnet)
    x0, y0, _ = _batch(True, False, 2)
    x1, y1, _ = _batch(True, False, 3)
    jnet.fit_batch(JDataSet(x0, y0))
    conf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    o = opt_state_from_jax(conf, _np(jnet.opt_state))
    assert o["b0_attn"]["Wq"]["m"].shape == p["b0_attn"]["Wq"].shape
    assert o["b0_ff1"]["W"]["v"].shape == p["b0_ff1"]["W"].shape
    assert set(o["embed"]) == {"W"} and set(o["b0_ln1"]) == {"gain", "b"}
    net = ComputationGraph(conf, device="cpu").set_params(p, s, o)
    net.iteration = jnet.iteration
    fresh = ComputationGraph(conf, device="cpu").set_params(p, s)
    fresh.iteration = jnet.iteration
    jnet.fit_batch(JDataSet(x1, y1))
    net.fit_batch(DataSet(x1, y1))
    fresh.fit_batch(DataSet(x1, y1))
    want, _ = params_from_jax(conf, _np(jnet.params), {})
    _assert_params_close(net.params, want, p, 0.01, 1, "step 2")
    far = max(float((fresh.params[k][pk] - v).abs().max())
              for k, vp in want.items() for pk, v in vp.items()
              if pk != ZERO_GRAD)
    assert far > 1e-3


# --------------------------------------------------------------------------
# the LM's layers in train mode
# --------------------------------------------------------------------------

def _layer_pair(name):
    r = _jax_run(True, False)
    jl = JTransformer  # noqa: F841 (the JAX conf is rebuilt from its JSON)
    from deeplearning4j_tpu.conf.graph import (
        ComputationGraphConfiguration as JConf,
    )

    jlayer = JConf.from_json(r["conf"]).vertex_map()[name].vertex.layer
    conf = ComputationGraphConfiguration.from_json(r["conf"])
    player = conf.vertex_map()[name].vertex.layer
    return jlayer, r["params"][name], player, convert_layer_params(
        player, r["params"][name])


@pytest.mark.parametrize("name", ["pos", "b0_ln1", "b0_ff1", "b1_ff2"])
def test_sequence_layers_train_like_the_jax_package(name):
    """Train-mode forward on [B, T, E] and the gradients of <y, g> for the
    params and the input."""
    jl, jp, pl, pp = _layer_pair(name)
    rng = np.random.default_rng(8)
    n_in = 4 * E if name == "b1_ff2" else E
    x = rng.standard_normal((BATCH, MAX_LEN, n_in)).astype(np.float32)
    y_j = np.asarray(jl.forward(jp, {}, jnp.asarray(x), train=True)[0])
    g = rng.standard_normal(y_j.shape).astype(np.float32)

    def jf(p, x_):
        return jnp.sum(jl.forward(p, {}, x_, train=True)[0] * g)

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in pp.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, _ = pl.forward(leaves, {}, xt, train=True)
    np.testing.assert_allclose(y.detach().numpy(), y_j, **OUT_TOL)
    gx, *gp = torch.autograd.grad((y * torch.tensor(g)).sum(),
                                  [xt] + list(leaves.values()))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = convert_layer_params(pl, _np(jgp))
    for k, got in zip(leaves, gp):
        np.testing.assert_allclose(got.numpy(), want[k].numpy(),
                                   err_msg=k, rtol=1e-4, atol=1e-5)


def test_embedding_gradient_is_a_scatter_add_of_repeated_ids():
    jl, jp, pl, pp = _layer_pair("embed")
    ids = np.array([[3, 3, 5, 3], [5, 0, 36, 3]])
    g = np.random.default_rng(9).standard_normal((2, 4, E)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(
        jl.forward(p, {}, jnp.asarray(ids), train=True)[0] * g))(jp)
    w = pp["W"].clone().requires_grad_()
    y, _ = pl.forward({"W": w}, {}, torch.tensor(ids), train=True)
    gw, = torch.autograd.grad((y * torch.tensor(g)).sum(), (w,))
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg["W"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(gw[3].numpy(), g[0, 0] + g[0, 1] + g[0, 3]
                               + g[1, 3], rtol=1e-6, atol=1e-6)


def test_time_distributed_softmax_score_with_a_label_mask():
    """OutputLayer.score with LossMCXENT on [B, T, V] labels and a [B, T]
    label mask: the masked mean over positions (JAX ``losses._reduce``),
    and its gradients."""
    jl, jp, pl, pp = _layer_pair("output")
    rng = np.random.default_rng(10)
    x = rng.standard_normal((BATCH, MAX_LEN, E)).astype(np.float32)
    _, y, m = _batch(True, True, 11)

    def jf(p, x_):
        return jl.score(p, x_, jnp.asarray(y), jnp.asarray(m))

    j_loss = float(jf(jp, jnp.asarray(x)))
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in pp.items()}
    xt = torch.tensor(x, requires_grad=True)
    loss = pl.score(leaves, xt, torch.tensor(y), torch.tensor(m))
    np.testing.assert_allclose(float(loss.detach()), j_loss, rtol=1e-6)
    gx, *gp = torch.autograd.grad(loss, [xt] + list(leaves.values()))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD_TOL)
    want = convert_layer_params(pl, _np(jgp))
    for k, got in zip(leaves, gp):
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), err_msg=k,
                                   **GRAD_TOL)
    # masked positions weigh nothing (row 3 has only its last step)
    assert float(gx[3, :-1].abs().max()) == 0.0
