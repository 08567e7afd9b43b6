"""The port's mixture-of-experts layer (``conf/layers_moe.py``,
``parallel/expert.py``) against the JAX package's, on the CPU, in one
process (the sharded cases are in ``tests/test_torch_expert_parallel.py``).

- ``moe_apply`` (routing by index) against the JAX package's (dense
  one-hot einsums) on the same params and tokens: top-1 and top-2, ample
  capacity and capacities that drop tokens, with and without biases and
  the residual; outputs, the aux loss, and the gradients of ``sum(y * r) +
  aux`` with respect to the router, the experts and the tokens.
- The JAX package's own MoE cases: dropped tokens keep their residual,
  the top-1 router learns through the task loss with the raw probability
  as its gate, top-2 gates sum to 1, top-k ties go to the lower expert.
- ``MoELayer`` in a ``ComputationGraph`` (the JAX package's
  ``tests/test_moe_layer.py`` graph): output and SGD steps from the JAX
  params with the aux loss in the score, the aux reaching the objective
  and not eval scores, the zip both ways; ``TransformerEncoder`` with MoE
  blocks (its JSON, a small LM's outputs, a step, the zip with Adam state
  and the ``__aux_loss__`` state); the KV-cached decoder refuses it as the
  JAX decoder does.

Routing is discrete: each comparison states the smallest margin between a
token's k-th and (k+1)-th router probability, and asserts it lies above
the forward tolerance (a tie within rounding could send a token elsewhere
in each package); the seeds here keep it there.

Tolerances: forwards rtol 1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-5
(products summed in other orders); networks rtol 1e-4, atol 1e-6; scores
rtol 1e-5; params after an SGD step atol 2e-6; zips bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.layers_moe import MoELayer as JMoE
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.conf.updaters import Sgd as JSgd
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.parallel import expert as jexpert
from deeplearning4j_tpu.util import params as jparams
from deeplearning4j_tpu.util import serializer as jser
from deeplearning4j_tpu.zoo.graphs import TransformerEncoder as JTransformer
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.conf.layers_moe import AUX_LOSS_KEY, MoELayer
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.parallel import expert
from deeplearning4j_tpu_torch.util import params as pparams
from deeplearning4j_tpu_torch.util import serializer as ser
from deeplearning4j_tpu_torch.util.convert import (
    opt_state_to_jax,
    params_from_jax,
    params_to_jax,
)
from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
NET = dict(rtol=1e-4, atol=1e-6)
STEP = dict(rtol=0, atol=2e-6)
D, CLASSES = 16, 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def margin(probs, k: int) -> float:
    """The smallest gap between a token's k-th and (k+1)-th probability."""
    s = -np.sort(-np.asarray(probs), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


def _moe_params(seed, e, dh, bias=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, e)) / np.sqrt(D),
         "w1": rng.standard_normal((e, D, dh)) / np.sqrt(D),
         "w2": rng.standard_normal((e, dh, D)) / np.sqrt(dh)}
    if bias:
        p["b1"] = 0.1 * rng.standard_normal((e, dh))
        p["b2"] = 0.1 * rng.standard_normal((e, D))
    return {k: v.astype(np.float32) for k, v in p.items()}


MOE_CASES = {
    "top1_ample": dict(top_k=1, e=4, t=32, cap=32),
    "top2_ample": dict(top_k=2, e=4, t=32, cap=64),
    "top1_drops": dict(top_k=1, e=4, t=32, cap=5),
    "top2_drops": dict(top_k=2, e=8, t=40, cap=6),
    "top2_no_bias_no_residual": dict(top_k=2, e=4, t=24, cap=8, bias=False,
                                     residual=False),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    c = dict(MOE_CASES[case])
    k, e, t, cap = c["top_k"], c["e"], c["t"], c["cap"]
    bias, residual = c.get("bias", True), c.get("residual", True)
    p = _moe_params(list(MOE_CASES).index(case) + 1, e, 2 * D, bias)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((t, D)).astype(np.float32)
    r = rng.standard_normal((t, D)).astype(np.float32)
    probs = jax.nn.softmax(x @ p["router"], axis=-1)
    gap = margin(probs, k)
    assert gap > 1e-4, (f"a token's k-th and (k+1)-th router probabilities "
                        f"lie {gap:.1e} apart, under the forward tolerance: "
                        f"the packages may route it differently")

    def jfn(pp, xx):
        return jexpert.moe_apply(pp["router"], pp["w1"], pp["w2"], xx, e,
                                 cap, top_k=k, axis_name=None,
                                 b1=pp.get("b1"), b2=pp.get("b2"),
                                 residual=residual)

    jy, jaux = jfn(p, x)
    jg, jgx = jax.grad(lambda pp, xx: jnp.sum(jfn(pp, xx)[0] * r)
                       + jfn(pp, xx)[1], argnums=(0, 1))(p, x)

    tp = {kk: torch.tensor(v, requires_grad=True) for kk, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = expert.moe_apply(tp["router"], tp["w1"], tp["w2"], tx, e, cap,
                              top_k=k, axis_name=None, b1=tp.get("b1"),
                              b2=tp.get("b2"), residual=residual)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    ((y * torch.tensor(r)).sum() + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD)
    for kk in p:
        np.testing.assert_allclose(tp[kk].grad.numpy(), np.asarray(jg[kk]),
                                   **GRAD, err_msg=kk)
    _, _, pos, keep = expert.route(torch.tensor(np.asarray(probs)), k, cap)
    dropped = int((~keep).sum())
    assert (dropped == 0) == case.endswith("ample")


def test_capacity_drops_pass_the_residual():
    """Every token forced to expert 0 with capacity 2: the first two are
    routed, the other four come out as they went in."""
    p = _moe_params(1, 2, 8, bias=False)
    p["router"][:, 0], p["router"][:, 1] = 5.0, -5.0
    x = np.abs(np.random.default_rng(1).standard_normal((6, D))).astype(
        np.float32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    y, _ = expert.moe_apply(tp["router"], tp["w1"], tp["w2"],
                            torch.tensor(x), 2, 2, axis_name=None)
    changed = (y - torch.tensor(x)).abs().max(dim=1).values
    assert bool((changed[:2] > 1e-4).all())
    np.testing.assert_array_equal(y[2:].numpy(), x[2:])


def test_top1_router_learns_through_the_task_loss_with_its_raw_gate():
    p = _moe_params(11, 4, 16, bias=False)
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((32, D)).astype(np.float32))
    tgt = torch.tensor(rng.standard_normal((32, D)).astype(np.float32))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    y, _ = expert.moe_apply(tp["router"], tp["w1"], tp["w2"], x, 4, 32,
                            top_k=1, axis_name=None)
    torch.mean((y - tgt) ** 2).backward()
    assert float(tp["router"].grad.abs().max()) > 1e-6
    # identical experts: x + p_top1 * ffn(x), not x + ffn(x)
    w1 = torch.tensor(p["w1"][:1]).expand(4, -1, -1)
    w2 = torch.tensor(p["w2"][:1]).expand(4, -1, -1)
    router = torch.tensor(p["router"])
    y, _ = expert.moe_apply(router, w1, w2, x, 4, 32, top_k=1,
                            axis_name=None)
    p1 = torch.softmax(x @ router, dim=-1).max(dim=-1, keepdim=True).values
    ffn = torch.relu(x @ w1[0]) @ w2[0]
    torch.testing.assert_close(y, x + p1 * ffn, rtol=1e-4, atol=1e-5)


def test_top2_gates_sum_to_one():
    """Identical experts and ample capacity: top-2's output is one plain
    FFN pass, whatever the routing."""
    p = _moe_params(5, 4, 16, bias=False)
    x = torch.tensor(np.random.default_rng(5).standard_normal(
        (8, D)).astype(np.float32))
    w1 = torch.tensor(p["w1"][:1]).expand(4, -1, -1)
    w2 = torch.tensor(p["w2"][:1]).expand(4, -1, -1)
    y, _ = expert.moe_apply(torch.tensor(p["router"]), w1, w2, x, 4, 8,
                            top_k=2, axis_name=None)
    want = x + torch.relu(x @ w1[0]) @ w2[0]
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-5)


def test_top_k_ties_go_to_the_lower_expert_as_in_jax():
    """A zero router gives every token uniform probabilities: the first k
    experts win, in both packages (``jax.lax.top_k``'s order)."""
    probs = np.full((5, 6), 1.0 / 6.0, np.float32)
    probs[1, 3] = probs[1, 5] = 0.5       # a tie above the rest
    want = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
    kidx, _, _, _ = expert.route(torch.tensor(probs), 2, 4)
    np.testing.assert_array_equal(kidx.numpy(), want)
    assert want[0].tolist() == [0, 1] and want[1].tolist() == [3, 5]


def test_a_sharded_expert_outside_an_expert_axis_raises():
    layer = MoELayer(n_experts=4, d_hidden=8)
    from deeplearning4j_tpu_torch.conf.inputs import FeedForward

    p = layer.init(torch.Generator().manual_seed(0), FeedForward(size=D))
    half = {k: (v if k == "router" else v[:2]) for k, v in p.items()}
    with pytest.raises(RuntimeError, match="active_expert_axis"):
        layer.forward(half, layer.init_state(None), torch.zeros(3, D))
    with pytest.raises(ValueError, match="no mesh axis"):
        expert.moe_apply(half["router"], half["w1"], half["w2"],
                         torch.zeros(3, D), 4, 2, axis_name=None)


# --------------------------------------------------------------------------
# MoELayer in a graph: the JAX package's tests/test_moe_layer.py graph
# --------------------------------------------------------------------------

def _moe_jconf(n_experts=4, top_k=2, aux_weight=1e-2, capacity_factor=8.0):
    g = (JNNC.builder().seed(7).updater(JSgd(learning_rate=0.1))
         .weight_init(JWI.XAVIER).graph_builder().add_inputs("input")
         .set_input_types(JIT.feed_forward(D)))
    g.add_layer("embed", JDense(n_out=D, activation=JAct.TANH), "input")
    g.add_layer("moe", JMoE(n_experts=n_experts, d_hidden=2 * D,
                            top_k=top_k, aux_weight=aux_weight,
                            capacity_factor=capacity_factor), "embed")
    g.add_layer("out", JOut(n_out=CLASSES, activation=JAct.SOFTMAX,
                            loss_fn=JMCXENT()), "moe")
    g.set_outputs("out")
    return g.build()


def _batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return x, y


def _port_graph(jconf, jnet):
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    p, s = params_from_jax(conf, _np(jnet.params), _np(jnet.state))
    return ComputationGraph(conf, device="cpu").set_params(p, s)


def _same_params(net, jnet, **tol):
    got, _ = params_to_jax(net.conf, net.params, net.state)
    for k, vp in _np(jnet.params).items():
        for name, v in vp.items():
            np.testing.assert_allclose(got[k][name], v, err_msg=f"{k}/{name}",
                                       **tol)


@pytest.mark.parametrize("top_k,cf", [(1, 8.0), (2, 8.0), (2, 0.5)],
                         ids=["top1", "top2", "top2_drops"])
def test_moe_graph_steps_as_the_jax_graph(top_k, cf):
    """Output, three SGD steps (aux loss in the score) and the aux state
    from the JAX params."""
    jconf = _moe_jconf(top_k=top_k, capacity_factor=cf)
    jnet = JGraph(jconf).init()
    net = _port_graph(jconf, jnet)
    x, y = _batch()
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    for _ in range(3):
        assert net.fit_batch(DataSet(x, y)) == pytest.approx(
            float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)
    _same_params(net, jnet, **STEP)
    assert float(net.state["moe"][AUX_LOSS_KEY]) == pytest.approx(
        float(jnet.state["moe"][AUX_LOSS_KEY]), rel=1e-5)
    assert not net.state["moe"][AUX_LOSS_KEY].requires_grad


def test_moe_layer_trains_locally():
    conf = ComputationGraphConfiguration.from_json(_moe_jconf().to_json())
    net = ComputationGraph(conf, device="cpu").init()
    x, y = _batch()
    first = net.fit_batch(DataSet(x, y))
    for _ in range(30):
        loss = net.fit_batch(DataSet(x, y))
    assert loss < first * 0.7
    out = net.output(x)
    assert out.shape == (32, CLASSES)
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def _two_nets(aux0, aux1):
    c0 = ComputationGraphConfiguration.from_json(
        _moe_jconf(aux_weight=aux0).to_json())
    c1 = ComputationGraphConfiguration.from_json(
        _moe_jconf(aux_weight=aux1).to_json())
    n0 = ComputationGraph(c0, device="cpu").init()
    n1 = ComputationGraph(c1, device="cpu").set_params(n0.params, n0.state)
    return n0, n1


def test_moe_aux_loss_reaches_the_objective():
    n0, n1 = _two_nets(0.0, 0.5)
    x, y = _batch()
    l0 = n0.fit_batch(DataSet(x, y))
    l1 = n1.fit_batch(DataSet(x, y))
    aux = float(n1.state["moe"][AUX_LOSS_KEY])
    assert aux > 0.0
    assert l1 - l0 == pytest.approx(aux, rel=1e-3, abs=1e-5)


def test_moe_aux_is_not_in_eval_scores():
    n0, n1 = _two_nets(0.0, 0.5)
    x, y = _batch()
    n0.fit_batch(DataSet(x, y))
    n1.fit_batch(DataSet(x, y))
    aux = float(n1.state["moe"][AUX_LOSS_KEY])
    assert aux > 0.0
    x2, y2 = _batch(seed=99)
    assert abs(n1.score(DataSet(x2, y2)) - n0.score(DataSet(x2, y2))) \
        < 0.5 * aux


def test_moe_graph_zip_crosses_both_ways(tmp_path):
    jconf = _moe_jconf(top_k=1)
    jnet = JGraph(jconf).init()
    x, y = _batch()
    jnet.fit_batch(JDataSet(x, y))
    jser.write_model(jnet, tmp_path / "jax.zip")
    net = ser.restore_computation_graph(tmp_path / "jax.zip", device="cpu")
    lay = net.conf.vertex_map()["moe"].vertex.layer
    assert isinstance(lay, MoELayer) and (lay.n_experts, lay.top_k) == (4, 1)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    assert float(net.state["moe"][AUX_LOSS_KEY]) == float(
        jnet.state["moe"][AUX_LOSS_KEY])
    ser.write_model(net, tmp_path / "port.zip")
    back = jser.restore_computation_graph(tmp_path / "port.zip")
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  net.params_flat())


# --------------------------------------------------------------------------
# the MoE transformer
# --------------------------------------------------------------------------

LM = dict(vocab_size=40, embed_dim=16, n_heads=2, n_layers=2, max_len=12,
          causal=True, lm_head=True, moe_experts=4, moe_top_k=2)


def _lm_pair():
    jnet = JTransformer(**LM).init()
    net = _port_graph(JTransformer(**LM).conf(), jnet)
    return jnet, net


def _tokens(seed=3, b=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, LM["vocab_size"], (b, LM["max_len"]))
    x = ids.astype(np.int32)
    y = np.eye(LM["vocab_size"], dtype=np.float32)[np.roll(ids, -1, axis=1)]
    return x, y


def test_moe_transformer_conf_is_the_jax_conf():
    assert TransformerEncoder(**LM).conf().to_json() == \
        JTransformer(**LM).conf().to_json()
    vm = TransformerEncoder(**LM).conf().vertex_map()
    moe = vm["b1_moe"].vertex.layer
    assert (moe.n_experts, moe.top_k, moe.capacity_factor, moe.residual,
            moe.d_hidden) == (4, 2, 1.25, False, 64)
    assert tuple(vm["b1_res2"].inputs) == ("b1_res1", "b1_moe")


def test_moe_lm_outputs_and_a_step_match_jax():
    jnet, net = _lm_pair()
    x, y = _tokens()
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               **NET)
    assert net.fit_batch(DataSet(x, y)) == pytest.approx(
        float(jnet.fit_batch(JDataSet(x, y))), rel=1e-5)
    np.testing.assert_allclose(net.output(x), np.asarray(jnet.output(x)),
                               rtol=1e-3, atol=1e-5)


def test_moe_lm_zip_crosses_with_its_adam_state(tmp_path):
    """A trained MoE LM's zip from the JAX package restores in the port
    (params, Adam state key by key, the aux state) and the port's
    restores in the JAX package (params). The JAX zip holds each layer's
    updater state in sorted key order (b1, b2, router, w1, w2); the port
    reads it back by key. The JAX package's restore assigns it in init
    order (router, w1, w2, b1, b2) and so misplaces every MoE moment (a
    reference defect, ROADMAP C): a JAX net restored from the zip is not
    trained on here."""
    jnet, _ = _lm_pair()
    x, y = _tokens()
    jnet.fit_batch(JDataSet(x, y))
    assert list(jnet.opt_state["b0_moe"]) == sorted(jnet.opt_state["b0_moe"])
    jser.write_model(jnet, tmp_path / "jax.zip")
    net = ser.restore_computation_graph(tmp_path / "jax.zip", device="cpu")
    np.testing.assert_array_equal(net.params_flat(),
                                  np.asarray(jnet.params_flat()))
    np.testing.assert_array_equal(
        pparams.flatten_state_like(net.conf, net.opt_state),
        jparams.flatten_state_like(_np(jnet.opt_state)))
    got = opt_state_to_jax(net.conf, net.opt_state)
    for pk, st in _np(jnet.opt_state)["b0_moe"].items():
        for sk, v in st.items():
            np.testing.assert_array_equal(got["b0_moe"][pk][sk], v)
    assert float(net.state["b0_moe"][AUX_LOSS_KEY]) == float(
        jnet.state["b0_moe"][AUX_LOSS_KEY])
    ser.write_model(net, tmp_path / "port.zip")
    back = jser.restore_computation_graph(tmp_path / "port.zip")
    np.testing.assert_array_equal(np.asarray(back.params_flat()),
                                  net.params_flat())
    np.testing.assert_allclose(np.asarray(back.output(x)), net.output(x),
                               **NET)


def test_the_decoder_refuses_an_moe_lm_as_jax_does():
    from deeplearning4j_tpu.nn.decoding import (
        TransformerDecoder as JDecoder,
    )

    jnet, net = _lm_pair()
    with pytest.raises(ValueError, match="b0_moe.*KV-cached decode path"):
        JDecoder(jnet)
    with pytest.raises(ValueError,
                       match="b0_moe.*KV-cached decode path.*cross-row"):
        TransformerDecoder(net)
