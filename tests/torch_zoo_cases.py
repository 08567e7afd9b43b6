"""Shared cases of the zoo parity tests (``test_torch_zoo_graphs.py``,
``test_torch_zoo_detect.py``): each zoo model at the JAX package's test
size (``tests/test_zoo.py``), built once per module in both packages on
the port's seeded weights.

The port network is ``init`` on the CPU with its batch norms given seeded
statistics and affines (init's identity BN would leave them untested);
the JAX network holds the same params and state (``params_to_jax``),
without the JAX package's eager random draws. The port networks under
test take the JAX network's params back through ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu_torch.conf.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.kernels import impls, routing
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.util.convert import (
    params_from_jax,
    params_to_jax,
)

BATCH = 2
# float32 through up to ~60 layers, sums in other orders on each side:
# the head's softmax rtol 1e-4 atol 1e-6, the pre-head activation within
# 1e-4 of its largest magnitude
OUT_TOL = dict(rtol=1e-4, atol=1e-6)
ACT_RTOL = 1e-4


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_conf(jconf, **changes):
    conf = ComputationGraphConfiguration.from_json(jconf.to_json())
    return dataclasses.replace(conf, **changes) if changes else conf


def randomize_bn(net, seed):
    """``chip_smoke.randomize_bn`` with gammas in (0.5, 1.5)."""
    chip_smoke.randomize_bn(net, seed, gamma=(0.5, 1.5))


def jax_net_like(jconf, net):
    """The JAX package's network for ``jconf`` holding copies of the port
    network ``net``'s params and state, its updater afresh."""
    jnet = JGraph(jconf)
    p, s = params_to_jax(net.conf, net.params, net.state)
    # copies: a numpy view of a port tensor may back a CPU jax array, and
    # the port's in-place updates would then move the JAX params too
    jnet.params = jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)), p)
    jnet.state = jax.tree_util.tree_map(lambda v: jnp.array(np.array(v)), s)
    jnet.opt_state = {k: {pk: jnet._updater_for(k).init_state(v)
                          for pk, v in vp.items()}
                      for k, vp in jnet.params.items()}
    return jnet


def port_net_from_jax(jconf, jnet, **changes):
    conf = port_conf(jconf, **changes)
    p, s = params_from_jax(conf, np_tree(jnet.params), np_tree(jnet.state))
    return ComputationGraph(conf, device="cpu").set_params(p, s)


def head_input(conf):
    """The vertex feeding the network's output vertex."""
    return conf.vertex_map()[conf.network_outputs[0]].inputs[0]


def jax_run(jzoo, seed=0):
    """One model's shared run: the JAX conf, the JAX network on the port's
    seeded weights, an input batch, the JAX output and the activation
    feeding the head."""
    jconf = jzoo.conf()
    net = ComputationGraph(port_conf(jconf), device="cpu").init()
    randomize_bn(net, seed + 1)
    jnet = jax_net_like(jconf, net)
    t = jconf.input_types[0]
    x = np.random.default_rng(seed).random(
        (BATCH, t.height, t.width, t.channels)).astype(np.float32)
    ff = jnet.feed_forward(x)
    return {"jconf": jconf, "jnet": jnet, "x": x,
            "out": np.asarray(jnet.output(x)),
            "head_in": np.asarray(ff[head_input(jconf)])}


def routed_calls(monkeypatch):
    """Records the routed ``matmul_bias_act`` calls (on the CPU the wrapper
    runs its plain version)."""
    calls = []
    real = impls.matmul_bias_act

    def spy(x, w, b, act, **kw):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, b, act, **kw)

    monkeypatch.setattr(impls, "matmul_bias_act", spy)
    return calls


def check_output(run, monkeypatch, use_kernels):
    """The port network carried from the JAX one: the head's input within
    ``ACT_RTOL``, the output within ``OUT_TOL``; with ``use_kernels``, one
    routed call a site of ``routing.routed_sites``, at its (M, K, N)."""
    calls = routed_calls(monkeypatch)
    net = port_net_from_jax(run["jconf"], run["jnet"],
                            use_kernels=use_kernels)
    ff = net.feed_forward(run["x"])
    head = ff[head_input(net.conf)]
    want = run["head_in"]
    assert head.shape == want.shape
    assert float(np.abs(head - want).max()) <= ACT_RTOL * float(
        np.abs(want).max())
    out = net.output(run["x"])
    assert out.shape == run["out"].shape
    np.testing.assert_allclose(out, run["out"], **OUT_TOL)
    sites = routing.routed_sites(net.conf, BATCH, mode="cpu")
    if use_kernels:
        assert sites, "the model routes no site"
        want_calls = [((e.m, e.k), (e.n, e.k)) for _, _, e in sites]
        assert calls == want_calls * 2  # feed_forward, then output
    else:
        assert calls == []
    return net


def check_param_shapes(jconf):
    """Topo order, every param's shape (the port's, in the JAX layouts)
    and the param count equal the JAX package's (JAX shapes by
    ``jax.eval_shape`` of each vertex's init)."""
    conf = port_conf(jconf)
    assert conf.topo_order() == jconf.topo_order()
    net = ComputationGraph(conf, device="cpu").init()
    p, s = params_to_jax(conf, net.params, net.state)
    types = jconf.vertex_output_types()
    types.update(zip(jconf.network_inputs, jconf.input_types))
    vmap = jconf.vertex_map()
    want, want_state, total = {}, {}, 0
    for i, name in enumerate(jconf.topo_order()):
        spec = vmap[name]
        in_types = [types[src] for src in spec.inputs]
        shapes = jax.eval_shape(
            lambda k, v=spec.vertex, t=in_types: v.init(k, t, jnp.float32),
            jax.random.PRNGKey(i))
        if shapes:
            want[name] = {k: tuple(v.shape) for k, v in shapes.items()}
            total += sum(int(np.prod(v.shape)) for v in shapes.values())
        st = spec.vertex.init_state(in_types, jnp.float32)
        if st:
            want_state[name] = {k: tuple(v.shape) for k, v in st.items()}
    assert {k: {pk: v.shape for pk, v in vp.items()}
            for k, vp in p.items()} == want
    assert {k: {sk: v.shape for sk, v in vs.items()}
            for k, vs in s.items()} == want_state
    assert net.num_params() == total
    return net
