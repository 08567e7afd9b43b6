"""Ring attention in the port against the JAX package.

The port side is one spawn of two gloo ranks (``sequence`` 2): every rank
passes the whole ``[B, H, T, D]`` arrays to ``ops.ring.ring_attention``,
which cuts T over the ranks, rotates K / V and the key mask one hop a step
(the rotation's backward rotating the cotangents back) and gathers the
output; the gradients of ``sum(o * do)`` come back whole on every rank.
The reference side is the JAX package's ``ring_attention`` over a
2-device ``sequence`` mesh of the conftest's CPU devices and its
``reference_attention`` (the test oracle of ``tests/test_attention.py``),
on the same seeded numpy arrays. Tolerances as
``tests/test_attention.py`` holds the JAX ring: 2e-5 on the output, 1e-4
on the gradients (float32 sums of 64 keys in two blocks, online
rescaling)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from deeplearning4j_tpu.ops.attention import reference_attention
from deeplearning4j_tpu.ops.ring import ring_attention as jring
from deeplearning4j_tpu_torch.ops import ring_attention
from deeplearning4j_tpu_torch.ops.ring import ring_attention_local
from deeplearning4j_tpu_torch.parallel import spawn
from deeplearning4j_tpu_torch.parallel.mesh import Mesh

from tests import torch_sharding_ranks as ranks
from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

SPAWN_TIMEOUT = 120.0
FWD = dict(atol=2e-5, rtol=2e-5)
BWD = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_executables_left():
    """This module leaves nothing in the JAX package's executable cache
    (bounded at 256 entries): the JAX tests that count its entries
    (``tests/test_fused.py``) may run after it in the same worker."""
    yield
    from deeplearning4j_tpu.optimize import aot_cache as jax_aot_cache

    jax_aot_cache.clear()


def _case(causal, masked, seed):
    rng = np.random.default_rng(seed)
    b, h, t, d = 2, 2, 64, 16
    q, k, v, do = (rng.normal(size=(b, h, t, d)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if masked:
        lengths = np.array([64, 37])
        mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return {"name": f"{'causal' if causal else 'bidi'}_"
                    f"{'masked' if masked else 'open'}",
            "fn": "ring", "q": q, "k": k, "v": v, "do": do, "mask": mask,
            "causal": causal}


CASES = [_case(c, m, i) for i, (c, m) in enumerate(
    ((True, True), (False, True), (True, False), (False, False)))]


@pytest.fixture(scope="module")
def port2(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring2"))
    return spawn(ranks.run_scenarios, 2, (CASES, tmp), backend="gloo",
                 device="cpu", timeout=SPAWN_TIMEOUT)


def _jax(case, ring: bool):
    q, k, v, do = (jnp.asarray(case[n]) for n in ("q", "k", "v", "do"))
    km = None if case["mask"] is None else jnp.asarray(case["mask"])
    mesh = JMesh(np.array(jax.devices()[:2]), ("sequence",))

    def f(q, k, v):
        if ring:
            return jring(q, k, v, mesh, km, causal=case["causal"])
        return reference_attention(q, k, v, km, case["causal"])

    def run(q, k, v, do):
        o, vjp = jax.vjp(f, q, k, v)
        return (o,) + tuple(vjp(do))

    # one compiled program: the eager shard_map re-traces every call
    return [np.asarray(a) for a in jax.jit(run)(q, k, v, do)]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_ring_matches_the_jax_ring_and_reference(port2, case):
    for want in (_jax(case, ring=True), _jax(case, ring=False)):
        for rank in range(2):
            got = port2[rank][case["name"]]
            np.testing.assert_allclose(got["o"], want[0], **FWD)
            for name, w in zip(("dq", "dk", "dv"), want[1:]):
                np.testing.assert_allclose(got[name], w, **BWD, err_msg=name)


def test_the_ranks_agree_bit_for_bit(port2):
    for case in CASES:
        a, b = port2[0][case["name"]], port2[1][case["name"]]
        for key in ("o", "dq", "dk", "dv"):
            np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("causal", [False, True])
def test_one_rank_runs_the_ring_body_alone(causal):
    """A mesh of one sequence rank (no process group): the body's one
    block, against the reference; the time axis must divide evenly."""
    case = _case(causal, True, 7)
    q, k, v = (torch.tensor(case[n]) for n in ("q", "k", "v"))
    km = torch.tensor(case["mask"])
    got = ring_attention(q, k, v, Mesh(data=1, data_rank=0), km, causal=causal)
    want = np.asarray(reference_attention(case["q"], case["k"], case["v"],
                                          case["mask"], causal))
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    local = ring_attention_local(q, k, v, km, None, 1, 0, causal)
    np.testing.assert_array_equal(local.numpy(), got.numpy())
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q[:, :, :63], k[:, :, :63], v[:, :, :63],
                       Mesh(data=1, data_rank=0, sequence=2), None)
