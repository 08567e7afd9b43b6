"""The port's ``ParallelInference`` over two CPU replicas
(``devices=["cpu", "cpu"]``: the split, padding and demux of a multi-card
run), held against the JAX package's network on the same params: ragged
request sizes 1-33 and a ``batch_limit`` tail equal the direct forward
(float32, rtol 1e-5, atol 1e-6: the two packages' CPU matmuls sum in other
orders); after the first call a bucket no size adds an envelope; and the
serving ladder with ``align`` equals the JAX package's.
"""

import jax
import numpy as np
import pytest

from deeplearning4j_tpu.conf import Activation as JAct
from deeplearning4j_tpu.conf import InputType as JIT
from deeplearning4j_tpu.conf import WeightInit as JWI
from deeplearning4j_tpu.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.conf.losses import LossMCXENT as JMCXENT
from deeplearning4j_tpu.conf.multilayer import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.parallel import batcher as jbatcher
from deeplearning4j_tpu_torch.conf.multilayer import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize import aot_cache
from deeplearning4j_tpu_torch.parallel import ParallelInference
from deeplearning4j_tpu_torch.parallel.batcher import (
    bucket_ladder,
    bucket_rows,
)
from deeplearning4j_tpu_torch.util.convert import params_from_jax

from tests.torch_threads import few_torch_threads  # noqa: E402,F401

pytestmark = pytest.mark.torch

TOL = dict(rtol=1e-5, atol=1e-6)
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def nets():
    conf = (JNNC.builder().seed(7).weight_init(JWI.XAVIER).list()
            .layer(JDense(n_out=10, activation=JAct.TANH))
            .layer(JOut(n_out=3, activation=JAct.SOFTMAX,
                        loss_fn=JMCXENT()))
            .set_input_type(JIT.feed_forward(4)).build())
    jnet = JMLN(conf).init()
    pconf = MultiLayerConfiguration.from_json(conf.to_json())
    p, s = params_from_jax(pconf,
                           jax.tree_util.tree_map(np.asarray, jnet.params),
                           jax.tree_util.tree_map(np.asarray, jnet.state))
    return jnet, MultiLayerNetwork(pconf, "cpu").set_params(p, s)


@pytest.fixture(autouse=True)
def fresh_envelopes():
    aot_cache.clear()
    yield


def _x(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 4)).astype(
        np.float32)


def test_ragged_sizes_equal_the_direct_forward(nets):
    jnet, net = nets
    pi = ParallelInference(net, devices=CPU2)
    assert pi.workers == 2 and pi.replicas[0] is net
    assert pi.replicas[1] is not net
    for n in range(1, 34):
        x = _x(n, seed=n)
        got = pi.output(x)
        assert got.shape == (n, 3)
        np.testing.assert_allclose(got, net.output(x), **TOL)
        np.testing.assert_allclose(got, np.asarray(jnet.output(x)), **TOL)


def test_sweep_adds_no_envelope_after_the_first_call_a_bucket(nets):
    _, net = nets
    pi = ParallelInference(net, devices=CPU2)
    for b in bucket_ladder(64, align=2):  # one call a bucket: 2..64
        pi.output(_x(b, seed=b))
    st = pi.cache_stats()
    # one envelope a bucket: two replicas on one device share theirs
    assert st["misses"] == 6
    for n in range(1, 34):
        pi.output(_x(n, seed=100 + n))
    assert pi.cache_stats()["misses"] == st["misses"]
    assert pi.cache_stats()["hits"] == st["hits"] + 2 * 33


def test_batch_limit_tail_rides_the_same_buckets(nets):
    jnet, net = nets
    pi = ParallelInference(net, batch_limit=16, devices=CPU2)
    # 38 = 16 + 16 + 6-row tail; the tail pads to the 8-row bucket
    x = _x(38, seed=8)
    pi.output(_x(16, seed=9))
    miss0 = pi.cache_stats()["misses"]
    got = pi.output(x)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x)), **TOL)
    assert pi.cache_stats()["misses"] - miss0 == 1  # the 8-row bucket
    miss1 = pi.cache_stats()["misses"]
    pi.output(_x(38, seed=10))
    assert pi.cache_stats()["misses"] == miss1


def test_exact_pad_and_workers(nets):
    _, net = nets
    pi = ParallelInference(net, devices=CPU2, bucketize=False)
    x = _x(7, seed=3)
    np.testing.assert_allclose(pi.output(x), net.output(x), **TOL)
    assert ParallelInference(net, devices=CPU2, workers=1).workers == 1
    with pytest.raises(ValueError, match="workers=3"):
        ParallelInference(net, devices=CPU2, workers=3)


@pytest.mark.parametrize("align", [1, 2, 3, 8])
def test_bucket_functions_equal_the_jax_packages(align):
    for n in range(1, 301):
        assert bucket_rows(n, align) == jbatcher.bucket_rows(n, align)
    for mb in range(1, 301):
        assert bucket_ladder(mb, align) == jbatcher.bucket_ladder(mb, align)
    assert bucket_rows(5) == jbatcher.bucket_rows(5) == 8
