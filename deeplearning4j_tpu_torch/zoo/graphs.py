"""Model zoo — ComputationGraph models.

Reference: ``org.deeplearning4j.zoo.model.ResNet50``; the topology is the
JAX package's ``zoo/graphs.py::ResNet50`` (the plain 7x7/2 stem; unfused
conv + BN pairs, or ``fused_conv_bn``), so both packages build the same
configuration JSON.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.conf import Activation, InputType, WeightInit
from deeplearning4j_tpu_torch.conf.graph import (
    ComputationGraphConfiguration,
    ElementWiseOp,
    ElementWiseVertex,
)
from deeplearning4j_tpu_torch.conf.layers import ActivationLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
    GlobalPoolingLayer,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.conf.updaters import Adam, IUpdater
from deeplearning4j_tpu_torch.zoo.models import ZooModel


class GraphZooModel(ZooModel):
    def init(self, device="cuda"):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(self.conf(), device=device).init()


class ResNet50(GraphZooModel):
    """Reference ``org.deeplearning4j.zoo.model.ResNet50``: conv7x7/2 + BN +
    maxpool3x3/2, 4 stages of bottleneck blocks [3,4,6,3] with channel
    triples (64,64,256)x, residual add via ``ElementWiseVertex(Add)``,
    global avg pool + softmax."""

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None):
        self.num_classes = num_classes
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)

    fused_conv_bn: bool = False
    """Route every 1x1-conv + BN pair through ``FusedConvBN1x1`` (the same
    function, with the BN statistics fused into the conv's output pass by
    the ``matmul_stats`` kernel). ResNet-50 has 36 such pairs (bottleneck
    a/c convs and projections). Weights map 1:1 from the unfused graph via
    :meth:`fused_param_remap`. Default off keeps the reference's layer-pair
    topology. Set via attribute after construction."""

    def _conv_bn(self, g, name, n_out, k, s, inp, act=True):
        if self.fused_conv_bn and tuple(k) == (1, 1):
            g.add_layer(f"{name}_cb", FusedConvBN1x1(
                n_out=n_out, stride=s,
                activation=Activation.RELU if act else Activation.IDENTITY),
                inp)
            return f"{name}_cb"
        g.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel_size=k, stride=s,
                                     activation=Activation.IDENTITY,
                                     convolution_mode=ConvolutionMode.SAME,
                                     has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(
            activation=Activation.RELU if act else Activation.IDENTITY),
            f"{name}_conv")
        return f"{name}_bn"

    @staticmethod
    def fused_param_remap(params, state):
        """Map an unfused ResNet-50's params/state (the port's layouts: OIHW
        conv weights) onto the ``fused_conv_bn=True`` graph: every
        ``{n}_conv`` (W, 1x1, no bias) + ``{n}_bn`` (gamma/beta, running
        mean/var) pair collapses into ``{n}_cb`` holding all five; other
        vertices pass through unchanged."""
        def fusable_pair(n):
            conv = params.get(f"{n}_conv", {})
            return (f"{n}_bn" in params and conv.get("W") is not None
                    and tuple(conv["W"].shape[2:]) == (1, 1)
                    and "b" not in conv)

        new_p, new_s = {}, {}
        for k, v in params.items():
            if k.endswith("_conv") and fusable_pair(k[:-5]):
                n = k[:-5]
                new_p[f"{n}_cb"] = {"W": v["W"],
                                    "gamma": params[f"{n}_bn"]["gamma"],
                                    "beta": params[f"{n}_bn"]["beta"]}
                new_s[f"{n}_cb"] = dict(state.get(f"{n}_bn", {}))
            elif k.endswith("_bn") and fusable_pair(k[:-3]):
                continue  # folded into the _cb entry above
            else:
                new_p[k] = v
                if k in state:
                    new_s[k] = state[k]
        return new_p, new_s

    def _bottleneck(self, g, name, inp, filters, stride, project):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_a", f1, (1, 1), stride, inp)
        x = self._conv_bn(g, f"{name}_b", f2, (3, 3), (1, 1), x)
        x = self._conv_bn(g, f"{name}_c", f3, (1, 1), (1, 1), x, act=False)
        if project:
            sc = self._conv_bn(g, f"{name}_sc", f3, (1, 1), stride, inp,
                               act=False)
        else:
            sc = inp
        g.add_vertex(f"{name}_add", ElementWiseVertex(op=ElementWiseOp.ADD),
                     x, sc)
        g.add_layer(f"{name}_relu", ActivationLayer(activation=Activation.RELU),
                    f"{name}_add")
        return f"{name}_relu"

    def conf(self) -> ComputationGraphConfiguration:
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(self.updater)
             .weight_init(WeightInit.RELU)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(
                 self.height, self.width, self.channels)))
        x = self._conv_bn(g, "stem", 64, (7, 7), (2, 2), "input")
        g.add_layer("stem_pool", SubsamplingLayer(
            pooling_type=PoolingType.MAX, kernel_size=(3, 3), stride=(2, 2),
            convolution_mode=ConvolutionMode.SAME), x)
        x = "stem_pool"
        stages = ((64, 64, 256, 3), (128, 128, 512, 4),
                  (256, 256, 1024, 6), (512, 512, 2048, 3))
        for si, (f1, f2, f3, reps) in enumerate(stages):
            for ri in range(reps):
                stride = (1, 1) if (si == 0 or ri > 0) else (2, 2)
                x = self._bottleneck(g, f"res{si + 2}{chr(97 + ri)}", x,
                                     (f1, f2, f3), stride, project=(ri == 0))
        g.add_layer("avgpool",
                    GlobalPoolingLayer(pooling_type=PoolingType.AVG), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation=Activation.SOFTMAX,
                                          loss_fn=LossMCXENT()), "avgpool")
        g.set_outputs("output")
        return g.build()
