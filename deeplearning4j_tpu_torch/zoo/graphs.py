"""Model zoo — ComputationGraph models.

Reference: ``org.deeplearning4j.zoo.model.{VGG16, VGG19, ResNet50,
SqueezeNet, Darknet19, UNet, Xception, InceptionResNetV1, TinyYOLO, YOLO2,
NASNet}``. Each topology, constructor argument and default is the JAX
package's ``zoo/graphs.py`` (ResNet50 with its space-to-depth stem and
``fused_conv_bn`` options; ``TransformerEncoder``'s dense-FFN classifier
and causal language model), so both packages build the same configuration
JSON. Residual adds are ``ElementWiseVertex(Add)``, concatenations
``MergeVertex`` over the channels.

With ``use_kernels`` on the conf (``dataclasses.replace(conf,
use_kernels=True)``), each model's plain 1x1 convolutions and dense layers
with an elementwise activation run the ``matmul_bias_act`` kernel
(``kernels/routing.py``); separable, transposed and wider convolutions,
pooling, batch norm and the heads stay on cuDNN and PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from deeplearning4j_tpu_torch.conf import Activation, InputType, WeightInit
from deeplearning4j_tpu_torch.conf.graph import (
    ComputationGraphConfiguration,
    ElementWiseOp,
    ElementWiseVertex,
    LayerVertex,
    MergeVertex,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.conf.layers import (
    ActivationLayer,
    DenseLayer,
    EmbeddingSequenceLayer,
    LossLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.conf.layers_attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    CnnLossLayer,
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
    GlobalPoolingLayer,
    PoolingType,
    SeparableConvolution2D,
    SpaceToDepthLayer,
    SubsamplingLayer,
    Upsampling2D,
    ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.conf.layers_extra import (
    LayerNormalization,
    PositionEmbeddingLayer,
)
from deeplearning4j_tpu_torch.conf.layers_objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.conf.losses import LossBinaryXENT, LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import NeuralNetConfiguration
from deeplearning4j_tpu_torch.conf.updaters import Adam, IUpdater, Nesterovs
from deeplearning4j_tpu_torch.zoo.models import ZooModel


def _conv(n_out, k, s=(1, 1), act=Activation.RELU, mode=ConvolutionMode.SAME,
          bias=True):
    return ConvolutionLayer(n_out=n_out, kernel_size=k, stride=s,
                            activation=act, convolution_mode=mode,
                            has_bias=bias)


def _maxpool(k=(2, 2), s=(2, 2), mode=ConvolutionMode.TRUNCATE):
    return SubsamplingLayer(pooling_type=PoolingType.MAX, kernel_size=k,
                            stride=s, convolution_mode=mode)


def _builder(model, weight_init):
    """The graph builder every image model starts from: seed, updater,
    weight init, one ``input`` of the model's image size."""
    return (NeuralNetConfiguration.builder()
            .seed(model.seed).updater(model.updater)
            .weight_init(weight_init)
            .graph_builder()
            .add_inputs("input")
            .set_input_types(InputType.convolutional(
                model.height, model.width, model.channels)))


class GraphZooModel(ZooModel):
    def init(self, device="cuda"):
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        return ComputationGraph(self.conf(), device=device).init()


class _ImageClassifier(GraphZooModel):
    """The constructor the image classifiers share (the JAX package's
    arguments and defaults)."""

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None):
        self.num_classes = num_classes
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)


class VGG16(_ImageClassifier):
    """Reference ``org.deeplearning4j.zoo.model.VGG16``: 13 conv3x3 SAME
    and 5 max-pools, then dense 4096, 4096 and the softmax head
    (138,357,544 params at 224x224x3, 1000 classes)."""

    BLOCKS: Tuple[Tuple[int, int], ...] = (
        (64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None):
        super().__init__(num_classes, height, width, channels, seed,
                         updater or Nesterovs(learning_rate=0.01,
                                              momentum=0.9))

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.XAVIER)
        prev = "input"
        for bi, (ch, reps) in enumerate(self.BLOCKS):
            for ri in range(reps):
                name = f"conv{bi + 1}_{ri + 1}"
                g.add_layer(name, _conv(ch, (3, 3)), prev)
                prev = name
            g.add_layer(f"pool{bi + 1}", _maxpool(), prev)
            prev = f"pool{bi + 1}"
        g.add_layer("fc1", DenseLayer(n_out=4096, activation=Activation.RELU),
                    prev)
        g.add_layer("fc2", DenseLayer(n_out=4096, activation=Activation.RELU),
                    "fc1")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation=Activation.SOFTMAX,
                                          loss_fn=LossMCXENT()), "fc2")
        g.set_outputs("output")
        return g.build()


class VGG19(VGG16):
    """Reference ``VGG19``: VGG16 with 4-deep conv blocks 3 to 5."""

    BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


class ResNet50(_ImageClassifier):
    """Reference ``org.deeplearning4j.zoo.model.ResNet50``: conv7x7/2 + BN +
    maxpool3x3/2, 4 stages of bottleneck blocks [3,4,6,3] with channel
    triples (64,64,256)x, residual add via ``ElementWiseVertex(Add)``,
    global avg pool + softmax."""

    stem_space_to_depth: bool = False
    """The JAX package's exact rewrite of the 7x7/2 stem conv as
    space-to-depth(2), zero-pad (1, 2, 1, 2) and a 4x4/1 ``TRUNCATE`` conv:
    ``out[i, j] = sum x[2i+di-2, 2j+dj-2] * W[di, dj]`` regrouped over 2x2
    input blocks, a stride-1 conv over 4x the channels. The same function;
    weights map through :meth:`stem_weights_to_s2d`. Default off keeps the
    reference's topology. Set via attribute after construction."""

    @staticmethod
    def stem_weights_to_s2d(w7):
        """The weight remap of ``stem_space_to_depth``, in the JAX
        package's HWIO layout (numpy): the reference stem's ``[7, 7, Cin,
        C]`` kernel -> the rewrite's ``[4, 4, 4 * Cin, C]`` kernel,
        ``w'[m, n, (a*2+b)*Cin + ch] = w[2m+a, 2n+b, ch]``; taps with
        ``2m+a >= 7`` or ``2n+b >= 7`` are zero. ``util.convert`` carries
        the result into the port's OIHW layout."""
        k7 = np.asarray(w7)
        cin = k7.shape[2]
        out = np.zeros((4, 4, 4 * cin, k7.shape[-1]), k7.dtype)
        for m in range(4):
            for a in range(2):
                if 2 * m + a >= 7:
                    continue
                for n in range(4):
                    for b in range(2):
                        if 2 * n + b >= 7:
                            continue
                        f = (a * 2 + b) * cin
                        out[m, n, f:f + cin] = k7[2 * m + a, 2 * n + b]
        return out

    fused_conv_bn: bool = False
    """Route every 1x1-conv + BN pair through ``FusedConvBN1x1`` (the same
    function, with the BN statistics fused into the conv's output pass by
    the ``matmul_stats`` kernel). ResNet-50 has 36 such pairs (bottleneck
    a/c convs and projections). Weights map 1:1 from the unfused graph via
    :meth:`fused_param_remap`. Default off keeps the reference's layer-pair
    topology. Set via attribute after construction."""

    def _conv_bn(self, g, name, n_out, k, s, inp, act=True,
                 mode=ConvolutionMode.SAME):
        if self.fused_conv_bn and tuple(k) == (1, 1):
            g.add_layer(f"{name}_cb", FusedConvBN1x1(
                n_out=n_out, stride=s,
                activation=Activation.RELU if act else Activation.IDENTITY),
                inp)
            return f"{name}_cb"
        g.add_layer(f"{name}_conv",
                    _conv(n_out, k, s, Activation.IDENTITY, mode, bias=False),
                    inp)
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
        g = _builder(self, WeightInit.RELU)
        if self.stem_space_to_depth:
            g.add_vertex("stem_s2d", LayerVertex(
                layer=SpaceToDepthLayer(block_size=2)), "input")
            g.add_vertex("stem_pad", LayerVertex(
                layer=ZeroPaddingLayer(padding=(1, 2, 1, 2))), "stem_s2d")
            x = self._conv_bn(g, "stem", 64, (4, 4), (1, 1), "stem_pad",
                              mode=ConvolutionMode.TRUNCATE)
        else:
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


class SqueezeNet(_ImageClassifier):
    """Reference ``SqueezeNet`` (v1.1): conv3x3/2, fire modules (a 1x1
    squeeze, then 1x1 and 3x3 expands concatenated by ``MergeVertex``), a
    1x1 conv head, global average pool and a parameter-free softmax."""

    def _fire(self, g, name, inp, squeeze, expand):
        g.add_layer(f"{name}_sq", _conv(squeeze, (1, 1)), inp)
        g.add_layer(f"{name}_e1", _conv(expand, (1, 1)), f"{name}_sq")
        g.add_layer(f"{name}_e3", _conv(expand, (3, 3)), f"{name}_sq")
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_cat"

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.RELU)
        g.add_layer("conv1", _conv(64, (3, 3), (2, 2)), "input")
        g.add_layer("pool1", _maxpool((3, 3), (2, 2)), "conv1")
        x = self._fire(g, "fire2", "pool1", 16, 64)
        x = self._fire(g, "fire3", x, 16, 64)
        g.add_layer("pool3", _maxpool((3, 3), (2, 2)), x)
        x = self._fire(g, "fire4", "pool3", 32, 128)
        x = self._fire(g, "fire5", x, 32, 128)
        g.add_layer("pool5", _maxpool((3, 3), (2, 2)), x)
        x = self._fire(g, "fire6", "pool5", 48, 192)
        x = self._fire(g, "fire7", x, 48, 192)
        x = self._fire(g, "fire8", x, 64, 256)
        x = self._fire(g, "fire9", x, 64, 256)
        g.add_layer("conv10", _conv(self.num_classes, (1, 1)), x)
        g.add_layer("avgpool",
                    GlobalPoolingLayer(pooling_type=PoolingType.AVG), "conv10")
        # the pool already yields num_classes features: a LossLayer head
        g.add_layer("output", LossLayer(
            activation=Activation.SOFTMAX, loss_fn=LossMCXENT()), "avgpool")
        g.set_outputs("output")
        return g.build()


class Darknet19(_ImageClassifier):
    """Reference ``Darknet19`` (the YOLO9000 backbone): 18 convs
    alternating 3x3 and 1x1, each with no bias and an identity activation
    before a LeakyReLU batch norm, 5 max-pools, a 1x1 conv head, global
    average pool and a parameter-free softmax."""

    def _conv_bn_leaky(self, g, i, n_out, k, inp):
        name = f"conv{i}"
        g.add_layer(name, _conv(n_out, k, (1, 1), Activation.IDENTITY,
                                bias=False), inp)
        g.add_layer(f"{name}_bn",
                    BatchNormalization(activation=Activation.LEAKYRELU), name)
        return f"{name}_bn"

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.RELU)
        spec = [(32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M",
                (256, 3), (128, 1), (256, 3), "M",
                (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
                (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)]
        x, ci, pi = "input", 0, 0
        for s in spec:
            if s == "M":
                pi += 1
                g.add_layer(f"pool{pi}", _maxpool(), x)
                x = f"pool{pi}"
            else:
                ci += 1
                n_out, k = s
                x = self._conv_bn_leaky(g, ci, n_out, (k, k), x)
        g.add_layer("head", _conv(self.num_classes, (1, 1),
                                  act=Activation.IDENTITY), x)
        g.add_layer("avgpool",
                    GlobalPoolingLayer(pooling_type=PoolingType.AVG), "head")
        g.add_layer("output", LossLayer(
            activation=Activation.SOFTMAX, loss_fn=LossMCXENT()), "avgpool")
        g.set_outputs("output")
        return g.build()


class UNet(GraphZooModel):
    """Reference ``UNet``: a 4-down / 4-up encoder-decoder, skips joined by
    ``MergeVertex``, nearest-neighbour ``Upsampling2D`` and a 2x2 conv on
    the way up, a sigmoid ``CnnLossLayer`` head (binary segmentation; the
    output is the input's resolution with one channel)."""

    def __init__(self, height: int = 128, width: int = 128, channels: int = 1,
                 base: int = 64, seed: int = 123,
                 updater: IUpdater | None = None):
        self.height, self.width, self.channels = height, width, channels
        self.base = base
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-4)

    def _double_conv(self, g, name, n_out, inp):
        g.add_layer(f"{name}_1", _conv(n_out, (3, 3)), inp)
        g.add_layer(f"{name}_2", _conv(n_out, (3, 3)), f"{name}_1")
        return f"{name}_2"

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.RELU)
        b = self.base
        skips = []
        x = "input"
        for i, ch in enumerate([b, b * 2, b * 4, b * 8]):
            x = self._double_conv(g, f"down{i + 1}", ch, x)
            skips.append(x)
            g.add_layer(f"dpool{i + 1}", _maxpool(), x)
            x = f"dpool{i + 1}"
        x = self._double_conv(g, "bottom", b * 16, x)
        for i, ch in enumerate([b * 8, b * 4, b * 2, b]):
            g.add_layer(f"up{i + 1}_us", Upsampling2D(size=(2, 2)), x)
            g.add_layer(f"up{i + 1}_conv", _conv(ch, (2, 2)), f"up{i + 1}_us")
            g.add_vertex(f"up{i + 1}_cat", MergeVertex(),
                         skips[3 - i], f"up{i + 1}_conv")
            x = self._double_conv(g, f"up{i + 1}", ch, f"up{i + 1}_cat")
        g.add_layer("head", _conv(1, (1, 1), act=Activation.IDENTITY), x)
        g.add_layer("output", CnnLossLayer(activation=Activation.SIGMOID,
                                           loss_fn=LossBinaryXENT()), "head")
        g.set_outputs("output")
        return g.build()


class Xception(_ImageClassifier):
    """Reference ``org.deeplearning4j.zoo.model.Xception``: the entry flow
    (conv32/2, conv64, separable-conv residual blocks 128 / 256 / 728 with
    1x1/2 projections), the middle flow (``middle_flow_repeats`` x three
    separable-conv-728 residual blocks), the exit flow (728 -> 1024
    residual, separable 1536 and 2048), global average pool, softmax."""

    def __init__(self, num_classes: int = 1000, height: int = 299,
                 width: int = 299, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None,
                 middle_flow_repeats: int = 8):
        super().__init__(num_classes, height, width, channels, seed,
                         updater or Nesterovs(learning_rate=1e-2,
                                              momentum=0.9))
        self.middle_flow_repeats = middle_flow_repeats

    def conf(self) -> ComputationGraphConfiguration:
        def sep(n):
            return SeparableConvolution2D(
                n_out=n, kernel_size=(3, 3), stride=(1, 1),
                activation=Activation.IDENTITY,
                convolution_mode=ConvolutionMode.SAME)

        g = _builder(self, WeightInit.XAVIER)
        g.add_layer("c1", _conv(32, (3, 3), (2, 2),
                                mode=ConvolutionMode.TRUNCATE,
                                act=Activation.IDENTITY), "input")
        g.add_layer("c1bn", BatchNormalization(activation=Activation.RELU),
                    "c1")
        g.add_layer("c2", _conv(64, (3, 3), act=Activation.IDENTITY), "c1bn")
        g.add_layer("c2bn", BatchNormalization(activation=Activation.RELU),
                    "c2")
        prev = "c2bn"
        for i, ch in enumerate((128, 256, 728)):  # entry-flow blocks
            rname = f"e{i}_res"
            g.add_layer(rname, _conv(ch, (1, 1), (2, 2),
                                     act=Activation.IDENTITY,
                                     mode=ConvolutionMode.SAME), prev)
            g.add_layer(f"e{i}_s1", sep(ch), prev)
            g.add_layer(f"e{i}_b1",
                        BatchNormalization(activation=Activation.RELU),
                        f"e{i}_s1")
            g.add_layer(f"e{i}_s2", sep(ch), f"e{i}_b1")
            g.add_layer(f"e{i}_b2", BatchNormalization(), f"e{i}_s2")
            g.add_layer(f"e{i}_pool", _maxpool((3, 3), (2, 2),
                                               ConvolutionMode.SAME),
                        f"e{i}_b2")
            g.add_vertex(f"e{i}_add",
                         ElementWiseVertex(op=ElementWiseOp.ADD),
                         f"e{i}_pool", rname)
            prev = f"e{i}_add"
        for r in range(self.middle_flow_repeats):
            inp = prev
            last = inp
            for j in range(3):
                g.add_layer(f"m{r}_a{j}",
                            ActivationLayer(activation=Activation.RELU),
                            last)
                g.add_layer(f"m{r}_s{j}", sep(728), f"m{r}_a{j}")
                g.add_layer(f"m{r}_b{j}", BatchNormalization(),
                            f"m{r}_s{j}")
                last = f"m{r}_b{j}"
            g.add_vertex(f"m{r}_add",
                         ElementWiseVertex(op=ElementWiseOp.ADD),
                         last, inp)
            prev = f"m{r}_add"
        g.add_layer("x_res", _conv(1024, (1, 1), (2, 2),
                                   act=Activation.IDENTITY,
                                   mode=ConvolutionMode.SAME), prev)
        g.add_layer("x_s1", sep(728), prev)
        g.add_layer("x_b1", BatchNormalization(activation=Activation.RELU),
                    "x_s1")
        g.add_layer("x_s2", sep(1024), "x_b1")
        g.add_layer("x_b2", BatchNormalization(), "x_s2")
        g.add_layer("x_pool", _maxpool((3, 3), (2, 2), ConvolutionMode.SAME),
                    "x_b2")
        g.add_vertex("x_add", ElementWiseVertex(op=ElementWiseOp.ADD),
                     "x_pool", "x_res")
        g.add_layer("x_s3", sep(1536), "x_add")
        g.add_layer("x_b3", BatchNormalization(activation=Activation.RELU),
                    "x_s3")
        g.add_layer("x_s4", sep(2048), "x_b3")
        g.add_layer("x_b4", BatchNormalization(activation=Activation.RELU),
                    "x_s4")
        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                    "x_b4")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation=Activation.SOFTMAX,
                                          loss_fn=LossMCXENT()), "gap")
        g.set_outputs("output")
        return g.build()


class InceptionResNetV1(_ImageClassifier):
    """Reference ``org.deeplearning4j.zoo.model.InceptionResNetV1`` (the
    FaceNet variant): stem, ``blocks_a`` x Inception-ResNet-A (scale
    0.17), reduction-A (896 channels), ``blocks_b`` x Inception-ResNet-B
    (0.10), reduction-B (1792), ``blocks_c`` x Inception-ResNet-C (0.20),
    average pool, a linear embedding and the softmax head. Each residual
    branch is scaled by ``ScaleVertex`` and added by
    ``ElementWiseVertex(Add)``."""

    def __init__(self, num_classes: int = 1001, height: int = 160,
                 width: int = 160, channels: int = 3,
                 embedding_size: int = 128, seed: int = 123,
                 updater: IUpdater | None = None,
                 blocks_a: int = 5, blocks_b: int = 10, blocks_c: int = 5):
        super().__init__(num_classes, height, width, channels, seed,
                         updater or Adam(learning_rate=0.1))
        self.embedding_size = embedding_size
        self.blocks_a, self.blocks_b, self.blocks_c = (blocks_a, blocks_b,
                                                       blocks_c)

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.XAVIER)

        def cbr(name, n, k, s, inp, mode=ConvolutionMode.SAME):
            g.add_layer(name, _conv(n, k, s, act=Activation.IDENTITY,
                                    mode=mode), inp)
            g.add_layer(name + "_bn",
                        BatchNormalization(activation=Activation.RELU), name)
            return name + "_bn"

        def residual(tag, i, branches, width, scale, inp):
            g.add_vertex(f"{tag}{i}_cat", MergeVertex(), *branches)
            g.add_layer(f"{tag}{i}_up", _conv(width, (1, 1),
                                              act=Activation.IDENTITY),
                        f"{tag}{i}_cat")
            g.add_vertex(f"{tag}{i}_scale", ScaleVertex(scale_factor=scale),
                         f"{tag}{i}_up")
            g.add_vertex(f"{tag}{i}_add",
                         ElementWiseVertex(op=ElementWiseOp.ADD),
                         inp, f"{tag}{i}_scale")
            g.add_layer(f"{tag}{i}_relu",
                        ActivationLayer(activation=Activation.RELU),
                        f"{tag}{i}_add")
            return f"{tag}{i}_relu"

        p = cbr("s1", 32, (3, 3), (2, 2), "input", ConvolutionMode.TRUNCATE)
        p = cbr("s2", 32, (3, 3), (1, 1), p)
        p = cbr("s3", 64, (3, 3), (1, 1), p)
        g.add_layer("s4", _maxpool((3, 3), (2, 2)), p)
        p = cbr("s5", 80, (1, 1), (1, 1), "s4")
        p = cbr("s6", 192, (3, 3), (1, 1), p)
        p = cbr("s7", 256, (3, 3), (2, 2), p, ConvolutionMode.SAME)

        for i in range(self.blocks_a):
            b1 = cbr(f"a{i}_b1", 32, (1, 1), (1, 1), p)
            b2 = cbr(f"a{i}_b2b", 32, (3, 3), (1, 1),
                     cbr(f"a{i}_b2a", 32, (1, 1), (1, 1), p))
            b3 = cbr(f"a{i}_b3c", 32, (3, 3), (1, 1),
                     cbr(f"a{i}_b3b", 32, (3, 3), (1, 1),
                         cbr(f"a{i}_b3a", 32, (1, 1), (1, 1), p)))
            p = residual("a", i, (b1, b2, b3), 256, 0.17, p)

        # reduction-A -> 256 + 384 + 256 = 896 channels
        g.add_layer("ra_pool", _maxpool((3, 3), (2, 2),
                                        ConvolutionMode.SAME), p)
        ra1 = cbr("ra_c1", 384, (3, 3), (2, 2), p, ConvolutionMode.SAME)
        ra2 = cbr("ra_c2c", 256, (3, 3), (2, 2),
                  cbr("ra_c2b", 192, (3, 3), (1, 1),
                      cbr("ra_c2a", 192, (1, 1), (1, 1), p)),
                  ConvolutionMode.SAME)
        g.add_vertex("ra_cat", MergeVertex(), "ra_pool", ra1, ra2)
        p = "ra_cat"

        for i in range(self.blocks_b):
            b1 = cbr(f"b{i}_b1", 128, (1, 1), (1, 1), p)
            b2 = cbr(f"b{i}_b2c", 128, (7, 1), (1, 1),
                     cbr(f"b{i}_b2b", 128, (1, 7), (1, 1),
                         cbr(f"b{i}_b2a", 128, (1, 1), (1, 1), p)))
            p = residual("b", i, (b1, b2), 896, 0.10, p)

        # reduction-B -> 896 + 384 + 256 + 256 = 1792 channels
        g.add_layer("rb_pool", _maxpool((3, 3), (2, 2),
                                        ConvolutionMode.SAME), p)
        rb1 = cbr("rb_c1b", 384, (3, 3), (2, 2),
                  cbr("rb_c1a", 256, (1, 1), (1, 1), p),
                  ConvolutionMode.SAME)
        rb2 = cbr("rb_c2b", 256, (3, 3), (2, 2),
                  cbr("rb_c2a", 256, (1, 1), (1, 1), p),
                  ConvolutionMode.SAME)
        rb3 = cbr("rb_c3c", 256, (3, 3), (2, 2),
                  cbr("rb_c3b", 256, (3, 3), (1, 1),
                      cbr("rb_c3a", 256, (1, 1), (1, 1), p)),
                  ConvolutionMode.SAME)
        g.add_vertex("rb_cat", MergeVertex(), "rb_pool", rb1, rb2, rb3)
        p = "rb_cat"

        for i in range(self.blocks_c):
            b1 = cbr(f"c{i}_b1", 192, (1, 1), (1, 1), p)
            b2 = cbr(f"c{i}_b2c", 192, (3, 1), (1, 1),
                     cbr(f"c{i}_b2b", 192, (1, 3), (1, 1),
                         cbr(f"c{i}_b2a", 192, (1, 1), (1, 1), p)))
            p = residual("c", i, (b1, b2), 1792, 0.20, p)

        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                    p)
        g.add_layer("embedding", DenseLayer(
            n_out=self.embedding_size, activation=Activation.IDENTITY), "gap")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation=Activation.SOFTMAX,
                                          loss_fn=LossMCXENT()), "embedding")
        g.set_outputs("output")
        return g.build()


class _Yolo(GraphZooModel):
    """The constructor the YOLO detectors share (the JAX package's
    arguments; ``boxes`` defaults to the class's ``PRIORS``)."""

    PRIORS: Tuple[Tuple[float, float], ...] = ()

    def __init__(self, num_classes: int = 20, height: int = 416,
                 width: int = 416, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None,
                 boxes: Tuple[Tuple[float, float], ...] | None = None):
        self.num_classes = num_classes
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.boxes = boxes or self.PRIORS

    def _cbl(self, g, name, n, k, inp):
        """conv (no bias, identity) + LeakyReLU batch norm."""
        g.add_layer(name, _conv(n, k, act=Activation.IDENTITY, bias=False),
                    inp)
        g.add_layer(name + "_bn", BatchNormalization(
            activation=Activation.LEAKYRELU), name)
        return name + "_bn"

    def _head(self, g, inp):
        nb = len(self.boxes)
        g.add_layer("detect", _conv(nb * (5 + self.num_classes), (1, 1),
                                    act=Activation.IDENTITY), inp)
        g.add_layer("yolo", Yolo2OutputLayer(boxes=tuple(self.boxes)),
                    "detect")
        g.set_outputs("yolo")
        return g.build()


class TinyYOLO(_Yolo):
    """Reference ``org.deeplearning4j.zoo.model.TinyYOLO``: the Darknet-tiny
    backbone (conv3x3 16 to 1024 with LeakyReLU batch norms and
    max-pools), a 1x1 detection conv and ``Yolo2OutputLayer``; 416x416
    in, a 13x13 grid, 5 anchor priors."""

    PRIORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
              (16.62, 10.52))

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.XAVIER)
        p = self._cbl(g, "c1", 16, (3, 3), "input")
        for i, n in enumerate((32, 64, 128, 256, 512)):
            g.add_layer(f"p{i + 1}", _maxpool((2, 2), (2, 2)), p)
            p = self._cbl(g, f"c{i + 2}", n, (3, 3), f"p{i + 1}")
        # the last pool is stride-1 SAME (keeps 13x13)
        g.add_layer("p6", _maxpool((2, 2), (1, 1), ConvolutionMode.SAME), p)
        p = self._cbl(g, "c7", 1024, (3, 3), "p6")
        p = self._cbl(g, "c8", 1024, (3, 3), p)
        return self._head(g, p)


class YOLO2(_Yolo):
    """Reference ``org.deeplearning4j.zoo.model.YOLO2``: the Darknet-19
    trunk with the passthrough route (the 26x26x512 map through a 1x1x64
    conv and ``SpaceToDepthLayer(2)``, concatenated with the 13x13x1024
    head before the detection conv); 80 classes."""

    PRIORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
              (7.88282, 3.52778), (9.77052, 9.16828))

    def __init__(self, num_classes: int = 80, height: int = 416,
                 width: int = 416, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None,
                 boxes: Tuple[Tuple[float, float], ...] | None = None):
        super().__init__(num_classes, height, width, channels, seed, updater,
                         boxes)

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.XAVIER)

        def cbl(name, n, k, inp):
            return self._cbl(g, name, n, k, inp)

        p = cbl("c1", 32, (3, 3), "input")
        g.add_layer("p1", _maxpool((2, 2), (2, 2)), p)
        p = cbl("c2", 64, (3, 3), "p1")
        g.add_layer("p2", _maxpool((2, 2), (2, 2)), p)
        p = cbl("c3", 128, (3, 3), "p2")
        p = cbl("c4", 64, (1, 1), p)
        p = cbl("c5", 128, (3, 3), p)
        g.add_layer("p3", _maxpool((2, 2), (2, 2)), p)
        p = cbl("c6", 256, (3, 3), "p3")
        p = cbl("c7", 128, (1, 1), p)
        p = cbl("c8", 256, (3, 3), p)
        g.add_layer("p4", _maxpool((2, 2), (2, 2)), p)
        p = cbl("c9", 512, (3, 3), "p4")
        p = cbl("c10", 256, (1, 1), p)
        p = cbl("c11", 512, (3, 3), p)
        p = cbl("c12", 256, (1, 1), p)
        route = cbl("c13", 512, (3, 3), p)  # the 26x26x512 passthrough
        g.add_layer("p5", _maxpool((2, 2), (2, 2)), route)
        p = cbl("c14", 1024, (3, 3), "p5")
        p = cbl("c15", 512, (1, 1), p)
        p = cbl("c16", 1024, (3, 3), p)
        p = cbl("c17", 512, (1, 1), p)
        p = cbl("c18", 1024, (3, 3), p)
        p = cbl("c19", 1024, (3, 3), p)
        p = cbl("c20", 1024, (3, 3), p)
        # passthrough: 26x26x512 -> 1x1x64 -> space-to-depth -> 13x13x256
        r = cbl("route_conv", 64, (1, 1), route)
        g.add_layer("route_s2d", SpaceToDepthLayer(block_size=2), r)
        g.add_vertex("concat", MergeVertex(), "route_s2d", p)
        p = cbl("c21", 1024, (3, 3), "concat")
        return self._head(g, p)


class NASNet(_ImageClassifier):
    """Reference ``org.deeplearning4j.zoo.model.NASNet`` (the NASNet-A
    mobile schema): a stem conv, three stacks of ``num_cells`` NORMAL
    cells with a REDUCTION cell between stacks (filters doubled), each
    cell the NASNet-A 5-block DAG over (h, h_prev) of separable convs,
    average pools and identities, both inputs squeezed by 1x1 convs
    first, the block outputs concatenated; filters per normal cell
    ``max(penultimate_filters // 24, 8)``."""

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None,
                 penultimate_filters: int = 1056, num_cells: int = 4):
        super().__init__(num_classes, height, width, channels, seed, updater)
        self.filters = max(penultimate_filters // 24, 8)
        self.num_cells = num_cells

    def conf(self) -> ComputationGraphConfiguration:
        g = _builder(self, WeightInit.XAVIER)

        def sep(name, n, k, s, inp):
            g.add_layer(name + "_r",
                        ActivationLayer(activation=Activation.RELU), inp)
            g.add_layer(name, SeparableConvolution2D(
                n_out=n, kernel_size=k, stride=s,
                activation=Activation.IDENTITY,
                convolution_mode=ConvolutionMode.SAME), name + "_r")
            g.add_layer(name + "_bn", BatchNormalization(), name)
            return name + "_bn"

        def squeeze(name, n, s, inp):
            g.add_layer(name, _conv(n, (1, 1), s, act=Activation.IDENTITY,
                                    mode=ConvolutionMode.SAME), inp)
            g.add_layer(name + "_bn", BatchNormalization(), name)
            return name + "_bn"

        def avg3(name, s, inp):
            g.add_layer(name, SubsamplingLayer(
                pooling_type=PoolingType.AVG, kernel_size=(3, 3), stride=s,
                convolution_mode=ConvolutionMode.SAME), inp)
            return name

        def add(name, a, b):
            g.add_vertex(name, ElementWiseVertex(op=ElementWiseOp.ADD), a, b)
            return name

        def normal_cell(cid, h, h_prev, f, prev_stride=(1, 1)):
            # right after a reduction cell h_prev still has the
            # pre-reduction size: its adjust runs at stride 2
            h = squeeze(f"{cid}_adj", f, (1, 1), h)
            hp = squeeze(f"{cid}_adjp", f, prev_stride, h_prev)
            b1 = add(f"{cid}_b1", sep(f"{cid}_b1s", f, (3, 3), (1, 1), h), h)
            b2 = add(f"{cid}_b2",
                     sep(f"{cid}_b2a", f, (3, 3), (1, 1), hp),
                     sep(f"{cid}_b2b", f, (5, 5), (1, 1), h))
            b3 = add(f"{cid}_b3", avg3(f"{cid}_b3p", (1, 1), h), hp)
            b4 = add(f"{cid}_b4", avg3(f"{cid}_b4a", (1, 1), hp),
                     avg3(f"{cid}_b4b", (1, 1), hp))
            b5 = add(f"{cid}_b5",
                     sep(f"{cid}_b5a", f, (5, 5), (1, 1), hp),
                     sep(f"{cid}_b5b", f, (3, 3), (1, 1), hp))
            g.add_vertex(f"{cid}_out", MergeVertex(), b1, b2, b3, b4, b5)
            return f"{cid}_out"

        def reduction_cell(cid, h, h_prev, f):
            h = squeeze(f"{cid}_adj", f, (1, 1), h)
            hp = squeeze(f"{cid}_adjp", f, (1, 1), h_prev)
            b1 = add(f"{cid}_b1",
                     sep(f"{cid}_b1a", f, (5, 5), (2, 2), hp),
                     sep(f"{cid}_b1b", f, (7, 7), (2, 2), h))
            g.add_layer(f"{cid}_b2m", _maxpool((3, 3), (2, 2),
                                               ConvolutionMode.SAME), h)
            b2 = add(f"{cid}_b2", f"{cid}_b2m",
                     sep(f"{cid}_b2s", f, (7, 7), (2, 2), hp))
            b3 = add(f"{cid}_b3", avg3(f"{cid}_b3a", (2, 2), h),
                     sep(f"{cid}_b3s", f, (5, 5), (2, 2), hp))
            b4 = add(f"{cid}_b4", avg3(f"{cid}_b4a", (1, 1), b1),
                     f"{cid}_b2m")
            b5 = add(f"{cid}_b5", sep(f"{cid}_b5s", f, (3, 3), (1, 1), b1),
                     avg3(f"{cid}_b5a", (2, 2), h))
            g.add_vertex(f"{cid}_out", MergeVertex(), b2, b3, b4, b5)
            return f"{cid}_out"

        f = self.filters
        g.add_layer("stem", _conv(f, (3, 3), (2, 2),
                                  act=Activation.IDENTITY,
                                  mode=ConvolutionMode.SAME), "input")
        g.add_layer("stem_bn", BatchNormalization(), "stem")
        h_prev, h = "stem_bn", "stem_bn"
        cid = 0
        for stack in range(3):
            for ci in range(self.num_cells):
                stride_prev = (2, 2) if stack > 0 and ci == 0 else (1, 1)
                out = normal_cell(f"n{cid}", h, h_prev, f,
                                  prev_stride=stride_prev)
                h_prev, h = h, out
                cid += 1
            if stack < 2:
                f *= 2
                out = reduction_cell(f"r{stack}", h, h_prev, f)
                h_prev, h = h, out
        g.add_layer("final_relu", ActivationLayer(
            activation=Activation.RELU), h)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type=PoolingType.AVG),
                    "final_relu")
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          activation=Activation.SOFTMAX,
                                          loss_fn=LossMCXENT()), "gap")
        g.set_outputs("output")
        return g.build()


class TransformerEncoder(GraphZooModel):
    """Transformer encoder classifier, or causal language model with
    ``lm_head`` (the JAX package's ``TransformerEncoder``). Learned
    position embeddings, then pre-LN blocks ``x + MHA(LN(x))``,
    ``x + FFN(LN(x))`` with a tanh-GELU FFN, a final LN, and either a
    pooled softmax classifier or a time-distributed ``[batch, time,
    vocab_size]`` softmax head. With ``vocab_size`` the inputs are token
    ids through an embedding; with 0, ``[batch, time, embed_dim]`` floats.

    ``use_kernels`` routes the attention core through the flash kernel
    (``kernels/routing.py``; ``fit`` trains through its backward kernels,
    and a ``features_mask`` is their key mask), and the decoder's prefill
    and decode steps through the flash and paged decode kernels. Both heads
    train through ``fit``: the LM on ``[batch, time, vocab_size]`` one-hot
    next-token labels (a ``[batch, time]`` labels mask averages over the
    valid positions), the classifier on ``[batch, num_classes]`` labels
    (its average pooling is unmasked in a graph, as in the JAX package). Mixture-of-experts blocks
    (``moe_experts > 0``) are not ported yet."""

    def __init__(self, num_classes: int = 2, vocab_size: int = 0,
                 embed_dim: int = 64, n_heads: int = 4, n_layers: int = 2,
                 ffn_dim: int = 0, max_len: int = 128, seed: int = 123,
                 updater: IUpdater | None = None,
                 attention_impl: str = "auto", causal: bool = False,
                 moe_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25,
                 lm_head: bool = False, use_kernels: bool = False):
        if moe_experts > 0:
            raise NotImplementedError(
                "TransformerEncoder(moe_experts > 0): MoE blocks are not "
                "ported yet; they land with the expert-parallel slice")
        self.num_classes = num_classes
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.ffn_dim = ffn_dim or 4 * embed_dim
        self.max_len = max_len
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)
        self.attention_impl = attention_impl
        self.causal = causal
        self.lm_head = lm_head
        self.use_kernels = use_kernels
        if lm_head and not (vocab_size and causal):
            raise ValueError("lm_head=True requires vocab_size > 0 and "
                             "causal=True (a language model decodes token "
                             "ids left to right)")

    def conf(self) -> ComputationGraphConfiguration:
        e = self.embed_dim
        g = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(self.updater)
             .weight_init(WeightInit.XAVIER)
             .use_kernels(self.use_kernels)
             .graph_builder()
             .add_inputs("input")
             .set_input_types(InputType.recurrent(
                 e if not self.vocab_size else 1, timesteps=self.max_len)))
        prev = "input"
        if self.vocab_size:
            g.add_layer("embed", EmbeddingSequenceLayer(
                n_in=self.vocab_size, n_out=e), prev)
            prev = "embed"
        g.add_layer("pos", PositionEmbeddingLayer(max_len=self.max_len),
                    prev)
        prev = "pos"
        for i in range(self.n_layers):
            g.add_layer(f"b{i}_ln1", LayerNormalization(), prev)
            g.add_layer(f"b{i}_attn", SelfAttentionLayer(
                n_out=e, n_heads=self.n_heads, causal=self.causal,
                attention_impl=self.attention_impl), f"b{i}_ln1")
            g.add_vertex(f"b{i}_res1",
                         ElementWiseVertex(op=ElementWiseOp.ADD),
                         prev, f"b{i}_attn")
            g.add_layer(f"b{i}_ln2", LayerNormalization(), f"b{i}_res1")
            g.add_layer(f"b{i}_ff1", DenseLayer(
                n_out=self.ffn_dim, activation=Activation.GELU),
                f"b{i}_ln2")
            g.add_layer(f"b{i}_ff2", DenseLayer(
                n_out=e, activation=Activation.IDENTITY), f"b{i}_ff1")
            g.add_vertex(f"b{i}_res2",
                         ElementWiseVertex(op=ElementWiseOp.ADD),
                         f"b{i}_res1", f"b{i}_ff2")
            prev = f"b{i}_res2"
        g.add_layer("final_ln", LayerNormalization(), prev)
        if self.lm_head:
            # time-distributed vocab logits: every position predicts its
            # next token
            g.add_layer("output", OutputLayer(
                n_out=self.vocab_size, activation=Activation.SOFTMAX,
                loss_fn=LossMCXENT()), "final_ln")
        else:
            g.add_layer("pool", GlobalPoolingLayer(
                pooling_type=PoolingType.AVG), "final_ln")
            g.add_layer("output", OutputLayer(
                n_out=self.num_classes, activation=Activation.SOFTMAX,
                loss_fn=LossMCXENT()), "pool")
        g.set_outputs("output")
        return g.build()

    def decoder(self, net=None, device="cuda", **kw):
        """The KV-cached generation front of this configuration: a
        ``nn.decoding.TransformerDecoder`` over ``net`` (an initialized
        ComputationGraph of this conf; default a fresh ``init`` on
        ``device``). Remaining kwargs go to ``TransformerDecoder``
        (``max_batch``, bucket knobs)."""
        if not self.lm_head:
            raise ValueError(
                "decoder() requires lm_head=True (the classifier head "
                "pools over time and cannot emit next-token logits)")
        from deeplearning4j_tpu_torch.nn.decoding import TransformerDecoder

        return TransformerDecoder(
            net if net is not None else self.init(device=device),
            max_len=self.max_len, **kw)
