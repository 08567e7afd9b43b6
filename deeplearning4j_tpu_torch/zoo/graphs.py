"""Model zoo — ComputationGraph models.

Reference: ``org.deeplearning4j.zoo.model.ResNet50``; the topologies are the
JAX package's ``zoo/graphs.py::ResNet50`` (the plain 7x7/2 stem; unfused
conv + BN pairs, or ``fused_conv_bn``) and ``TransformerEncoder`` (the
dense-FFN classifier and causal language model), so both packages build
the same configuration JSON.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.conf import Activation, InputType, WeightInit
from deeplearning4j_tpu_torch.conf.graph import (
    ComputationGraphConfiguration,
    ElementWiseOp,
    ElementWiseVertex,
)
from deeplearning4j_tpu_torch.conf.layers import (
    ActivationLayer,
    DenseLayer,
    EmbeddingSequenceLayer,
    OutputLayer,
)
from deeplearning4j_tpu_torch.conf.layers_attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
    ConvolutionLayer,
    ConvolutionMode,
    FusedConvBN1x1,
    GlobalPoolingLayer,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.conf.layers_extra import (
    LayerNormalization,
    PositionEmbeddingLayer,
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


class TransformerEncoder(GraphZooModel):
    """Transformer encoder classifier, or causal language model with
    ``lm_head`` (the JAX package's ``TransformerEncoder``). Learned
    position embeddings, then pre-LN blocks ``x + MHA(LN(x))``,
    ``x + FFN(LN(x))`` with a tanh-GELU FFN, a final LN, and either a
    pooled softmax classifier or a time-distributed ``[batch, time,
    vocab_size]`` softmax head. With ``vocab_size`` the inputs are token
    ids through an embedding; with 0, ``[batch, time, embed_dim]`` floats.

    ``use_kernels`` routes the attention core through the flash kernel
    (``kernels/routing.py``), and the decoder's prefill and decode steps
    through the flash and paged decode kernels. Mixture-of-experts blocks
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
