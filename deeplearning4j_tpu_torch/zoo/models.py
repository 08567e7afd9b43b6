"""Model zoo: the SPI and the sequential (MultiLayerNetwork) models.

Reference: ``org.deeplearning4j.zoo.ZooModel``: ``conf()`` builds the
configuration and ``init()`` the network. Pretrained-weight loading lands
with a later slice.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.inputs import InputType
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    ConvolutionLayer,
    ConvolutionMode,
    LocalResponseNormalization,
    PoolingType,
    SubsamplingLayer,
)
from deeplearning4j_tpu_torch.conf.losses import LossMCXENT
from deeplearning4j_tpu_torch.conf.multilayer import (
    MultiLayerConfiguration,
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.conf.updaters import IUpdater, Nesterovs
from deeplearning4j_tpu_torch.conf.weights import WeightInit


class ZooModel:
    """SPI base (reference ``org.deeplearning4j.zoo.ZooModel``)."""

    def init(self, device="cuda"):
        """Build the network with freshly initialized weights on ``device``."""
        raise NotImplementedError

    def conf(self):
        raise NotImplementedError


class AlexNet(ZooModel):
    """Reference ``org.deeplearning4j.zoo.model.AlexNet``: conv11x11/4(96)
    -> LRN -> maxpool3/2 -> conv5x5(256) -> LRN -> maxpool -> conv3x3(384)
    x2 -> conv3x3(256) -> maxpool -> FC 4096 x2 (dropout 0.5) -> softmax.
    The layer list is the JAX package's, so ``set_input_type`` puts the
    flatten at index 10 and the two 4096-wide dense layers at 11 and 12."""

    def __init__(self, num_classes: int = 1000, height: int = 224,
                 width: int = 224, channels: int = 3, seed: int = 123,
                 updater: IUpdater | None = None):
        self.num_classes = num_classes
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed
        self.updater = updater or Nesterovs(learning_rate=1e-2, momentum=0.9)

    def conf(self) -> MultiLayerConfiguration:
        def conv(n, k, s=(1, 1)):
            return ConvolutionLayer(n_out=n, kernel_size=k, stride=s,
                                    activation=Activation.RELU,
                                    convolution_mode=ConvolutionMode.SAME)

        def pool():
            return SubsamplingLayer(
                pooling_type=PoolingType.MAX, kernel_size=(3, 3),
                stride=(2, 2), convolution_mode=ConvolutionMode.TRUNCATE)

        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init(WeightInit.NORMAL)
                .list()
                .layer(ConvolutionLayer(
                    n_out=96, kernel_size=(11, 11), stride=(4, 4),
                    activation=Activation.RELU,
                    convolution_mode=ConvolutionMode.TRUNCATE))
                .layer(LocalResponseNormalization())
                .layer(pool())
                .layer(conv(256, (5, 5)))
                .layer(LocalResponseNormalization())
                .layer(pool())
                .layer(conv(384, (3, 3)))
                .layer(conv(384, (3, 3)))
                .layer(conv(256, (3, 3)))
                .layer(pool())
                .layer(DenseLayer(n_out=4096, activation=Activation.RELU,
                                  dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation=Activation.RELU,
                                  dropout=0.5))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation=Activation.SOFTMAX,
                                   loss_fn=LossMCXENT()))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())

    def init(self, device="cuda"):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork(self.conf(), device).init()
