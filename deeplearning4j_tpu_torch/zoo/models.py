"""Model zoo: the SPI and the sequential (MultiLayerNetwork) models:
``LeNet``, ``SimpleCNN``, ``AlexNet`` and ``TextGenerationLSTM``, each the
JAX package's configuration.

Reference: ``org.deeplearning4j.zoo.ZooModel``: ``conf()`` builds the
configuration, ``init()`` the network, and ``init_pretrained(type)`` loads
checksum-verified cached weights (``zoo.pretrained``).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.conf.activations import Activation
from deeplearning4j_tpu_torch.conf.inputs import InputType
from deeplearning4j_tpu_torch.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.conf.layers_cnn import (
    BatchNormalization,
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
from deeplearning4j_tpu_torch.conf.updaters import Adam, IUpdater, Nesterovs
from deeplearning4j_tpu_torch.conf.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.pretrained import PretrainedMixin


class ZooModel(PretrainedMixin):
    """SPI base (reference ``org.deeplearning4j.zoo.ZooModel``): ``conf()``
    builds the configuration, ``init()`` the network, and the mixin adds
    ``init_pretrained`` / ``pretrained_available`` / ``pretrained_url`` /
    ``pretrained_checksum``."""

    def init(self, device="cuda"):
        """Build the network with freshly initialized weights on ``device``."""
        raise NotImplementedError

    def conf(self):
        raise NotImplementedError


class LeNet(ZooModel):
    """Reference ``org.deeplearning4j.zoo.model.LeNet`` topology:
    conv5x5(20) SAME -> maxpool2 -> conv5x5(50) SAME -> maxpool2 ->
    dense(500, relu) -> softmax output; 28x28xC input (MNIST by default),
    1,256,080 params at the defaults."""

    def __init__(self, num_classes: int = 10, height: int = 28,
                 width: int = 28, channels: int = 1, seed: int = 123,
                 updater: IUpdater | None = None):
        self.num_classes = num_classes
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)

    def conf(self) -> MultiLayerConfiguration:
        def conv(n):
            return ConvolutionLayer(n_out=n, kernel_size=(5, 5),
                                    stride=(1, 1),
                                    convolution_mode=ConvolutionMode.SAME,
                                    activation=Activation.IDENTITY)

        def pool():
            return SubsamplingLayer(pooling_type=PoolingType.MAX,
                                    kernel_size=(2, 2), stride=(2, 2))

        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init(WeightInit.XAVIER)
                .list()
                .layer(conv(20)).layer(pool())
                .layer(conv(50)).layer(pool())
                .layer(DenseLayer(n_out=500, activation=Activation.RELU))
                .layer(OutputLayer(n_out=self.num_classes,
                                   activation=Activation.SOFTMAX,
                                   loss_fn=LossMCXENT()))
                .set_input_type(InputType.convolutional(
                    self.height, self.width, self.channels))
                .build())

    def init(self, device="cuda"):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork(self.conf(), device).init()


class SimpleCNN(ZooModel):
    """Reference ``org.deeplearning4j.zoo.model.SimpleCNN``: three 3x3 SAME
    convolutions (16, 32, 64), each followed by a relu batch norm, max-pools
    after the second and third, dense(128, relu), softmax; 48x48x3 input,
    ``Nesterovs(0.01, 0.9)``."""

    def __init__(self, num_classes: int = 10, height: int = 48,
                 width: int = 48, channels: int = 3, seed: int = 123):
        self.num_classes = num_classes
        self.height, self.width, self.channels = height, width, channels
        self.seed = seed

    def conf(self) -> MultiLayerConfiguration:
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Nesterovs(learning_rate=0.01, momentum=0.9))
             .weight_init(WeightInit.RELU)
             .list())
        for n_out, pool in [(16, False), (32, True), (64, True)]:
            b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                     convolution_mode=ConvolutionMode.SAME,
                                     activation=Activation.IDENTITY))
            b.layer(BatchNormalization(activation=Activation.RELU))
            if pool:
                b.layer(SubsamplingLayer(pooling_type=PoolingType.MAX,
                                         kernel_size=(2, 2), stride=(2, 2)))
        b.layer(DenseLayer(n_out=128, activation=Activation.RELU))
        b.layer(OutputLayer(n_out=self.num_classes,
                            activation=Activation.SOFTMAX,
                            loss_fn=LossMCXENT()))
        b.set_input_type(InputType.convolutional(self.height, self.width,
                                                 self.channels))
        return b.build()

    def init(self, device="cuda"):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork(self.conf(), device).init()


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


class TextGenerationLSTM(ZooModel):
    """Reference ``org.deeplearning4j.zoo.model.TextGenerationLSTM``:
    LSTM(256) x 2 and a softmax ``RnnOutputLayer`` (MCXENT) over a
    character vocabulary, trained on one-hot sequences (with truncated
    BPTT: ``conf()`` is the zoo's layers, the caller sets the backprop
    type) and sampled with ``rnn_time_step``. 47 characters and
    ``max_length`` 40 by default, Adam(1e-3), XAVIER."""

    def __init__(self, total_unique_characters: int = 47,
                 max_length: int = 40, layer_size: int = 256,
                 seed: int = 123, updater: IUpdater | None = None):
        self.vocab = total_unique_characters
        self.max_length = max_length
        self.layer_size = layer_size
        self.seed = seed
        self.updater = updater or Adam(learning_rate=1e-3)

    def conf(self) -> MultiLayerConfiguration:
        from deeplearning4j_tpu_torch.conf.layers_rnn import (
            LSTM,
            RnnOutputLayer,
        )

        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init(WeightInit.XAVIER)
                .list()
                .layer(LSTM(n_out=self.layer_size,
                            activation=Activation.TANH))
                .layer(LSTM(n_out=self.layer_size,
                            activation=Activation.TANH))
                .layer(RnnOutputLayer(n_out=self.vocab,
                                      activation=Activation.SOFTMAX,
                                      loss_fn=LossMCXENT()))
                .set_input_type(InputType.recurrent(
                    self.vocab, timesteps=self.max_length))
                .build())

    def init(self, device="cuda"):
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        return MultiLayerNetwork(self.conf(), device).init()
