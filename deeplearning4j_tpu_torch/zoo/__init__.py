"""Model zoo (reference: ``deeplearning4j-zoo``): ``ResNet50``,
``TransformerEncoder``, ``LeNet``, ``SimpleCNN``, ``AlexNet`` and
``TextGenerationLSTM``."""

from deeplearning4j_tpu_torch.zoo.graphs import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import ZooModel  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import AlexNet  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import LeNet  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import SimpleCNN  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM  # noqa: F401
