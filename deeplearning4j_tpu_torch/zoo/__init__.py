"""Model zoo (reference: ``deeplearning4j-zoo``): ``ResNet50``,
``TransformerEncoder`` and ``AlexNet``."""

from deeplearning4j_tpu_torch.zoo.graphs import ResNet50  # noqa: F401
from deeplearning4j_tpu_torch.zoo.graphs import TransformerEncoder  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import ZooModel  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import AlexNet  # noqa: F401
