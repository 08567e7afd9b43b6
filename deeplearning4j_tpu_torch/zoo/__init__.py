"""Model zoo (reference: ``deeplearning4j-zoo``): the graph models
``VGG16``, ``VGG19``, ``ResNet50``, ``SqueezeNet``, ``Darknet19``,
``UNet``, ``Xception``, ``InceptionResNetV1``, ``TinyYOLO``, ``YOLO2``,
``NASNet`` and ``TransformerEncoder``; the sequential ``LeNet``,
``SimpleCNN``, ``AlexNet`` and ``TextGenerationLSTM``; their pretrained
weights through ``zoo.pretrained``."""

from deeplearning4j_tpu_torch.zoo.graphs import (  # noqa: F401
    VGG16,
    VGG19,
    Darknet19,
    InceptionResNetV1,
    NASNet,
    ResNet50,
    SqueezeNet,
    TinyYOLO,
    TransformerEncoder,
    UNet,
    Xception,
    YOLO2,
)
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    AlexNet,
    LeNet,
    SimpleCNN,
    TextGenerationLSTM,
    ZooModel,
)
from deeplearning4j_tpu_torch.zoo.pretrained import (  # noqa: F401
    PretrainedType,
    load_pretrained,
    restore_partial,
    save_pretrained,
)
