"""Parallelism: serving (the dynamic-batching ``InferenceEngine``, the HTTP
``InferenceServer``, the ``GenerationEngine``, in their own modules; the
multi-tenant ``ModelPlatform`` with its ``ModelRegistry``, and
``ParallelInference``, exported here) and data-parallel training on
``torch.distributed`` (reference ``deeplearning4j-scaleout``): the
process-group mesh, ``ParallelWrapper`` and its exchange modes, compressed
gradient exchange, the cluster masters, and ``spawn`` for ranks started
from Python."""

from deeplearning4j_tpu_torch.parallel.compression import (  # noqa: F401
    AdaptiveThresholdAlgorithm,
    ThresholdAlgorithm,
    bitmap_encode,
    bucketed_all_gather,
    bucketed_psum,
    bucketed_psum_scatter,
    encode_tree,
    threshold_decode,
    threshold_encode,
)
from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPELINE_AXIS,
    SEQUENCE_AXIS,
    Mesh,
    MeshConfig,
    device_count,
    host_gather,
    initialize_distributed,
    pad_leading,
    replicate,
    shard_batch,
    shard_valid_counts,
    single_host_mesh,
)
from deeplearning4j_tpu_torch.parallel.wrapper import (  # noqa: F401
    ParallelWrapper,
    TrainingMode,
)
from deeplearning4j_tpu_torch.parallel.cluster import (  # noqa: F401
    ParameterAveragingTrainingMaster,
    SharedTrainingMaster,
    SparkComputationGraph,
    SparkDl4jMultiLayer,
    TrainingMaster,
    global_batch,
)
from deeplearning4j_tpu_torch.parallel.launch import (  # noqa: F401
    RankFailure,
    spawn,
)
from deeplearning4j_tpu_torch.parallel.inference import (  # noqa: F401
    ParallelInference,
)
from deeplearning4j_tpu_torch.parallel.platform import (  # noqa: F401
    CanaryGate,
    HostOverloadedError,
    ModelIntegrityError,
    ModelPlatform,
    ModelRegistry,
    TenantConfig,
    UnknownModelError,
)
