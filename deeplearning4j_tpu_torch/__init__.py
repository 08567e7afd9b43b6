"""deeplearning4j_tpu_torch — the PyTorch / CUDA port of deeplearning4j_tpu.

A second build of the JAX package ``deeplearning4j_tpu`` for an NVIDIA
Hopper card (H100, ``sm_90a``). The JAX package is the reference: module
paths and class names mirror it, configuration JSON round-trips between the
two, and every Pallas kernel the JAX package wrote for the TPU becomes a
kernel written by hand for Hopper under ``csrc/``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU, as
the tests do. On a CPU tensor every kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.

Package map (the serving and training slices):

- ``conf``      — config DSL: layers, vertices, builder, losses, updaters,
                  schedules, regularization
- ``nn``        — ``ComputationGraph`` and ``MultiLayerNetwork`` (inference
                  and ``fit``), inference optimization, int8 quantization
- ``optimize``  — the solver step, training listeners, checkpoints, the
                  serving envelope cache and warmup budgets
- ``datasets``  — ``DataSet`` / ``MultiDataSet``, iterators, the synthetic
                  MNIST set, normalizers
- ``eval``      — ``Evaluation`` and the other evaluation accumulators
- ``ops``       — fused 1x1 conv + BN statistics, attention
- ``kernels``   — the hand-written CUDA kernels, their build and routing
- ``parallel``  — dynamic-batching ``InferenceEngine``, ``InferenceServer``
                  and the ``GenerationEngine``; the multi-tenant
                  ``ModelPlatform`` and ``ModelRegistry``,
                  ``ParallelInference``; data-parallel training
                  (``ParallelWrapper``, ``TrainingMode``, the mesh,
                  compression, the cluster masters, ``spawn``)
- ``resilience`` — circuit breaker, retry policies, fault injection
- ``telemetry`` — metrics registry, request traces, spans, SLO monitors
- ``analysis``  — the findings log
- ``comms``     — the collective scheduler and exact mode's global batch
- ``sharding``  — ``ZeroSpec``, the ZeRO optimizer-state layout
- ``zoo``       — ``ResNet50``, ``TransformerEncoder``, ``LeNet``,
                  ``SimpleCNN``, ``AlexNet``
- ``util``      — conversion from and to the JAX package's layouts, the
                  flat params vector and the ModelSerializer zip
"""

__version__ = "0.1.0"
