"""deeplearning4j_tpu_torch — the PyTorch / CUDA port of deeplearning4j_tpu.

A second build of the JAX package ``deeplearning4j_tpu`` for an NVIDIA
Hopper card (H100, ``sm_90a``). The JAX package is the reference: module
paths and class names mirror it, configuration JSON round-trips between the
two, and every Pallas kernel the JAX package wrote for the TPU becomes a
kernel written by hand for Hopper under ``csrc/``.

Entry points run on ``device="cuda"`` unless the caller asks for the CPU, as
the tests do. On a CPU tensor every kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel or raises.

Package map (the serving slice):

- ``conf``      — config DSL: layers, vertices, builder, configs
- ``nn``        — ``ComputationGraph`` (eval-mode forward)
- ``kernels``   — the hand-written CUDA kernels, their build and routing
- ``parallel``  — dynamic-batching ``InferenceEngine`` + ``InferenceServer``
- ``zoo``       — ``ResNet50``
- ``util``      — weight conversion from the JAX package
"""

__version__ = "0.1.0"
