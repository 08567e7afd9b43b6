"""Fused operations on the port's kernels (counterpart of the JAX
package's ``deeplearning4j_tpu/ops``), and ring attention over a mesh's
``sequence`` ranks (``ops.ring``)."""

from deeplearning4j_tpu_torch.ops.ring import (  # noqa: F401
    ring_attention,
    ring_attention_local,
)
