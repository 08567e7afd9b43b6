"""Fused operations on the port's kernels (counterpart of the JAX
package's ``deeplearning4j_tpu/ops``)."""
