"""Serving (reference: ``deeplearning4j-scaleout`` parallelism.inference):
the dynamic-batching ``InferenceEngine`` and the HTTP ``InferenceServer``."""
