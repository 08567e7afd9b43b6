"""Evaluation metrics (reference: ``org.nd4j.evaluation``)."""

from deeplearning4j_tpu_torch.eval.evaluation import (  # noqa: F401
    ROC,
    Evaluation,
    EvaluationBinary,
    EvaluationCalibration,
    RegressionEvaluation,
    ROCBinary,
    ROCMultiClass,
)
