"""Evaluation metrics.

Reference: ``org.nd4j.evaluation.classification.Evaluation`` (accuracy /
precision / recall / F1 / confusion matrix / per-class stats),
``EvaluationBinary``, ``ROC`` (AUC/AUPRC), and
``org.nd4j.evaluation.regression.RegressionEvaluation`` (MSE/MAE/RMSE/R^2).

Accumulator objects: ``eval(labels, predictions, mask)`` may be called per
batch (device arrays come back to host once per batch — the confusion
accumulation itself is a tiny host-side op, matching the reference's design
where Evaluation runs on the JVM side). Copied from the JAX package's
``eval/evaluation.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class Evaluation:
    """Multi-class classification evaluation via confusion matrix."""

    def __init__(self, num_classes: int | None = None,
                 labels_names: list[str] | None = None):
        self.num_classes = num_classes
        self.labels_names = labels_names
        self.confusion: np.ndarray | None = None

    def _ensure(self, n: int):
        if self.confusion is None:
            self.num_classes = self.num_classes or n
            self.confusion = np.zeros((self.num_classes, self.num_classes),
                                      np.int64)

    def eval(self, labels, predictions, mask=None):
        """labels/predictions: [batch, n_classes] probabilities/one-hot, or
        [batch, n_classes, ...time] — time dims flattened; int class vectors
        also accepted."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if labels.ndim >= 3:  # [batch, time, classes] -> [batch*time, classes]
            labels = labels.reshape(-1, labels.shape[-1])
            predictions = predictions.reshape(-1, predictions.shape[-1])
        if labels.ndim == 2:
            true_idx = labels.argmax(-1)
        else:
            true_idx = labels.astype(np.int64)
        if predictions.ndim == 2:
            pred_idx = predictions.argmax(-1)
            n = predictions.shape[-1]
        else:
            pred_idx = predictions.astype(np.int64)
            n = int(max(true_idx.max(), pred_idx.max())) + 1
        self._ensure(n)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            true_idx, pred_idx = true_idx[m], pred_idx[m]
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        return self

    # --- aggregate metrics -------------------------------------------------
    def _counts(self):
        c = self.confusion
        tp = np.diag(c).astype(np.float64)
        fp = c.sum(0) - tp
        fn = c.sum(1) - tp
        return tp, fp, fn

    def accuracy(self) -> float:
        c = self.confusion
        total = c.sum()
        return float(np.diag(c).sum() / total) if total else 0.0

    def precision(self, cls: int | None = None) -> float:
        tp, fp, _ = self._counts()
        if cls is not None:
            d = tp[cls] + fp[cls]
            return float(tp[cls] / d) if d else 0.0
        # macro-average over classes that appear (reference default)
        d = tp + fp
        valid = (tp + self.confusion.sum(1)) > 0
        vals = np.where(d > 0, tp / np.maximum(d, 1), 0.0)
        return float(vals[valid].mean()) if valid.any() else 0.0

    def recall(self, cls: int | None = None) -> float:
        tp, _, fn = self._counts()
        if cls is not None:
            d = tp[cls] + fn[cls]
            return float(tp[cls] / d) if d else 0.0
        d = tp + fn
        valid = d > 0
        vals = np.where(valid, tp / np.maximum(d, 1), 0.0)
        return float(vals[valid].mean()) if valid.any() else 0.0

    def f1(self, cls: int | None = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 2 * p * r / (p + r) if (p + r) else 0.0

    def false_positive_rate(self, cls: int) -> float:
        tp, fp, fn = self._counts()
        tn = self.confusion.sum() - tp[cls] - fp[cls] - fn[cls]
        d = fp[cls] + tn
        return float(fp[cls] / d) if d else 0.0

    def stats(self) -> str:
        """Printable summary (reference: ``Evaluation#stats``)."""
        n = self.num_classes or 0
        names = self.labels_names or [str(i) for i in range(n)]
        lines = [
            "========================Evaluation Metrics========================",
            f" # of classes:    {n}",
            f" Accuracy:        {self.accuracy():.4f}",
            f" Precision:       {self.precision():.4f}",
            f" Recall:          {self.recall():.4f}",
            f" F1 Score:        {self.f1():.4f}",
            "",
            "=========================Confusion Matrix=========================",
        ]
        header = "     " + " ".join(f"{nm:>5}" for nm in names)
        lines.append(header)
        for i in range(n):
            row = " ".join(f"{self.confusion[i, j]:>5}" for j in range(n))
            lines.append(f"{names[i]:>4} {row}")
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> "Evaluation":
        if other.confusion is not None:
            self._ensure(other.num_classes)
            self.confusion += other.confusion
        return self


class EvaluationBinary:
    """Per-output binary evaluation (reference ``EvaluationBinary``):
    each output column is an independent binary problem at threshold 0.5."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        preds = (np.asarray(predictions).reshape(labels.shape) >= self.threshold)
        labs = labels >= 0.5
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labs, preds = labs[m], preds[m]
        tp = (labs & preds).sum(0)
        fp = (~labs & preds).sum(0)
        fn = (labs & ~preds).sum(0)
        tn = (~labs & ~preds).sum(0)
        if self.tp is None:
            self.tp, self.fp, self.fn, self.tn = tp, fp, fn, tn
        else:
            self.tp += tp; self.fp += fp; self.fn += fn; self.tn += tn
        return self

    def accuracy(self, i: int) -> float:
        total = self.tp[i] + self.fp[i] + self.fn[i] + self.tn[i]
        return float((self.tp[i] + self.tn[i]) / total) if total else 0.0

    def precision(self, i: int) -> float:
        d = self.tp[i] + self.fp[i]
        return float(self.tp[i] / d) if d else 0.0

    def recall(self, i: int) -> float:
        d = self.tp[i] + self.fn[i]
        return float(self.tp[i] / d) if d else 0.0

    def f1(self, i: int) -> float:
        p, r = self.precision(i), self.recall(i)
        return 2 * p * r / (p + r) if (p + r) else 0.0


class ROC:
    """Binary ROC/AUC with exact threshold sweep (reference ``ROC`` with
    thresholdSteps=0 = exact mode). Stores scores; AUC via rank statistic."""

    def __init__(self):
        self.scores: list[np.ndarray] = []
        self.labels: list[np.ndarray] = []

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1)
        preds = np.asarray(predictions).reshape(-1)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        self.labels.append(labels >= 0.5)
        self.scores.append(preds)
        return self

    def calculate_auc(self) -> float:
        y = np.concatenate(self.labels)
        s = np.concatenate(self.scores)
        pos, neg = int(y.sum()), int((~y).sum())
        if pos == 0 or neg == 0:
            return 0.0
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        # average ranks for ties
        sorted_s = s[order]
        ranks[order] = np.arange(1, len(s) + 1)
        i = 0
        while i < len(s):
            j = i
            while j + 1 < len(s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            if j > i:
                ranks[order[i:j + 1]] = (i + j + 2) / 2.0
            i = j + 1
        return float((ranks[y].sum() - pos * (pos + 1) / 2.0) / (pos * neg))

    def calculate_auprc(self) -> float:
        y = np.concatenate(self.labels).astype(np.float64)
        s = np.concatenate(self.scores)
        order = np.argsort(-s, kind="mergesort")
        y = y[order]
        tp = np.cumsum(y)
        precision = tp / np.arange(1, len(y) + 1)
        total_pos = y.sum()
        if total_pos == 0:
            return 0.0
        return float(np.sum(precision * y) / total_pos)


class RegressionEvaluation:
    """Reference ``RegressionEvaluation``: per-column MSE/MAE/RMSE/R^2/
    correlation, accumulated over batches."""

    def __init__(self):
        self.n = 0
        self.sum_err2 = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels, np.float64)
        preds = np.asarray(predictions, np.float64).reshape(labels.shape)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        if self.sum_err2 is None:
            cols = labels.shape[-1]
            self.sum_err2 = np.zeros(cols)
            self.sum_abs = np.zeros(cols)
            self.sum_label = np.zeros(cols)
            self.sum_label2 = np.zeros(cols)
            self.sum_pred = np.zeros(cols)
            self.sum_pred2 = np.zeros(cols)
            self.sum_lp = np.zeros(cols)
        err = preds - labels
        self.n += labels.shape[0]
        self.sum_err2 += (err ** 2).sum(0)
        self.sum_abs += np.abs(err).sum(0)
        self.sum_label += labels.sum(0)
        self.sum_label2 += (labels ** 2).sum(0)
        self.sum_pred += preds.sum(0)
        self.sum_pred2 += (preds ** 2).sum(0)
        self.sum_lp += (labels * preds).sum(0)
        return self

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self.sum_err2[col] / self.n)

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self.sum_abs[col] / self.n)

    def root_mean_squared_error(self, col: int = 0) -> float:
        return float(np.sqrt(self.mean_squared_error(col)))

    def r_squared(self, col: int = 0) -> float:
        ss_tot = self.sum_label2[col] - self.sum_label[col] ** 2 / self.n
        ss_res = self.sum_err2[col]
        return float(1.0 - ss_res / ss_tot) if ss_tot else 0.0

    def pearson_correlation(self, col: int = 0) -> float:
        n = self.n
        cov = self.sum_lp[col] - self.sum_label[col] * self.sum_pred[col] / n
        vl = self.sum_label2[col] - self.sum_label[col] ** 2 / n
        vp = self.sum_pred2[col] - self.sum_pred[col] ** 2 / n
        d = np.sqrt(vl * vp)
        return float(cov / d) if d else 0.0


class ROCMultiClass:
    """One-vs-all ROC per class (reference ``ROCMultiClass``): per-class
    AUC/AUPRC plus macro average."""

    def __init__(self, num_classes: int | None = None):
        self.num_classes = num_classes
        self._rocs: list[ROC] | None = None

    def _ensure(self, n: int):
        if self._rocs is None:
            self.num_classes = self.num_classes or n
            self._rocs = [ROC() for _ in range(self.num_classes)]

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        self._ensure(labels.shape[-1])
        for c in range(self.num_classes):
            self._rocs[c].eval(labels[:, c], preds[:, c], mask)
        return self

    def calculate_auc(self, class_idx: int) -> float:
        return self._rocs[class_idx].calculate_auc()

    def calculate_auprc(self, class_idx: int) -> float:
        return self._rocs[class_idx].calculate_auprc()

    def _defined(self):
        # a class with no positives or no negatives has undefined ROC;
        # skip it rather than dragging the macro average toward 0
        out = []
        for r in self._rocs:
            y = (np.concatenate(r.labels) if r.labels
                 else np.zeros(0, bool))
            if 0 < int(y.sum()) < y.size:
                out.append(r)
        return out

    def calculate_average_auc(self) -> float:
        rocs = self._defined()
        if not rocs:
            return 0.0
        return float(np.mean([r.calculate_auc() for r in rocs]))

    def calculate_average_auprc(self) -> float:
        rocs = self._defined()
        if not rocs:
            return 0.0
        return float(np.mean([r.calculate_auprc() for r in rocs]))


class EvaluationCalibration:
    """Reliability/calibration accumulator (reference
    ``EvaluationCalibration``): confidence-binned counts and accuracies
    (reliability diagram data), residual histogram, and expected
    calibration error."""

    def __init__(self, reliability_bins: int = 10,
                 histogram_bins: int = 50):
        self.bins = int(reliability_bins)
        self.hist_bins = int(histogram_bins)
        self.bin_counts = np.zeros(self.bins, np.int64)
        self.bin_correct = np.zeros(self.bins, np.int64)
        self.bin_conf_sum = np.zeros(self.bins, np.float64)
        self.residual_hist = np.zeros(self.hist_bins, np.int64)

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels)
        preds = np.asarray(predictions)
        labels = labels.reshape(-1, labels.shape[-1])
        preds = preds.reshape(-1, preds.shape[-1])
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds = labels[m], preds[m]
        conf = preds.max(-1)
        correct = preds.argmax(-1) == labels.argmax(-1)
        idx = np.clip((conf * self.bins).astype(int), 0, self.bins - 1)
        np.add.at(self.bin_counts, idx, 1)
        np.add.at(self.bin_correct, idx, correct.astype(np.int64))
        np.add.at(self.bin_conf_sum, idx, conf)
        # residual = |label - prob| over all entries (reference residual plot)
        resid = np.abs(labels - preds).reshape(-1)
        h = np.clip((resid * self.hist_bins).astype(int), 0,
                    self.hist_bins - 1)
        np.add.at(self.residual_hist, h, 1)
        return self

    def reliability_accuracy(self) -> np.ndarray:
        """Per-bin observed accuracy (nan for empty bins)."""
        with np.errstate(invalid="ignore"):
            return self.bin_correct / np.where(self.bin_counts, self.bin_counts,
                                               np.nan)

    def reliability_confidence(self) -> np.ndarray:
        with np.errstate(invalid="ignore"):
            return self.bin_conf_sum / np.where(self.bin_counts,
                                                self.bin_counts, np.nan)

    def expected_calibration_error(self) -> float:
        total = self.bin_counts.sum()
        if total == 0:
            return 0.0
        acc = np.nan_to_num(self.reliability_accuracy())
        conf = np.nan_to_num(self.reliability_confidence())
        return float(np.sum(self.bin_counts * np.abs(acc - conf)) / total)


class ROCBinary(ROCMultiClass):
    """Per-output-column binary ROC (reference ``ROCBinary`` for multi-label
    sigmoid outputs) — same accumulation as ROCMultiClass, labels are
    independent {0,1} columns rather than one-hot rows."""
