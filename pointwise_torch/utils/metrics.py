"""Shared evaluation metrics (SURVEY.md C11: accuracy / per-class IoU / mIoU).

NumPy-side (host) metrics for eval flows; the in-graph train metrics live in
the loss functions.
"""

from __future__ import annotations

import numpy as np


def confusion_matrix(pred: np.ndarray, label: np.ndarray, num_classes: int):
    """(num_classes, num_classes) with rows = true class, cols = predicted.

    Out-of-range entries in EITHER array are excluded (an out-of-range pred
    would otherwise alias into a wrong cell or crash the bincount reshape —
    e.g. evaluating a class subset narrower than the logit width, or a -1
    ignore marker)."""
    mask = ((label >= 0) & (label < num_classes)
            & (pred >= 0) & (pred < num_classes))
    idx = label[mask].astype(np.int64) * num_classes + pred[mask].astype(np.int64)
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def iou_from_confusion(cm: np.ndarray):
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    present = union > 0
    iou = np.zeros(len(cm))
    iou[present] = inter[present] / union[present]
    return iou, present


def segmentation_metrics(pred: np.ndarray, label: np.ndarray, num_classes: int):
    """Overall accuracy, mean class accuracy, per-class IoU and mIoU."""
    cm = confusion_matrix(pred, label, num_classes)
    total = cm.sum()
    acc = float(np.diag(cm).sum() / max(total, 1))
    row = cm.sum(1)
    cls_acc = np.divide(np.diag(cm), row, out=np.zeros(len(cm)), where=row > 0)
    iou, present = iou_from_confusion(cm)
    return {
        "accuracy": acc,
        "mean_class_accuracy": float(cls_acc[row > 0].mean()) if (row > 0).any() else 0.0,
        "miou": float(iou[present].mean()) if present.any() else 0.0,
        "per_class_iou": iou.tolist(),
        "confusion": cm,
    }
