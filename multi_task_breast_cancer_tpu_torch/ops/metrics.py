"""Metrics (twin of ``multi_task_breast_cancer_tpu/ops/metrics.py``), in
two tiers:

- **device** (inside the epoch): batch Dice and the classification
  confusion matrix accumulate on the device and are fetched once per epoch;
- **host** (test time, per image): the reference's per-image metric dict
  with its NaN and empty-mask conventions and its row-as-point Hausdorff
  (``src/utils/metrics.py:26-74,175-252``), and the classification metrics.
  The JAX module takes the latter from sklearn, which the card's machine
  does not have: here they are numpy over a confusion matrix, with sklearn's
  ``labels=`` pinning and ``zero_division=0`` (``tests/test_torch_splits.py``
  holds every key and value to sklearn's).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.parallel import spatial

HAUSSDORF = "Haussdorf distance"
DICE = "DICE"
SENS = "Sensitivity"
SPEC = "Specificity"
ACC = "Accuracy"
JACC = "Jaccard index"
PREC = "Precision"
METRICS = [HAUSSDORF, DICE, SENS, SPEC, ACC, JACC, PREC]


# ---------------------------------------------------------------------------
# Device-side
# ---------------------------------------------------------------------------


def dice_from_logits_batch(gt: torch.Tensor, seg_logits: torch.Tensor) -> torch.Tensor:
    """Batch-level Dice of ``sigmoid(logits) > 0.5`` with the reference's
    empty-ground-truth rule (``metrics.py:255-267``: 1 if both are empty, 0 if
    only the ground truth is), over the whole batch as the reference computes
    it. Any layout: it sums over every element."""
    return dice_from_counts(dice_counts(gt, seg_logits))


def dice_counts(gt: torch.Tensor, seg_logits: torch.Tensor) -> torch.Tensor:
    """(tp, fp, fn) of ``sigmoid(logits) > 0.5`` against ``gt > 0.5`` over
    every element, int64: the sums a batch-level Dice needs, which ranks of
    a data mesh add up before :func:`dice_from_counts`. Under a ``space``
    group (this rank's rows) the counts are summed over the group: every
    rank gets the whole images'."""
    seg = torch.sigmoid(seg_logits) > 0.5
    gt_b = gt > 0.5
    counts = torch.stack([(seg & gt_b).sum(), (seg & ~gt_b).sum(), (~seg & gt_b).sum()])
    space = spatial.current()
    if space is not None and gt.shape[0]:
        counts = space.sum_partials(counts)
    return counts


def dice_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """The batch-level Dice of :func:`dice_counts`' (tp, fp, fn)."""
    tp, fp, fn = counts.float().unbind(-1)
    dice = 2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1e-12)
    one, zero = torch.ones_like(dice), torch.zeros_like(dice)
    return torch.where(tp + fn == 0, torch.where(tp + fp == 0, one, zero), dice)


def confusion_matrix_update(cm: torch.Tensor, gt_labels: torch.Tensor,
                            pred_labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Add a batch to an (n, n) confusion matrix (rows ground truth, columns
    prediction)."""
    gt_oh = F.one_hot(gt_labels.long(), n_classes).to(cm.dtype)
    pred_oh = F.one_hot(pred_labels.long(), n_classes).to(cm.dtype)
    return cm + gt_oh.T @ pred_oh


def accuracy_from_cm(cm: torch.Tensor) -> torch.Tensor:
    return torch.trace(cm) / torch.clamp(cm.sum(), min=1e-12)


def f1_weighted_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """sklearn ``f1_score(average='weighted')``: per-class F1 (0 where
    undefined), weighted by true-class support."""
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)
    denom = support + cm.sum(dim=0)
    f1 = torch.where(denom > 0, 2.0 * tp / torch.clamp(denom, min=1e-12),
                     torch.zeros_like(tp))
    return (f1 * support).sum() / torch.clamp(support.sum(), min=1e-12)


def predicted_labels_from_logits(logits: torch.Tensor, n_classes: int) -> torch.Tensor:
    """Reference decision rule (``training_multitask.py:34-62``): multiclass
    → argmax; binary → sigmoid > 0.5."""
    if n_classes > 2:
        return logits.argmax(dim=-1)
    return (torch.sigmoid(logits[..., 0]) > 0.5).to(torch.int32)


# ---------------------------------------------------------------------------
# Host-side (per image, test time)
# ---------------------------------------------------------------------------


def sensitivity(tp: float, fn: float) -> float:
    return np.nan if tp == 0 else tp / (tp + fn)


def specificity(tn: float, fp: float) -> float:
    return tn / (tn + fp)


def precision(tp: float, fp: float) -> float:
    return np.nan if tp == 0 else tp / (tp + fp)


def accuracy(tp: float, tn: float, fp: float, fn: float) -> float:
    return (tp + tn) / (tp + tn + fp + fn)


def f1_score(tp: float, fp: float, fn: float) -> float:
    return (2 * tp) / (2 * tp + fp + fn)


def dice_score(tp: float, fp: float, fn: float, gt: np.ndarray, seg: np.ndarray) -> float:
    if np.sum(gt) == 0:
        return 1.0 if np.sum(seg) == 0 else 0.0
    return 2 * tp / (2 * tp + fp + fn)


def jaccard_index(tp: float, fp: float, fn: float, gt: np.ndarray, seg: np.ndarray) -> float:
    if np.sum(gt) == 0:
        return 1.0 if np.sum(seg) == 0 else 0.0
    return tp / (tp + fp + fn)


def haussdorf_distance(gt: np.ndarray, seg: np.ndarray) -> float:
    """The reference's 'Hausdorff' (``metrics.py:238-252``): 0 if both masks
    are empty, NaN if one is; else ``scipy.directed_hausdorff`` on the raw
    2-D masks, which takes each image ROW as one W-dimensional point. That
    is not the geometric distance between the masks; the quirk is kept so
    the per-image CSV column matches the reference's values."""
    from scipy.spatial.distance import directed_hausdorff
    gt2 = np.asarray(gt, dtype=bool)
    seg2 = np.asarray(seg, dtype=bool)
    while gt2.ndim > 2:
        gt2, seg2 = gt2[0], seg2[0]
    if np.sum(gt2) == 0 and np.sum(seg2) == 0:
        return 0.0
    if (np.sum(gt2) == 0) != (np.sum(seg2) == 0):
        return float(np.nan)
    return max(directed_hausdorff(seg2, gt2)[0], directed_hausdorff(gt2, seg2)[0])


def calculate_metrics(ground_truth: np.ndarray, segmentation: np.ndarray,
                      patient) -> Dict[str, float]:
    """Per-image binary metric dict (reference ``metrics.py:26-74``)."""
    assert segmentation.shape == ground_truth.shape, \
        "Predicted segmentation and ground truth do not have the same size"
    gt = ground_truth.astype(float)
    seg = segmentation.astype(float)
    tp = float(np.sum(np.logical_and(seg, gt)))
    tn = float(np.sum(np.logical_and(np.logical_not(seg), np.logical_not(gt))))
    fp = float(np.sum(np.logical_and(seg, np.logical_not(gt))))
    fn = float(np.sum(np.logical_and(np.logical_not(seg), gt)))
    return {
        "patient_id": patient,
        HAUSSDORF: haussdorf_distance(gt, seg),
        DICE: dice_score(tp, fp, fn, gt, seg),
        SENS: sensitivity(tp, fn),
        # unguarded, as in the reference (metrics.py:70,193): an image with
        # no background pixels raises there too
        SPEC: specificity(tn, fp),
        ACC: accuracy(tp, tn, fp, fn),
        JACC: jaccard_index(tp, fp, fn, gt, seg),
        PREC: precision(tp, fp),
    }


def calculate_metrics_multiclass_segmentation(ground_truth: np.ndarray,
                                              segmentation: np.ndarray,
                                              patient, num_classes: int = 3,
                                              skip_background: bool = True,
                                              averaging: bool = True) -> Dict:
    """Per-region metric loop (reference ``metrics.py:77-129``)."""
    assert segmentation.shape == ground_truth.shape
    start = 1 if skip_background else 0
    out: Dict = {"patient_id": patient}
    for m in METRICS:
        out[m] = []
    for i in range(start, num_classes):
        gt = (ground_truth == i).astype(float)
        seg = (segmentation == i).astype(float)
        tp = float(np.sum(np.logical_and(seg, gt)))
        tn = float(np.sum(np.logical_and(np.logical_not(seg), np.logical_not(gt))))
        fp = float(np.sum(np.logical_and(seg, np.logical_not(gt))))
        fn = float(np.sum(np.logical_and(np.logical_not(seg), gt)))
        out[HAUSSDORF].append(haussdorf_distance(gt, seg))
        out[DICE].append(dice_score(tp, fp, fn, gt, seg))
        out[SENS].append(sensitivity(tp, fn))
        try:
            out[SPEC].append(specificity(tn, fp))
        except ZeroDivisionError:
            out[SPEC].append(0)
        out[ACC].append(accuracy(tp, tn, fp, fn))
        out[JACC].append(jaccard_index(tp, fp, fn, gt, seg))
        out[PREC].append(precision(tp, fp))
    if averaging:
        for k in out:
            if k != "patient_id":
                out[k] = np.nanmean(out[k])
    return out


def confusion_matrix(y_true, y_pred, labels: List[int]) -> np.ndarray:
    """sklearn's ``confusion_matrix(y_true, y_pred, labels=labels)``: rows
    ground truth, columns prediction, int64; pairs with a value outside
    ``labels`` are not counted."""
    index = {label: i for i, label in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def _check_not_empty(ground_truth) -> None:
    if np.asarray(ground_truth).size == 0:
        raise ValueError("classification metrics of an empty set")


def binary_classification_metrics(ground_truth, predictions) -> Dict[str, float]:
    """Reference ``metrics.py:387-400``, with the labels pinned to [0, 1] so
    that single-class data keeps a 2×2 matrix (the reference's 4-way unpack
    would crash on it). Like sklearn, it refuses an empty input and ground
    truth holding neither label."""
    _check_not_empty(ground_truth)
    if not np.isin(np.asarray(ground_truth), [0, 1]).any():
        raise ValueError("At least one label specified must be in y_true")
    tn, fp, fn, tp = confusion_matrix(ground_truth, predictions, [0, 1]).ravel()
    return {
        "Precision": precision(tp, fp),
        "Sensitivity": sensitivity(tp, fn),
        "Specificity": specificity(tn, fp),
        "Accuracy": accuracy(tp, tn, fp, fn),
        "F1 score": f1_score(tp, fp, fn),
    }


def _divide(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """sklearn's ``_prf_divide`` with ``zero_division=0``."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    zero = den == 0
    out = num / np.where(zero, 1.0, den)
    out[zero] = 0.0
    return out


def _weighted_mean(values: np.ndarray, weights=None) -> float:
    """sklearn's ``_nanaverage``: NaNs dropped; all-zero weights ignored."""
    keep = ~np.isnan(values)
    if not keep.any():
        return float("nan")
    if weights is None:
        return float(np.mean(values[keep]))
    try:
        return float(np.average(values[keep], weights=np.asarray(weights)[keep]))
    except ZeroDivisionError:
        return float(np.average(values[keep]))


def multiclass_classification_metrics(ground_truth, predictions,
                                      labels: Optional[List[int]] = None
                                      ) -> Dict[str, float]:
    """Reference ``metrics.py:407-458``: per-class and macro / micro /
    weighted precision, recall and F1 (sklearn's ``labels=``,
    ``zero_division=0``), then accuracy."""
    _check_not_empty(ground_truth)
    if labels is None:
        labels = [0, 1, 2]
    cm = confusion_matrix(ground_truth, predictions, labels)
    tp = np.diagonal(cm).copy()
    pred_sum, true_sum = cm.sum(axis=0), cm.sum(axis=1)

    def scores(tp, pred_sum, true_sum):
        return {"precision": _divide(tp, pred_sum), "recall": _divide(tp, true_sum),
                "f1": _divide(2.0 * tp, 1.0 * true_sum + pred_sum)}

    per_class = scores(tp, pred_sum, true_sum)
    micro = scores(tp.sum(keepdims=True), pred_sum.sum(keepdims=True),
                   true_sum.sum(keepdims=True))
    out: Dict[str, float] = {}
    for name, values in per_class.items():
        for n, value in enumerate(values):
            out[f"{name}_class_{n}"] = value
        out[f"{name}_macro"] = _weighted_mean(values)
        out[f"{name}_micro"] = _weighted_mean(micro[name])
        out[f"{name}_weighted"] = _weighted_mean(values, true_sum)
    out["accuracy"] = float(np.mean(np.asarray(ground_truth) == np.asarray(predictions)))
    return out
