"""Device-side training metrics (twin of the device tier of
``multi_task_breast_cancer_tpu/ops/metrics.py``): batch Dice and the
classification confusion matrix accumulate on the device and are fetched once
per epoch. The host-side per-image metrics belong to the inference slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_from_logits_batch(gt: torch.Tensor, seg_logits: torch.Tensor) -> torch.Tensor:
    """Batch-level Dice of ``sigmoid(logits) > 0.5`` with the reference's
    empty-ground-truth rule (``metrics.py:255-267``: 1 if both are empty, 0 if
    only the ground truth is), over the whole batch as the reference computes
    it. Any layout: it sums over every element."""
    seg = torch.sigmoid(seg_logits) > 0.5
    gt_b = gt > 0.5
    tp = (seg & gt_b).sum().float()
    fp = (seg & ~gt_b).sum().float()
    fn = (~seg & gt_b).sum().float()
    dice = 2.0 * tp / torch.clamp(2.0 * tp + fp + fn, min=1e-12)
    one, zero = torch.ones_like(dice), torch.zeros_like(dice)
    return torch.where(gt_b.sum() == 0, torch.where(seg.sum() == 0, one, zero), dice)


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
