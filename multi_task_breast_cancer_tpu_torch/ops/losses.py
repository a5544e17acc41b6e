"""Loss functions of the training slice (twin of
``multi_task_breast_cancer_tpu/ops/losses.py``), as plain tensor functions.

Segmentation tensors are NCHW here (the JAX package is NHWC): the per-(batch,
channel) statistics reduce over axes (2, 3). Semantics are the JAX
package's, which reproduce the reference's MONAI losses and custom Focal
(``src/utils/criterions.py``), including the deep-supervision weighting: heads
summed over the *reversed* head order with optional inverse weights
``1/(j+1)``, so the finest head always weighs 1; classification head lists
are never inverse-weighted.

This slice ports the DICE criterion and the classification criteria. The
other segmentation criteria of the JAX factory raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

SegOut = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
_SPATIAL = (2, 3)


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------


def dice_loss(logits: torch.Tensor, target: torch.Tensor, *, sigmoid: bool = True,
              smooth_nr: float = 1.0, smooth_dr: float = 1.0,
              squared_pred: bool = True, jaccard: bool = False,
              reduction: str = "mean") -> torch.Tensor:
    """MONAI ``DiceLoss(include_background=True, sigmoid, smooth_nr/dr,
    squared_pred)``. NCHW in, scalar out (``reduction='none'``: (B, C))."""
    p = torch.sigmoid(logits) if sigmoid else logits
    intersection = (p * target).sum(dim=_SPATIAL)
    if squared_pred:
        ground_o = (target * target).sum(dim=_SPATIAL)
        pred_o = (p * p).sum(dim=_SPATIAL)
    else:
        ground_o = target.sum(dim=_SPATIAL)
        pred_o = p.sum(dim=_SPATIAL)
    denominator = ground_o + pred_o
    if jaccard:
        denominator = 2.0 * (denominator - intersection)
    f = 1.0 - (2.0 * intersection + smooth_nr) / (denominator + smooth_dr)
    if reduction == "mean":
        return f.mean()
    if reduction == "sum":
        return f.sum()
    return f


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch ``BCEWithLogitsLoss`` (mean reduction), written out as the JAX
    package writes it: ``max(x, 0) − x·t + log1p(exp(−|x|))``."""
    bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return bce.mean()


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                          weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``cross_entropy`` with probability targets (reduction='none'):
    per-sample ``-sum_c w_c · t_c · log_softmax(x)_c``. (B, C) in, (B,) out."""
    logp = F.log_softmax(logits, dim=-1)
    if weight is not None:
        logp = logp * weight[None, :]
    return -(target * logp).sum(dim=-1)


def focal_loss(logits: torch.Tensor, target: torch.Tensor, *, alpha: float = 1.0,
               gamma: float = 2.0, weight: Optional[torch.Tensor] = None,
               reduction: str = "mean") -> torch.Tensor:
    """Reference custom ``FocalLoss`` (``criterions.py:6-24``):
    ce → pt = exp(−ce) → mean(alpha·(1−pt)^gamma·ce)."""
    ce = softmax_cross_entropy(logits, target, weight)
    pt = torch.exp(-ce)
    fl = alpha * torch.pow(1.0 - pt, gamma) * ce
    if reduction == "mean":
        return fl.mean()
    if reduction == "sum":
        return fl.sum()
    return fl


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                       weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch ``CrossEntropyLoss(reduction='mean')`` with probability targets:
    a plain mean over the batch, weighted or not."""
    return softmax_cross_entropy(logits, target, weight).mean()


def inverse_frequency_weights(class_frequencies: Sequence[float],
                              device=None) -> torch.Tensor:
    """Normalised 1/frequency class weights (``experiment_init.py:243-250``)."""
    w = 1.0 / torch.as_tensor(class_frequencies, dtype=torch.float32, device=device)
    return w / w.sum()


# ---------------------------------------------------------------------------
# Criterion factories (names match the reference config vocabulary)
# ---------------------------------------------------------------------------

SEG_CRITERIA = ("DICE", "Hausdorff", "FocalDICE", "GeneralizedDICE",
                "CrossentropyDICE", "Jaccard", "FocalLoss", "BCE")


def init_criterion_segmentation(loss_function: str = "DICE"
                                ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``DICE`` (sigmoid, smooth 1/1, squared_pred) and ``BCE``; the other
    criteria of the JAX factory are not ported yet."""
    if loss_function == "DICE":
        return functools.partial(dice_loss, sigmoid=True, smooth_nr=1.0,
                                 smooth_dr=1.0, squared_pred=True)
    if loss_function == "BCE":
        return bce_with_logits
    if loss_function in SEG_CRITERIA:
        raise NotImplementedError(
            f"segmentation criterion {loss_function!r} is not ported to PyTorch "
            f"yet: it is in ROADMAP.md, Queue 1, item 2 (after the zoo: the remaining "
            f"losses)")
    raise ValueError(f"Select a loss function allowed: {SEG_CRITERIA}")


def init_criterion_classification(n_classes: int = 2,
                                  classes_weighted: Optional[Sequence[float]] = None,
                                  classification_criterion: str = "CE",
                                  device=None
                                  ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``experiment_init.py:235-263``: BCE-with-logits for binary; Focal or CE
    (optionally inverse-frequency weighted, the weights on ``device``) for
    multiclass."""
    if n_classes == 2:
        return bce_with_logits
    weight = (inverse_frequency_weights(classes_weighted, device)
              if classes_weighted else None)
    if classification_criterion == "Focal":
        return functools.partial(focal_loss, alpha=1.0, gamma=2.0, weight=weight)
    return functools.partial(cross_entropy_loss, weight=weight)


# ---------------------------------------------------------------------------
# Deep-supervision application (criterions.py equivalents)
# ---------------------------------------------------------------------------


def apply_criterion_binary_segmentation(criterion, ground_truth: torch.Tensor,
                                        segmentation: SegOut,
                                        inversely_weighted: bool = False) -> torch.Tensor:
    """``criterions.py:27-49``: deep-supervision heads summed; with inverse
    weighting head j (finest first) is scaled 1/(j+1)."""
    if isinstance(segmentation, (tuple, list)):
        heads = tuple(reversed(segmentation))  # finest first
        if inversely_weighted:
            return sum(criterion(s, ground_truth) / (j + 1) for j, s in enumerate(heads))
        return sum(criterion(s, ground_truth) for s in heads)
    return criterion(segmentation, ground_truth)


def apply_criterion_classification(criterion, label: torch.Tensor,
                                   predicted_class) -> torch.Tensor:
    """``criterions.py:79-97``: list outputs summed (never inverse-weighted),
    else the plain criterion."""
    if isinstance(predicted_class, (tuple, list)):
        return sum(criterion(c, label) for c in reversed(predicted_class))
    return criterion(predicted_class, label)


def apply_criterion_multitask(criterion_seg, ground_truth: torch.Tensor,
                              segmentation: SegOut, criterion_cls, label: torch.Tensor,
                              predicted_class, inversely_weighted: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``criterions.py:52-76``: (seg_loss, cls_loss); classification lists
    are summed without inverse weights even when ``inversely_weighted``."""
    seg_loss = apply_criterion_binary_segmentation(
        criterion_seg, ground_truth, segmentation, inversely_weighted)
    cls_loss = apply_criterion_classification(criterion_cls, label, predicted_class)
    return seg_loss, cls_loss


def check_finite_loss(loss_value: float) -> None:
    """Host-side NaN guard (``criterions.py:45-49``): call once per epoch on
    the aggregated loss."""
    if not math.isfinite(loss_value):
        raise FloatingPointError("NaN in model loss!!")
