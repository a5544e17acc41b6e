"""Loss functions of the training slice (twin of
``multi_task_breast_cancer_tpu/ops/losses.py``), as plain tensor functions.

Segmentation tensors are NCHW here (the JAX package is NHWC): the per-(batch,
channel) statistics reduce over axes (2, 3). Semantics are the JAX
package's, which reproduce the reference's MONAI losses and custom Focal
(``src/utils/criterions.py``), including the deep-supervision weighting: heads
summed over the *reversed* head order with optional inverse weights
``1/(j+1)``, so the finest head always weighs 1; classification head lists
are never inverse-weighted.

Every criterion of the JAX factories is here, with its mapping
(:func:`init_criterion_segmentation`). The Hausdorff criterion's exact
Euclidean distance transform runs on the tensor's device in tensor ops
(:func:`edt_field`), as JAX runs it on its device.
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


def seg_focal_loss(logits: torch.Tensor, target: torch.Tensor, *, gamma: float = 2.0,
                   reduction: str = "mean") -> torch.Tensor:
    """MONAI ``FocalLoss(include_background=True, use_softmax=False)``:
    per-pixel sigmoid focal BCE, numerically stable."""
    bce = logits.clamp(min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    p = torch.sigmoid(logits)
    pt = torch.where(target > 0.5, p, 1.0 - p)
    focal = torch.pow(1.0 - pt, gamma) * bce
    if reduction == "mean":
        return focal.mean()
    return focal.sum()


def generalized_dice_loss(logits: torch.Tensor, target: torch.Tensor, *, sigmoid: bool = True,
                          smooth_nr: float = 1e-5, smooth_dr: float = 1e-5) -> torch.Tensor:
    """MONAI ``GeneralizedDiceLoss(include_background=True, sigmoid=True)``,
    square class weighting. The infinite weights of an empty ground truth
    are zeroed first, then replaced by the sample's largest weight, so a
    sample whose every class is empty weighs 0 (a finite loss), as in JAX."""
    p = torch.sigmoid(logits) if sigmoid else logits
    intersection = (p * target).sum(dim=_SPATIAL)
    ground_o = target.sum(dim=_SPATIAL)
    denominator = ground_o + p.sum(dim=_SPATIAL)
    w = 1.0 / (ground_o * ground_o)
    infs = torch.isinf(w)
    w = torch.where(infs, torch.zeros_like(w), w)
    w = torch.where(infs, w.amax(dim=-1, keepdim=True), w)
    numer = 2.0 * (intersection * w).sum(dim=-1) + smooth_nr
    denom = (denominator * w).sum(dim=-1) + smooth_dr
    return (1.0 - numer / denom).mean()


def dice_ce_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MONAI ``DiceCELoss(include_background=True, sigmoid=True,
    squared_pred=True)``: dice (smooth 1e-5) + BCE-with-logits."""
    return (dice_loss(logits, target, smooth_nr=1e-5, smooth_dr=1e-5, squared_pred=True)
            + bce_with_logits(logits, target))


def dice_focal_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MONAI ``DiceFocalLoss(include_background=True, sigmoid=True,
    smooth_nr=1, smooth_dr=1, squared_pred=True)``: dice + focal."""
    return (dice_loss(logits, target, smooth_nr=1.0, smooth_dr=1.0, squared_pred=True)
            + seg_focal_loss(logits, target))


_EDT_BIG = 1e9  # "no zero in sight" (JAX's scan carry); squares stay finite in f32
_EDT_BLOCK = 1 << 24  # elements of the row pass's (…, W, W) temporary per chunk


def _column_distance(zero: torch.Tensor) -> torch.Tensor:
    """Per column (along H of NCHW), the distance to the nearest zero pixel,
    ``_EDT_BIG`` where the column has none: the last zero at or above each
    row and the first at or below it, from two ``cummax`` of row indices."""
    h = zero.shape[2]
    rows = torch.arange(h, device=zero.device, dtype=torch.float32).reshape(1, 1, h, 1)
    none = torch.full((), -_EDT_BIG, device=zero.device)
    above = torch.where(zero, rows, none).cummax(dim=2).values
    below = torch.where(zero, (h - 1) - rows, none).flip(2).cummax(dim=2).values.flip(2)
    up = torch.where(above >= 0, rows - above, torch.full((), _EDT_BIG, device=zero.device))
    down = torch.where(below >= 0, (h - 1 - below) - rows,
                       torch.full((), _EDT_BIG, device=zero.device))
    return torch.minimum(up, down)


def _edt_binary(nonzero: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance transform, scipy semantics: each nonzero
    pixel → its distance to the nearest zero pixel; zeros → 0. NCHW bool in,
    float32 out. Separable, as JAX's: the column distances g
    (:func:`_column_distance`), then the exact row pass ``D²(i, j) =
    min_k g(i, k)² + (j − k)²`` as a min over a (…, W, W) tensor, in chunks
    of output columns that bound the temporary. Input with no zero at all is
    clamped to the image diagonal, as in JAX."""
    n, c, h, w = nonzero.shape
    g2 = torch.square(_column_distance(~nonzero))
    k = torch.arange(w, device=nonzero.device, dtype=torch.float32)
    par = torch.square(k[None, :] - k[:, None])  # (j, k)
    step = max(1, _EDT_BLOCK // max(1, n * c * h * w))
    d2 = torch.cat([(g2[..., None, :] + par[j:j + step]).amin(dim=-1)
                    for j in range(0, w, step)], dim=-1)
    # the f32 root correctly rounded on every device: CUDA's f32 sqrt is one
    # ulp off it for some integers (4285, 2925); f64's, rounded to f32, is not
    return torch.sqrt(torch.clamp(d2, max=float(h * h + w * w)).double()).float()


def edt_field(mask: torch.Tensor) -> torch.Tensor:
    """MONAI ``HausdorffDTLoss.distance_field``: ``edt(m) + edt(~m)`` per
    (batch, channel), zeroed where the mask is empty."""
    m = mask > 0.5
    field = _edt_binary(m) + _edt_binary(~m)
    nonempty = m.any(dim=3, keepdim=True).any(dim=2, keepdim=True)
    return torch.where(nonempty, field, torch.zeros((), device=mask.device))


def hausdorff_dt_loss(logits: torch.Tensor, target: torch.Tensor, *,
                      alpha: float = 2.0) -> torch.Tensor:
    """MONAI ``HausdorffDTLoss(sigmoid=True)``: (p − g)² weighted by the
    exact distance-transform fields of the prediction and the target, both
    without gradient."""
    p = torch.sigmoid(logits)
    dist = (torch.pow(edt_field(p.detach()), alpha)
            + torch.pow(edt_field(target.detach()), alpha))
    return (torch.square(p - target) * dist).mean()


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
    """The JAX factory's mapping (``experiment_init.py:199-232`` of the
    reference). Every criterion applies the sigmoid itself: models emit raw
    logits."""
    if loss_function == "DICE":
        return functools.partial(dice_loss, sigmoid=True, smooth_nr=1.0,
                                 smooth_dr=1.0, squared_pred=True)
    if loss_function == "Hausdorff":
        return hausdorff_dt_loss
    if loss_function == "FocalDICE":
        return dice_focal_loss
    if loss_function == "GeneralizedDICE":
        return generalized_dice_loss
    if loss_function == "CrossentropyDICE":
        return dice_ce_loss
    if loss_function == "Jaccard":
        return functools.partial(dice_loss, sigmoid=True, smooth_nr=1e-5,
                                 smooth_dr=1e-5, squared_pred=False,
                                 jaccard=True, reduction="sum")
    if loss_function == "FocalLoss":
        return seg_focal_loss
    if loss_function == "BCE":
        return bce_with_logits
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
