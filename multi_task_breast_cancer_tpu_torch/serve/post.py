"""Serving postprocessing: raw model outputs (NHWC numpy) → per-image class
probabilities, predicted class (with the pipeline-refinement overlap rule,
``models.py:300-397``) and masks (binary tumor masks, or per-pixel label
maps for semantic-segmentation models).

A copy of ``multi_task_breast_cancer_tpu/serve/post.py`` and of the three
numpy helpers it takes from ``train/inference.py``: the port imports nothing
from the JAX package, and ``tests/test_torch_serving.py`` holds the two
copies to the same answers."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from multi_task_breast_cancer_tpu_torch.utils.trees import multitask_pair


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _cls_logits_np(cls_out) -> np.ndarray:
    """Mean over deep-supervised cls heads (``models.py:327,361``)."""
    if isinstance(cls_out, (tuple, list)):
        return np.mean(np.stack([np.asarray(c) for c in cls_out], 0), 0)
    return np.asarray(cls_out)

CLASS_NAMES = ["benign", "malignant", "normal"]


def model_applies_softmax(task: str, architecture: str, n_classes: int) -> bool:
    """True when the model's forward already emits probabilities.

    The nnU-Net classifier applies softmax INSIDE forward for multiclass
    (reference quirk, ``nnUNet_classifier.py:168-169``) — postprocessing must
    not re-normalize, or served probabilities are softmax(softmax(logits)):
    badly flattened and uncalibrated (argmax survives, thresholds don't)."""
    return (task == "classification" and architecture == "nnUNetClassifier"
            and n_classes > 2)


@dataclass
class PredictionBatch:
    """Postprocessed outputs for a batch of serving inputs."""

    probs: Optional[np.ndarray]          # (N, n_classes) or (N, 1); None for seg-only
    pred_class: Optional[List[str]]      # None when no class is predicted
    masks: Optional[np.ndarray]          # (N, H, W) uint8; None for classification
    mask_scale: int = 255                # PNG intensity per label step (127 semantic)

    def record(self, i: int) -> dict:
        """JSON-ready record for image ``i`` (mask reported as pixel count;
        the callers attach the mask itself in their own format)."""
        rec: dict = {}
        if self.masks is not None:
            rec["tumor_pixels"] = int((self.masks[i] != 0).sum())
        if self.probs is not None:
            rec["probs"] = self.probs[i].tolist()
        if self.pred_class is not None:
            rec["predicted_class"] = self.pred_class[i]
        return rec


def postprocess(out, task: str, n_classes: int, pr_enabled: bool,
                softmax_in_forward: bool = False) -> PredictionBatch:
    """Normalise a model-output pytree into probabilities/classes/masks.

    Mirrors the inference conventions of ``train/inference.py``: the last
    deep-supervision head is the prediction, multitask tuples are
    ``(cls, seg)`` (Adityan's reconstruction middle output is dropped), and
    with ``pr_enabled`` an empty predicted mask overrides the classifier to
    'normal' (the reference's pipeline-refinement rule (a),
    ``models.py:300-345``).

    ``softmax_in_forward`` (see :func:`model_applies_softmax`): the output is
    already a probability vector — use it as-is instead of re-softmaxing.

    Segmentation heads with >1 output channel (``regions > 1``, the semantic-
    segmentation setup of ``models.py:140-162``) are decoded as per-pixel
    softmax-argmax label maps, with the class derived from the reference's
    pixel vote; single-channel heads as sigmoid>0.5 binary tumor masks. The
    branch keys on the OUTPUT SHAPE, so any regions configuration serves
    correctly without extra manifest plumbing."""
    probs = pred_class = masks = None
    mask_scale = 255

    if task == "classification":
        logits = _cls_logits_np(out)
        if softmax_in_forward:
            probs = logits
        else:
            probs = _softmax(logits) if n_classes > 2 else _sigmoid(logits)
    else:
        seg_out = out
        if task == "multitask":
            cls_out, seg_out = multitask_pair(out)
            logits = _cls_logits_np(cls_out)
            probs = _softmax(logits) if n_classes > 2 else _sigmoid(logits)
        final = np.asarray(seg_out[-1] if isinstance(seg_out, (tuple, list))
                           else seg_out)
        if final.shape[-1] > 1:
            # semantic: per-pixel argmax labels (the reference softmaxes
            # first, models.py:142 — argmax is invariant under softmax, so
            # the full-resolution exp/sum/divide is skipped on this hot path)
            masks = np.argmax(final, axis=-1).astype(np.uint8)
            mask_scale = 255 // max(1, final.shape[-1] - 1)
            if task == "segmentation":
                # reference pixel vote (models.py:152-158): benign wins ties
                pred_class = ["benign" if (m == 1).sum() >= (m == 2).sum()
                              else "malignant" for m in masks]
        else:
            masks = (_sigmoid(final[..., 0]) > 0.5).astype(np.uint8)

    if probs is not None:
        if n_classes > 2:
            pred_class = [CLASS_NAMES[int(np.argmax(p))] for p in probs]
        else:
            pred_class = ["malignant" if p[0] > 0.5 else "benign" for p in probs]
        if pr_enabled and masks is not None and n_classes > 2:
            pred_class = ["normal" if m.sum() == 0 else c
                          for c, m in zip(pred_class, masks)]

    return PredictionBatch(probs=probs, pred_class=pred_class, masks=masks,
                           mask_scale=mask_scale)


def postprocess_compact(out: dict, task: str, n_classes: int,
                        pr_enabled: bool) -> PredictionBatch:
    """Decode a **device-postprocessed** artifact's compact output dict
    (``export._compact_outputs``) into the same :class:`PredictionBatch` the
    raw path produces — the device already did sigmoid/argmax/pixel counts,
    so the host only maps counts to class names and applies the PR override
    (reference rule (a), ``models.py:300-345``)."""
    probs = None if out.get("probs") is None else np.asarray(out["probs"])
    masks = None if out.get("mask") is None else np.asarray(out["mask"])
    pred_class = None
    mask_scale = 255

    label_counts = out.get("label_counts")
    if label_counts is not None:  # semantic label map
        label_counts = np.asarray(label_counts)
        mask_scale = 255 // max(1, label_counts.shape[1] - 1)
        if task == "segmentation":
            # reference pixel vote (models.py:152-158): benign wins ties.
            # A 2-channel semantic head has no malignant count — the raw
            # path's (m == 2).sum() degrades to 0 there, so mirror that
            # instead of indexing past the counts array.
            def _count(c, lbl):
                return c[lbl] if lbl < c.shape[0] else 0
            pred_class = ["benign" if _count(c, 1) >= _count(c, 2)
                          else "malignant" for c in label_counts]
        nonzero_px = label_counts[:, 1:].sum(axis=1)
    elif masks is not None:
        nonzero_px = np.asarray(out["tumor_pixels"])
    else:
        nonzero_px = None

    if probs is not None:
        if n_classes > 2:
            pred_class = [CLASS_NAMES[int(np.argmax(p))] for p in probs]
        else:
            pred_class = ["malignant" if p[0] > 0.5 else "benign" for p in probs]
        if pr_enabled and nonzero_px is not None and n_classes > 2:
            pred_class = ["normal" if n == 0 else c
                          for c, n in zip(pred_class, nonzero_px)]

    return PredictionBatch(probs=probs, pred_class=pred_class, masks=masks,
                           mask_scale=mask_scale)
