"""Test-time inference, the Prediction Refinement (PR) rules, and the PNG and
CSV artifacts (twin of ``multi_task_breast_cancer_tpu/train/inference.py``,
behaviour of the reference's ``src/utils/models.py:39-505``):

- binary segmentation with optional scipy hole filling (``:84-87``);
- multitask binary / multiclass with the PR module (``:273-397``):
  (a) threshold postprocessing zeroes tiny masks (``:322-323``),
  (b) ``overlap_seg_based_on_class``: predicted normal ⇒ empty mask, on the
      FIRST classification head's argmax only (``:325-332``),
  (c) ``overlap_class_based_on_seg``: an empty RAW mask ⇒ class normal
      (``:367-386``);
- per-image metric CSVs and mask / feature-map PNGs named as the
  reference names them; binary classification writes ``results.csv``.

The test split runs as one batched forward (``Engine.predict``), whose NCHW
outputs come to the host once per split and are viewed NHWC there; the
per-image loops run on the host, as in JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd
import torch

from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.ops.image_ops import (
    count_pixels,
    fill_holes as fill_holes_fn,
    postprocess_binary_segmentation,
    postprocess_semantic_segmentation,
)
from multi_task_breast_cancer_tpu_torch.ops.metrics import (
    calculate_metrics,
    calculate_metrics_multiclass_segmentation,
)

SEG_RESULT_COLUMNS = ["patient_id", "Haussdorf distance", "DICE", "Sensitivity",
                      "Specificity", "Accuracy", "Jaccard index", "Precision", "class"]


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def to_host(out):
    """An output tree of device tensors → numpy, NCHW viewed as NHWC (one
    device-to-host copy per tensor)."""
    if isinstance(out, (tuple, list)):
        return type(out)(to_host(o) for o in out)
    arr = out.detach().float().cpu().numpy() if torch.is_tensor(out) else np.asarray(out)
    return arr.transpose(0, 2, 3, 1) if arr.ndim == 4 else arr


def save_binary_segmentation(seg: np.ndarray, path: str, value_non_zero: int = 255) -> None:
    """PNG mask artifact (``models.py:508-527``)."""
    import cv2
    seg = np.asarray(seg)
    while seg.ndim > 2:
        seg = seg[..., 0] if seg.shape[-1] in (1,) else seg[0]
    seg = seg.astype(int).copy()
    seg[seg > 0] = value_non_zero
    cv2.imwrite(path, seg.astype(np.uint8))


def save_features_map(seg: np.ndarray, path: str) -> None:
    """Per-head feature-map PNG (``models.py:555-558``), scaled to 0-255 so
    it is viewable, as the JAX package writes it (the reference writes raw
    floats, which clip to black)."""
    import cv2
    seg = np.asarray(seg, dtype=np.float32)
    while seg.ndim > 2:
        seg = seg[..., 0] if seg.shape[-1] in (1,) else seg[0]
    lo, hi = float(seg.min()), float(seg.max())
    scaled = (seg - lo) / max(hi - lo, 1e-12) * 255.0
    cv2.imwrite(path, scaled.astype(np.uint8))


def _save_head_maps(heads, final, is_ds: bool, i: int, path: str, label: str,
                    pid: int, *, sigmoid_ds: bool) -> None:
    """Feature-map PNGs of sample ``i``, one per deep-supervision head.
    ``sigmoid_ds`` keeps the reference's own asymmetry: its binary
    segmentation saves ``sigmoid(ds)`` (``utils/models.py:74``), its
    multiclass and multitask paths raw logits (``:138,219,312``)."""
    if is_ds:
        for n, ds_head in enumerate(reversed(heads)):
            save_features_map(_sigmoid(ds_head[i]) if sigmoid_ds else ds_head[i],
                              f"{path}/features_map/{label}_{pid}_ds_{n}.png")
    else:
        save_features_map(final[i], f"{path}/features_map/{label}_{pid}_seg.png")


def _forward_seg(engine, state, test_ds: ArrayDataset, pad_to=None):
    """One batched forward, brought to the host: (cls outputs or None, seg
    outputs), NHWC numpy."""
    out = to_host(engine.predict(state, test_ds.images, pad_to=pad_to))
    if engine.cfg.task == "multitask":
        cls_out, seg_out = out
    else:
        cls_out, seg_out = None, out
    return cls_out, seg_out


def _seg_heads(seg_out):
    return list(seg_out) if isinstance(seg_out, (tuple, list)) else seg_out


def _cls_logits(cls_out) -> np.ndarray:
    """Mean over deep-supervised cls heads (``models.py:327,361``)."""
    if isinstance(cls_out, (tuple, list)):
        return np.mean(np.stack(list(cls_out), 0), 0)
    return cls_out


def inference_binary_segmentation(engine, state, test_ds: ArrayDataset, path: str,
                                  fill_holes: bool = True, pad_to=None) -> pd.DataFrame:
    """``models.py:39-100``."""
    _, seg_out = _forward_seg(engine, state, test_ds, pad_to)
    heads = _seg_heads(seg_out)
    is_ds = isinstance(heads, list)
    final = heads[-1] if is_ds else heads

    rows = []
    for i in range(len(test_ds)):
        pid = int(test_ds.patient_ids[i])
        label = test_ds.class_names[i]
        _save_head_maps(heads, final, is_ds, i, path, label, pid, sigmoid_ds=True)
        seg = (_sigmoid(final[i, :, :, 0]) > 0.5).astype(np.uint8)
        gt = test_ds.masks[i, :, :, 0].astype(np.uint8)
        if fill_holes:
            seg = fill_holes_fn(seg)
        metrics = calculate_metrics(gt, seg, pid)
        metrics["class"] = label
        rows.append(metrics)
        save_binary_segmentation(seg, f"{path}/segs/{label}_{pid}_seg.png")

    results = pd.DataFrame(rows, columns=SEG_RESULT_COLUMNS)
    results.to_csv(f"{path}/results_segmentation.csv", index=False)
    return results


def inference_multitask_binary(engine, state, test_ds: ArrayDataset, path: str,
                               pad_to=None) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """``models.py:186-270`` (two classes, no PR)."""
    cls_out, seg_out = _forward_seg(engine, state, test_ds, pad_to)
    heads = _seg_heads(seg_out)
    is_ds = isinstance(heads, list)
    final = heads[-1] if is_ds else heads
    logits = _cls_logits(cls_out)

    rows = []
    for i in range(len(test_ds)):
        pid = int(test_ds.patient_ids[i])
        label = test_ds.class_names[i]
        _save_head_maps(heads, final, is_ds, i, path, label, pid, sigmoid_ds=False)
        seg = (_sigmoid(final[i, :, :, 0]) > 0.5).astype(np.uint8)
        metrics = calculate_metrics(test_ds.masks[i, :, :, 0].astype(np.uint8), seg, pid)
        metrics["class"] = label
        rows.append(metrics)
        save_binary_segmentation(seg, f"{path}/segs/{label}_{pid}_seg.png")

    results = pd.DataFrame(rows, columns=SEG_RESULT_COLUMNS)
    results.to_csv(f"{path}/results_segmentation.csv", index=False)

    metrics_df = pd.DataFrame({
        "patient_id": test_ds.patient_ids,
        "ground_truth": test_ds.labels.astype(float),
        "predicted_label": (_sigmoid(logits[:, 0]) > 0.5).astype(float),
    })
    metrics_df.to_csv(f"{path}/results_classification.csv", index=False)
    return results, metrics_df


def inference_multitask_multiclass(engine, state, test_ds: ArrayDataset, path: str,
                                   threshold: int = 0,
                                   overlap_seg_based_on_class: bool = False,
                                   overlap_class_based_on_seg: bool = False,
                                   pad_to=None) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """``models.py:273-397``: the full PR module."""
    cls_out, seg_out = _forward_seg(engine, state, test_ds, pad_to)
    heads = _seg_heads(seg_out)
    is_ds = isinstance(heads, list)
    final = heads[-1] if is_ds else heads
    logits = _cls_logits(cls_out)
    argmax_class = np.argmax(logits, axis=-1)
    # rule (b) argmaxes the FIRST cls head: the reference reassigns
    # features_map = features_map[-1] before the list check that would
    # average the heads (models.py:313,326-330); rule (c) and the predicted
    # label use the mean of the heads (models.py:361-364)
    first_head = cls_out[0] if isinstance(cls_out, (tuple, list)) else cls_out
    rule_b_class = np.argmax(first_head, axis=-1)
    # raw final-head masks, before (a) and (b): rule (c) reads these
    raw_masks = (_sigmoid(final[..., 0]) > 0.5).astype(np.uint8)

    rows = []
    for i in range(len(test_ds)):
        pid = int(test_ds.patient_ids[i])
        label = test_ds.class_names[i]
        _save_head_maps(heads, final, is_ds, i, path, label, pid, sigmoid_ds=False)
        seg = raw_masks[i].copy()
        if threshold > 0:
            seg = postprocess_binary_segmentation(seg, threshold)
        if overlap_seg_based_on_class and rule_b_class[i] == 2:
            seg[seg > 0] = 0
        metrics = calculate_metrics(test_ds.masks[i, :, :, 0].astype(np.uint8), seg, pid)
        metrics["class"] = label
        rows.append(metrics)
        save_binary_segmentation(seg, f"{path}/segs/{label}_{pid}_seg.png")

    results = pd.DataFrame(rows, columns=SEG_RESULT_COLUMNS)
    results.to_csv(f"{path}/results_segmentation.csv", index=False)

    pred_labels = []
    for i in range(len(test_ds)):
        tumor_pixels = count_pixels(raw_masks[i]).get(1, 0)
        if overlap_class_based_on_seg and tumor_pixels == 0:
            pred_labels.append(2)
        else:
            pred_labels.append(int(argmax_class[i]))

    metrics_df = pd.DataFrame({
        "patient_id": test_ds.patient_ids,
        "ground_truth": test_ds.labels.astype(int),
        "predicted_label": pred_labels,
    })
    # the prob_* columns hold the RAW mean cls outputs, not probabilities
    # (models.py:361-363 appends them before any normalisation)
    metrics_df[["prob_benign", "prob_malignant", "prob_normal"]] = logits
    metrics_df.to_csv(f"{path}/results_classification.csv", index=False)
    return results, metrics_df


def save_multilabel_segmentation(seg: np.ndarray, path: str) -> None:
    """Integer-label PNG (``models.py:530-552``)."""
    import cv2
    seg = np.asarray(seg)
    while seg.ndim > 2:
        seg = seg[..., 0] if seg.shape[-1] == 1 else seg[0]
    cv2.imwrite(path, seg.astype(np.uint8))


def inference_multilabel_segmentation(engine, state, test_ds: ArrayDataset,
                                      path: str, postprocessing: bool = False
                                      ) -> pd.DataFrame:
    """Semantic segmentation (``models.py:103-183``): argmax labels over the
    class channels (softmax first in the reference; the argmax is the same),
    per-region metrics, the majority tumor class as the predicted class, and
    optional majority relabelling."""
    _, seg_out = _forward_seg(engine, state, test_ds)
    heads = _seg_heads(seg_out)
    final = heads[-1] if isinstance(heads, list) else heads

    rows = []
    for i in range(len(test_ds)):
        pid = int(test_ds.patient_ids[i])
        label = test_ds.class_names[i]
        pred = np.argmax(final[i], axis=-1)
        gt = np.argmax(test_ds.masks[i], axis=-1)
        pred_pp = postprocess_semantic_segmentation(pred) if postprocessing else pred

        counter = count_pixels(pred)
        benign_pixels, malignant_pixels = counter.get(1, 0), counter.get(2, 0)
        predicted_class = "benign" if benign_pixels >= malignant_pixels else "malignant"

        metrics = calculate_metrics_multiclass_segmentation(gt, pred_pp, pid)
        metrics["class"] = label
        metrics["predicted_class"] = predicted_class
        rows.append(metrics)

        save_multilabel_segmentation(pred, f"{path}/segs/{label}_{pid}_seg.png")
        if postprocessing:
            save_multilabel_segmentation(
                pred_pp, f"{path}/segs/{label}_{pid}_seg_postprocessed.png")

    results = pd.DataFrame(rows)
    mapping_class = {"benign": 0, "malignant": 1}
    results["numerical_class"] = results["class"].map(mapping_class)
    results["numerical_class_predicted"] = results["predicted_class"].map(mapping_class)
    results.to_csv(f"{path}/results.csv", index=False)
    return results


def inference_multiclass_classification(engine, state, test_ds: ArrayDataset,
                                        path: str, pad_to=None) -> pd.DataFrame:
    """``models.py:400-456``."""
    logits = _cls_logits(to_host(engine.predict(state, test_ds.images, pad_to=pad_to)))
    metrics = pd.DataFrame({
        "patient_id": test_ds.patient_ids,
        "ground_truth": test_ds.labels.astype(int),
        "predicted_label": np.argmax(logits, axis=-1).astype(int),
    })
    metrics.to_csv(f"{path}/results_classification.csv", index=False)
    return metrics


def inference_binary_classification(engine, state, test_ds: ArrayDataset,
                                    path: str, pad_to=None) -> pd.DataFrame:
    """``models.py:459-505``; writes ``results.csv``, as the reference does
    (the multiclass variant writes ``results_classification.csv``)."""
    logits = _cls_logits(to_host(engine.predict(state, test_ds.images, pad_to=pad_to)))
    metrics = pd.DataFrame({
        "patient_id": test_ds.patient_ids,
        "ground_truth": test_ds.labels.astype(float),
        "predicted_label": (_sigmoid(logits[:, 0]) > 0.5).astype(float),
    })
    metrics.to_csv(f"{path}/results.csv", index=False)
    return metrics
