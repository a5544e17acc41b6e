"""In-memory array dataset (twin of
``multi_task_breast_cancer_tpu/data/dataset.py``).

A fold of Curated BUSI is ~450 grayscale 128×128 images, so it lives whole in
host numpy and goes to the device once per fold (``Engine.device_data``).
Arrays keep the JAX package's NHWC float32 layout; the Engine transposes them
to NCHW once, on upload.

:func:`build_array_dataset` reads a ``mapping.csv`` frame's PNGs with the
reference's rules (``src/dataset/BUSI_dataset.py``): grayscale load, mask
255 → 1, label maps malignant 1 / benign 0 / normal 2 (semantic mode: benign
1 / normal 0 / malignant 2), and the augment channels stacked onto the image
once here instead of per epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from multi_task_breast_cancer_tpu_torch.ops.image_ops import build_augment_channels

LABEL_MAP = {"malignant": 1, "benign": 0, "normal": 2}
LABEL_MAP_SEMANTIC = {"benign": 1, "normal": 0, "malignant": 2}


@dataclasses.dataclass
class ArrayDataset:
    """One split's worth of arrays + host metadata."""

    images: np.ndarray        # (N, H, W, 1+n_aug) float32, raw 0..255 scale
    masks: np.ndarray         # (N, H, W, 1) float32 {0,1} (or (N,H,W,3) semantic)
    labels: np.ndarray        # (N,) int32
    patient_ids: np.ndarray   # (N,) int64
    class_names: List[str]    # per-sample class strings
    tumor_pixels: np.ndarray  # (N,) int64

    def __len__(self) -> int:
        return int(self.images.shape[0])

    @property
    def n_channels(self) -> int:
        return int(self.images.shape[-1])


def _imread(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, 0)
    if img is None:
        raise FileNotFoundError(path)
    return img


def build_array_dataset(mapping: pd.DataFrame,
                        augmentations: Optional[Dict[str, bool]] = None,
                        normalization: Optional[str] = None,
                        semantic_segmentation: bool = False) -> ArrayDataset:
    """Eager-load a mapping frame's images and masks into NHWC float32
    arrays."""
    augmentations = augmentations or {}
    images, masks, labels, pids, classes, tumor = [], [], [], [], [], []

    label_map = LABEL_MAP_SEMANTIC if semantic_segmentation else LABEL_MAP
    for _, row in mapping.iterrows():
        img_u8 = _imread(row["img_path"])
        cls = row["class"]
        if cls not in label_map:
            raise ValueError(f"Unknown class: {cls}")
        if semantic_segmentation:
            # class-conditional one-hot (H, W, 3): channel label_map[cls] is
            # the tumor mask, channel 0 its complement (the JAX module says
            # why the reference's own semantic path never builds this)
            bin_mask = _imread(row["mask_path"]).astype(np.int64)
            bin_mask[bin_mask == 255] = 1
            mask = np.eye(3, dtype=np.float32)[bin_mask * label_map[cls]]
        else:
            mask = _imread(row["mask_path"]).astype(np.float32)
            mask[mask == 255] = 1
            mask = mask[..., None]

        img = img_u8.astype(np.float32)[..., None]
        if normalization is not None:
            # unreachable through the config, as in the reference
            # (BUSI_dataloader.py:352,366,375); the base channel only
            lo, hi = img.min(), img.max()
            img = (img - lo) / max(hi - lo, 1e-12)
        if any(augmentations.values()) and not semantic_segmentation:
            img = np.concatenate([img, build_augment_channels(img_u8, augmentations)],
                                 axis=-1)

        images.append(img)
        masks.append(mask)
        labels.append(label_map[cls])
        pids.append(int(row["id"]))
        classes.append(cls)
        tumor.append(int(row.get("tumor_pixels", 0)))

    return ArrayDataset(
        images=np.stack(images).astype(np.float32),
        masks=np.stack(masks).astype(np.float32),
        labels=np.asarray(labels, np.int32),
        patient_ids=np.asarray(pids, np.int64),
        class_names=classes,
        tumor_pixels=np.asarray(tumor, np.int64),
    )
