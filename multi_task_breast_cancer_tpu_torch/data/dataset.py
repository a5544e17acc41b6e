"""In-memory array dataset (twin of the ``ArrayDataset`` of
``multi_task_breast_cancer_tpu/data/dataset.py``).

A fold of Curated BUSI is ~450 grayscale 128×128 images, so it lives whole in
host numpy and goes to the device once per fold (``Engine.device_data``).
Arrays keep the JAX package's NHWC layout; the Engine transposes them to NCHW
once, on upload. Building a dataset from PNGs on disk
(``build_array_dataset``) belongs to the driver slice (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


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
