"""Image ops: intensity scaling, augment channels, postprocessing (twin of
``multi_task_breast_cancer_tpu/ops/image_ops.py``).

The host-side ops (cv2 / scipy, once per image at dataset build or test
time) are copies of the JAX module's; :func:`min_max_scaler` takes a tensor.
They mirror ``src/utils/images.py``, ``src/utils/custom_transforms.py`` and
the augment-channel construction of ``src/dataset/BUSI_dataset.py:110-139``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def count_pixels(segmentation: np.ndarray) -> Dict[int, int]:
    """``images.py:5-10``."""
    unique, counts = np.unique(segmentation, return_counts=True)
    return dict(zip(unique.tolist(), counts.tolist()))


def min_max_scaler(image: torch.Tensor) -> torch.Tensor:
    """``images.py:13-19``; safe on constant images."""
    lo, hi = image.min(), image.max()
    return (image - lo) / torch.clamp(hi - lo, min=1e-12)


def postprocess_binary_segmentation(segmentation: np.ndarray, threshold: int) -> np.ndarray:
    """Zero the mask when it has ≤ threshold tumor pixels (``images.py:41-55``)."""
    out = segmentation.copy()
    if count_pixels(segmentation).get(1, 0) <= threshold:
        out[out == 1] = 0
    return out


def postprocess_semantic_segmentation(segmentation: np.ndarray) -> np.ndarray:
    """Relabel the minority tumor class to the majority (``images.py:22-38``)."""
    out = segmentation.copy()
    counter = count_pixels(segmentation)
    benign, malignant = counter.get(1, 0), counter.get(2, 0)
    if benign >= malignant:
        out[out == 2] = 1
    else:
        out[out == 1] = 2
    return out


def fill_holes(mask: np.ndarray) -> np.ndarray:
    """scipy ``binary_fill_holes`` (reference ``models.py:84-87``), per test
    image on the host."""
    from scipy.ndimage import binary_fill_holes
    return binary_fill_holes(mask.astype(bool)).astype(int)


# ---------------------------------------------------------------------------
# Augment channels (deterministic per image, computed once at dataset build)
# ---------------------------------------------------------------------------


def sobel_magnitude(image_u8: np.ndarray) -> np.ndarray:
    """Sobel gradient magnitude normalised to 0-255 uint8
    (``custom_transforms.py:5-18``)."""
    import cv2
    sx = cv2.Sobel(image_u8, cv2.CV_64F, 1, 0, ksize=3)
    sy = cv2.Sobel(image_u8, cv2.CV_64F, 0, 1, ksize=3)
    mag = np.sqrt(sx ** 2 + sy ** 2)
    return cv2.normalize(mag, None, alpha=0, beta=255,
                         norm_type=cv2.NORM_MINMAX, dtype=cv2.CV_8U)


def clahe(image_u8: np.ndarray, clip_limit: float = 5.0, tile: int = 4) -> np.ndarray:
    """CLAHE channel (``BUSI_dataset.py:114-117``)."""
    import cv2
    return cv2.createCLAHE(clipLimit=clip_limit, tileGridSize=(tile, tile)).apply(image_u8)


def brightness_brighter(image_u8: np.ndarray, delta: int = 80) -> np.ndarray:
    """Saturating uint8 add (cv2.add semantics, ``BUSI_dataset.py:123-126``)."""
    return np.clip(image_u8.astype(np.int32) + delta, 0, 255).astype(np.uint8)


def brightness_darker(image_u8: np.ndarray, delta: int = 80) -> np.ndarray:
    """Saturating uint8 subtract (cv2.subtract, ``BUSI_dataset.py:127-130``)."""
    return np.clip(image_u8.astype(np.int32) - delta, 0, 255).astype(np.uint8)


def contrast_low(image_u8: np.ndarray, factor: float = 0.02) -> np.ndarray:
    """``BUSI_dataset.py:132-135``."""
    return (image_u8.astype(np.float64) * factor).astype(np.uint8)


def contrast_high(image_u8: np.ndarray, factor: float = 1.5) -> np.ndarray:
    """``BUSI_dataset.py:136-139``."""
    return np.clip(image_u8.astype(np.float64) * factor, 0, 255).astype(np.uint8)


AUGMENT_CHANNEL_FNS = {
    # the reference's stacking order (BUSI_dataset.py:110-139; low before high)
    "CLAHE": clahe,
    "SOBEL": sobel_magnitude,
    "brightness_brighter": brightness_brighter,
    "brightness_darker": brightness_darker,
    "contrast_low": contrast_low,
    "contrast_high": contrast_high,
}


def build_augment_channels(image_u8: np.ndarray, augmentations: Dict[str, bool]) -> np.ndarray:
    """The active augment channels of one uint8 image → (H, W, n_active)
    float32."""
    chans = [AUGMENT_CHANNEL_FNS[name](image_u8)
             for name in AUGMENT_CHANNEL_FNS
             if augmentations.get(name, False)]
    if not chans:
        return np.zeros(image_u8.shape + (0,), dtype=np.float32)
    return np.stack(chans, axis=-1).astype(np.float32)
