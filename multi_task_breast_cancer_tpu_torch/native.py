"""Host image ops of the data path, in numpy (twin of
``multi_task_breast_cancer_tpu/native.py``).

The JAX package runs these through a C++ library (``native/mtbc_native.cpp``)
and keeps a numpy fallback for each, documented bit-identical to the C++ and
to cv2. The port keeps the fallbacks only and loads no native library: the
work is a few passes over 128² uint8 planes beside PNG decoding.
"""

from __future__ import annotations

import numpy as np

MASK_STAT_KEYS = ("tumor_pixels", "y_max", "y_min", "x_max", "x_min", "y_size", "x_size")


def nearest_resize(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.INTER_NEAREST-semantics resize of a (H, W) uint8 image: index =
    int(y * (sh/dh)) with the scale computed first as a double ((y*sh)/dh
    rounds differently for sizes that are not powers of two)."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw = src.shape
    ys = np.minimum((np.arange(dh, dtype=np.float64) * (sh / dh)).astype(np.int64), sh - 1)
    xs = np.minimum((np.arange(dw, dtype=np.float64) * (sw / dw)).astype(np.int64), sw - 1)
    return src[np.ix_(ys, xs)]


def add_saturate(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Saturating uint8 add (cv2.add): merges the masks of one image."""
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    return np.clip(a.astype(np.int32) + b.astype(np.int32), 0, 255).astype(np.uint8)


def binarize(m: np.ndarray, thresh: int = 128) -> np.ndarray:
    return (np.ascontiguousarray(m, np.uint8) >= thresh).astype(np.uint8)


def mask_stats(mask: np.ndarray) -> dict:
    """{tumor_pixels, y_max, y_min, x_max, x_min, y_size, x_size} of the
    nonzero pixels (maxima exclusive); all zero for an empty mask."""
    ys, xs = np.nonzero(np.ascontiguousarray(mask, np.uint8))
    if len(ys) == 0:
        return dict.fromkeys(MASK_STAT_KEYS, 0)
    vals = [int(len(ys)), int(ys.max() + 1), int(ys.min()), int(xs.max() + 1), int(xs.min()),
            int(ys.max() + 1 - ys.min()), int(xs.max() + 1 - xs.min())]
    return dict(zip(MASK_STAT_KEYS, vals))


def u8_to_f32(src: np.ndarray, normalize: bool = False) -> np.ndarray:
    """uint8 → float32; ``normalize`` maps [min, max] to [0, 1] by one float32
    reciprocal multiply (zero for a constant image), as the C++ kernel does."""
    src = np.ascontiguousarray(src, np.uint8)
    out = src.astype(np.float32)
    if normalize:
        lo, hi = int(src.min()), int(src.max())
        scale = np.float32(1.0) / np.float32(hi - lo) if hi > lo else np.float32(0.0)
        out = (out - np.float32(lo)) * scale
    return out
