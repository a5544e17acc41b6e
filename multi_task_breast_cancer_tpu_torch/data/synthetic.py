"""Synthetic BUSI trees (copy of the generators of
``multi_task_breast_cancer_tpu/data/synthetic.py``): speckle images with
elliptic lesions and their masks, written with cv2 in the layouts of the raw
and the preprocessed BUSI datasets, so the driver runs end to end without
the real PNGs. The same seed gives the same files as the JAX package's
generators (``tests/test_torch_data.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import pandas as pd

CLASSES = ("benign", "malignant", "normal")


def _blob_image(rng: np.random.Generator, size: int, with_tumor: bool,
                bright_tumor: bool = False, learnable_style: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Speckle-noise image with an optional elliptic 'tumor' and its mask.
    ``learnable_style``: lower noise, larger lesions, strong contrast, and
    the class a function of the image (dark lesion benign, bright malignant,
    none normal)."""
    sigma = 25 if learnable_style else 40
    img = (rng.normal(120, sigma, (size, size))).clip(0, 255)
    mask = np.zeros((size, size), np.uint8)
    if with_tumor:
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        lo, hi = (size // 6, size // 3) if learnable_style else (size // 10, size // 4)
        ry, rx = rng.integers(lo, hi, 2)
        yy, xx = np.mgrid[0:size, 0:size]
        ellipse = ((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2 <= 1
        if learnable_style:
            img[ellipse] = 235 + img[ellipse] * 0.05 if bright_tumor \
                else img[ellipse] * 0.12
        elif bright_tumor:
            img[ellipse] = (img[ellipse] * 0.4 + 160).clip(0, 255)
        else:
            img[ellipse] = (img[ellipse] * 0.35)
        mask[ellipse] = 255
    return img.astype(np.uint8), mask


def _wobbly_ellipse(yy: np.ndarray, xx: np.ndarray, cy: int, cx: int,
                    ry: int, rx: int, amplitude: float, k: int,
                    phi0: float) -> np.ndarray:
    """An ellipse whose margin wobbles sinusoidally with the angle."""
    phi = np.arctan2(yy - cy, xx - cx)
    r_norm = np.sqrt(((yy - cy) / max(ry, 1)) ** 2
                     + ((xx - cx) / max(rx, 1)) ** 2)
    return r_norm <= 1.0 + amplitude * np.sin(k * phi + phi0)


def _hard_image(rng: np.random.Generator, size: int, cls: str,
                difficulty: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """The calibrated 'hard' image: speckle and depth attenuation, dark
    distractors outside the mask, and an overlapping class cue (margin
    spiculation and posterior shadowing for malignant)."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = rng.normal(120.0, 12.0 * difficulty, (size, size))
    img -= (yy / size) * rng.uniform(10, 35)
    for _ in range(int(rng.integers(2, 5))):
        cy, cx = rng.integers(0, size, 2)
        ry, rx = rng.integers(size // 16, size // 6, 2)
        d = ((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2 <= 1
        img[d] *= rng.uniform(0.6, 0.85)

    mask = np.zeros((size, size), np.uint8)
    if cls != "normal":
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        ry, rx = rng.integers(size // 10, size // 4, 2)
        if cls == "malignant":
            wobble_a = rng.uniform(0.18, 0.45)
            k = int(rng.integers(5, 10))
            shadowed = rng.random() < 0.70
            interior = rng.uniform(0.48, 0.68)
        else:
            wobble_a = rng.uniform(0.02, 0.15)
            k = int(rng.integers(3, 6))
            shadowed = rng.random() < 0.12
            interior = rng.uniform(0.56, 0.75)
        phi0 = rng.uniform(0, 2 * np.pi)
        lesion = _wobbly_ellipse(yy, xx, cy, cx, ry, rx, wobble_a, k, phi0)
        img[lesion] *= interior
        if shadowed:
            x0, x1 = max(cx - rx // 2, 0), min(cx + rx // 2 + 1, size)
            img[min(cy + ry, size - 1):, x0:x1] *= rng.uniform(0.6, 0.8)
        mask[lesion] = 255
    img *= rng.gamma(8.0 / difficulty, difficulty / 8.0, (size, size))
    return img.clip(0, 255).astype(np.uint8), mask


def _mapping_row(img_path, mask_path, cls: str, i: int, size: int, mask) -> dict:
    """One mapping.csv row with the preprocessing's bbox convention
    (max-exclusive bounds, zeros for an empty mask)."""
    ys, xs = np.nonzero(mask)
    return {
        "img_path": str(img_path), "mask_path": str(mask_path),
        "class": cls, "id": i, "dim1": size, "dim2": size,
        "tumor_pixels": int((mask == 255).sum()),
        "y_max": int(ys.max() + 1) if len(ys) else 0,
        "y_min": int(ys.min()) if len(ys) else 0,
        "x_max": int(xs.max() + 1) if len(xs) else 0,
        "x_min": int(xs.min()) if len(xs) else 0,
        "y_size": int(ys.max() + 1 - ys.min()) if len(ys) else 0,
        "x_size": int(xs.max() + 1 - xs.min()) if len(xs) else 0,
    }


def _write_tree(root: Path, per_class, draw) -> Path:
    import cv2
    root = Path(root)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "masks").mkdir(parents=True, exist_ok=True)
    rows = []
    for cls in CLASSES:
        for i in range(1, per_class(cls) + 1):
            img, mask = draw(cls)
            img_path = root / "images" / f"{cls}_id_{i}.png"
            mask_path = root / "masks" / f"{cls}_id_{i}_mask.png"
            cv2.imwrite(str(img_path), img)
            cv2.imwrite(str(mask_path), mask)
            rows.append(_mapping_row(img_path, mask_path, cls, i, img.shape[0], mask))
    pd.DataFrame(rows).to_csv(root / "mapping.csv", index=False)
    return root


def make_hard_busi(root, size: int = 128, seed: int = 0,
                   class_counts: Dict[str, int] | None = None,
                   difficulty: float = 1.0) -> Path:
    """Preprocessed-layout tree in the calibrated 'hard' style. The default
    counts are Curated BUSI's class totals (``README.md:44-47`` of the
    reference: 222 benign / 164 malignant / 64 normal = 450 images)."""
    counts = class_counts or {"benign": 222, "malignant": 164, "normal": 64}
    rng = np.random.default_rng(seed)
    return _write_tree(root, lambda cls: counts.get(cls, 0),
                       lambda cls: _hard_image(rng, size, cls, difficulty))


def make_raw_busi(root, n_per_class: int = 6, size: int = 64, seed: int = 0,
                  class_counts: Dict[str, int] | None = None) -> Path:
    """A raw ``Dataset_BUSI_with_GT``-style tree: per-class folders of
    ``cls (i).png`` + ``cls (i)_mask.png``; the first image of each tumor
    class also gets a ``_mask_1.png``, to exercise multi-mask merging.
    ``class_counts`` overrides ``n_per_class`` per class."""
    import cv2
    rng = np.random.default_rng(seed)
    root = Path(root)
    for cls in CLASSES:
        d = root / cls
        d.mkdir(parents=True, exist_ok=True)
        for i in range(1, (class_counts or {}).get(cls, n_per_class) + 1):
            img, mask = _blob_image(rng, size, with_tumor=(cls != "normal"))
            cv2.imwrite(str(d / f"{cls} ({i}).png"), img)
            cv2.imwrite(str(d / f"{cls} ({i})_mask.png"), mask)
            if i == 1 and cls != "normal":
                _, mask2 = _blob_image(rng, size, with_tumor=True)
                cv2.imwrite(str(d / f"{cls} ({i})_mask_1.png"), mask2)
    return root


def make_preprocessed_busi(root, n_per_class: int = 8, size: int = 128,
                           seed: int = 0, learnable: bool = False,
                           class_counts: Dict[str, int] | None = None) -> Path:
    """A preprocessed tree (``images/``, ``masks/``, ``mapping.csv``): the
    layout ``config.data.input_img`` points at. ``class_counts`` overrides
    ``n_per_class`` per class; ``learnable`` makes the class a function of
    the image."""
    rng = np.random.default_rng(seed)
    return _write_tree(
        root, lambda cls: (class_counts or {}).get(cls, n_per_class),
        lambda cls: _blob_image(rng, size, with_tumor=(cls != "normal"),
                                bright_tumor=(learnable and cls == "malignant"),
                                learnable_style=learnable))
