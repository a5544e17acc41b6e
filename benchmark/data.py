"""Inputs made from the seed: synthetic BUSI-like scans, a training fold
with the cell's class counts, seeded weights on the device, and arrival
schedules. The same seed gives the same inputs, and every seed gives the
same sizes.

The image generator is a frozen copy of the repository's calibrated "hard"
synthetic scan (speckle, depth attenuation, dark distractors, wobbly
lesions with posterior shadowing), so that the traffic cannot move with
the program.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

CLASSES = ("benign", "malignant", "normal")
LABELS = {"benign": 0, "malignant": 1, "normal": 2}


def _wobbly_ellipse(yy, xx, cy, cx, ry, rx, amplitude, k, phi0) -> np.ndarray:
    phi = np.arctan2(yy - cy, xx - cx)
    r = np.sqrt(((yy - cy) / max(ry, 1)) ** 2 + ((xx - cx) / max(rx, 1)) ** 2)
    return r <= 1.0 + amplitude * np.sin(k * phi + phi0)


def hard_image(rng: np.random.Generator, size: int, cls: str) -> Tuple[np.ndarray, np.ndarray]:
    """One grayscale uint8 scan and its 0/1 lesion mask (empty for normal)."""
    yy, xx = np.mgrid[0:size, 0:size]
    img = rng.normal(120.0, 12.0, (size, size))
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
            wobble, k = rng.uniform(0.18, 0.45), int(rng.integers(5, 10))
            shadowed, interior = rng.random() < 0.70, rng.uniform(0.48, 0.68)
        else:
            wobble, k = rng.uniform(0.02, 0.15), int(rng.integers(3, 6))
            shadowed, interior = rng.random() < 0.12, rng.uniform(0.56, 0.75)
        lesion = _wobbly_ellipse(yy, xx, cy, cx, ry, rx, wobble, k, rng.uniform(0, 2 * np.pi))
        img[lesion] *= interior
        if shadowed:
            x0, x1 = max(cx - rx // 2, 0), min(cx + rx // 2 + 1, size)
            img[min(cy + ry, size - 1):, x0:x1] *= rng.uniform(0.6, 0.8)
        mask[lesion] = 1
    img *= rng.gamma(8.0, 1.0 / 8.0, (size, size))
    return img.clip(0, 255).astype(np.uint8), mask


def scans(rng: np.random.Generator, counts: Dict[str, int], size: int):
    """``counts[cls]`` scans of each class, in class order: (images (N, S, S)
    uint8, masks (N, S, S) uint8 0/1, labels (N,) int32)."""
    images, masks, labels = [], [], []
    for cls in CLASSES:
        for _ in range(int(counts.get(cls, 0))):
            img, mask = hard_image(rng, size, cls)
            images.append(img)
            masks.append(mask)
            labels.append(LABELS[cls])
    return np.stack(images), np.stack(masks), np.asarray(labels, np.int32)


def training_fold(seed: int, fold: dict, size: int):
    """A fold as the repository's 4-fold driver builds it, with the cell's
    counts: ``fold["train"][cls]`` distinct scans each repeated
    ``fold["oversampling"][cls]`` times (the driver's deterministic
    oversampling), and ``fold["val"][cls]`` validation scans. Returns
    ``(train, val, base)``: (images, masks, labels) each, and for every
    train row the index of its distinct scan."""
    rng = np.random.default_rng(seed)
    ti, tm, tl = scans(rng, fold["train"], size)
    vi, vm, vl = scans(rng, fold["val"], size)
    reps = np.concatenate([np.full(int(fold["train"][c]), int(fold["oversampling"][c]))
                           for c in CLASSES if int(fold["train"].get(c, 0))])
    base = np.repeat(np.arange(len(tl)), reps)
    return (ti[base], tm[base], tl[base]), (vi, vm, vl), base


def distinct_rows(perm: np.ndarray, base: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` rows of ``perm`` whose scans all differ."""
    seen, rows = set(), []
    for r in perm:
        if int(base[r]) not in seen:
            seen.add(int(base[r]))
            rows.append(int(r))
            if len(rows) == n:
                return np.asarray(rows, np.int64)
    raise ValueError(f"the fold has fewer than {n} distinct scans")


def seeded_state(torch, named_shapes, seed: int, device) -> dict:
    """A state dict for ``named_shapes`` (name → shape) drawn on ``device``
    from ``seed`` in one call: each weight of two or more dimensions normal
    with a He scale over its fan-in (the elements of one output slice); a
    relative-position bias normal at 0.02; a norm's ``scale`` one; every
    other vector a small normal (0.01), so that no bias starts at zero."""
    names = list(named_shapes)
    sizes = [int(math.prod(named_shapes[n])) for n in names]
    stds = []
    for name in names:
        shape = named_shapes[name]
        if name.endswith("rel_pos_bias"):
            stds.append(0.02)
        elif len(shape) >= 2:
            stds.append(math.sqrt(2.0 * shape[0] / math.prod(shape)))
        else:
            stds.append(0.0 if name.endswith(".scale") else 0.01)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    flat *= torch.repeat_interleave(torch.tensor(stds, device=device),
                                    torch.tensor(sizes, device=device))
    out = {}
    for name, part in zip(names, flat.split(sizes)):
        part = part.view(named_shapes[name])
        out[name] = part + 1.0 if name.endswith(".scale") else part
    return out


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the start) of an open-loop Poisson stream of
    ``rate``·``seconds`` requests: the gaps are the exponential law's
    quantiles at evenly spaced levels, in an order drawn from ``seed``, so
    every seed offers the same gaps and the same count."""
    n = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    order = np.random.default_rng(seed).permutation(n)
    return np.cumsum(gaps[order]) - gaps[order][0]
