"""Evolution plots of a fold's ``metrics.csv`` (twin of ``plot_evolution``
in ``multi_task_breast_cancer_tpu/utils/visualization.py``, the reference's
``visualization.py:63-89``).

The JAX package draws them with seaborn; the port's machine has neither
seaborn nor matplotlib, so the port draws the same line plot with cv2: one
line per column against the epoch, grid, title, axis labels and a legend,
at the reference figure's 1600×800 pixels.
"""

from __future__ import annotations

import colorsys

import numpy as np
import pandas as pd

WIDTH, HEIGHT = 1600, 800
_LEFT, _RIGHT, _TOP, _BOTTOM = 110, 40, 70, 90


def _colors(n: int):
    """``n`` evenly spaced hues (a husl-like palette), as BGR."""
    out = []
    for k in range(n):
        r, g, b = colorsys.hls_to_rgb(k / max(n, 1), 0.45, 0.75)
        out.append((int(b * 255), int(g * 255), int(r * 255)))
    return out


def plot_evolution(df: pd.DataFrame, columns, path: str,
                   title: str = "Metric evolution", ylabel: str = "value",
                   xlabel: str = "Epoch") -> None:
    """Line plot of per-epoch metric columns, written as a PNG to ``path``."""
    import cv2

    columns = list(columns)
    x = df["epoch"].to_numpy(np.float64)
    ys = [df[c].to_numpy(np.float64) for c in columns]
    finite = np.concatenate([y[np.isfinite(y)] for y in ys] + [np.zeros(0)])
    lo, hi = (float(finite.min()), float(finite.max())) if finite.size else (0.0, 1.0)
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5
    x_lo, x_hi = (float(x.min()), float(x.max())) if x.size else (0.0, 1.0)
    if x_hi - x_lo < 1e-12:
        x_lo, x_hi = x_lo - 0.5, x_hi + 0.5
    w, h = WIDTH - _LEFT - _RIGHT, HEIGHT - _TOP - _BOTTOM

    def px(xv, yv):
        return (int(round(_LEFT + (xv - x_lo) / (x_hi - x_lo) * w)),
                int(round(_TOP + (hi - yv) / (hi - lo) * h)))

    img = np.full((HEIGHT, WIDTH, 3), 255, np.uint8)
    font = cv2.FONT_HERSHEY_SIMPLEX
    for k in range(6):  # grid and tick labels
        yv = lo + (hi - lo) * k / 5
        _, py = px(x_lo, yv)
        cv2.line(img, (_LEFT, py), (_LEFT + w, py), (225, 225, 225), 1)
        cv2.putText(img, f"{yv:.3g}", (10, py + 5), font, 0.5, (60, 60, 60), 1, cv2.LINE_AA)
        xv = x_lo + (x_hi - x_lo) * k / 5
        pxx, _ = px(xv, lo)
        cv2.line(img, (pxx, _TOP), (pxx, _TOP + h), (225, 225, 225), 1)
        cv2.putText(img, f"{xv:.3g}", (pxx - 10, _TOP + h + 22), font, 0.5, (60, 60, 60), 1,
                    cv2.LINE_AA)
    cv2.rectangle(img, (_LEFT, _TOP), (_LEFT + w, _TOP + h), (80, 80, 80), 1)
    for c, (name, y) in zip(_colors(len(columns)), zip(columns, ys)):
        ok = np.isfinite(y)
        pts = np.array([px(a, b) for a, b in zip(x[ok], y[ok])], np.int32)
        if len(pts) > 1:
            cv2.polylines(img, [pts], False, c, 2, cv2.LINE_AA)
        for p in pts:
            cv2.circle(img, tuple(int(v) for v in p), 3, c, -1, cv2.LINE_AA)
    cv2.rectangle(img, (_LEFT + w - 230, _TOP + 5), (_LEFT + w - 5, _TOP + 12 + 24 * len(columns)),
                  (255, 255, 255), -1)
    for k, (c, name) in enumerate(zip(_colors(len(columns)), columns)):
        y0 = _TOP + 20 + 24 * k
        cv2.line(img, (_LEFT + w - 220, y0), (_LEFT + w - 180, y0), c, 3)
        cv2.putText(img, str(name), (_LEFT + w - 170, y0 + 5), font, 0.55, (30, 30, 30), 1,
                    cv2.LINE_AA)
    cv2.putText(img, title, (_LEFT, 40), font, 0.9, (20, 20, 20), 2, cv2.LINE_AA)
    cv2.putText(img, xlabel, (_LEFT + w // 2 - 30, HEIGHT - 25), font, 0.7, (20, 20, 20), 1,
                cv2.LINE_AA)
    cv2.putText(img, ylabel, (10, _TOP - 15), font, 0.7, (20, 20, 20), 1, cv2.LINE_AA)
    if not cv2.imwrite(path, img):
        raise OSError(f"plot_evolution: could not write {path}")
