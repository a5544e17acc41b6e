"""SSIM duplicate recognition, the curation step that built Curated BUSI
(twin of ``multi_task_breast_cancer_tpu/data/ssim.py``; the reference only
describes it, README.md:29-37: 330 duplicated BUSI images, 5 quadruplets,
22 triplets, 122 duplets).

- Wang et al.'s SSIM with an 11×11 Gaussian window (σ 1.5, L 255), 'valid'
  windows;
- the per-image windowed statistics (μ and E[x²]−μ²) are computed once for
  all N images; per pair only the cross term E[xy] is filtered, for chunks of
  pairs at a time, so the O(N²/2) sweep is a few large batched convolutions
  on the device (``F.conv2d`` with the one window, the JAX package's
  ``lax.conv_general_dilated``), not a host double loop;
- union-find joins the pairs at or above the threshold into groups;
- :func:`curate_dataset` keeps one image (the lowest id) per group and writes
  a ``class;id`` CSV like ``mapping_curated_BUSI.csv``.

    python -m multi_task_breast_cancer_tpu_torch.data.ssim \\
        --input ./data/Dataset_BUSI_with_GT --output ./data/mapping_curated_generated.csv

The sweep runs on ``cuda`` unless ``device="cpu"`` is passed, in float32 (TF32
off).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.device import resolve_device, set_float32_policy

_WIN = 11
_SIGMA = 1.5
_L = 255.0
_C1 = (0.01 * _L) ** 2
_C2 = (0.03 * _L) ** 2


def _gaussian_kernel(win: int = _WIN, sigma: float = _SIGMA) -> np.ndarray:
    half = (win - 1) / 2.0
    coords = np.arange(win) - half
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'Valid' windowed filtering of (B, H, W) with a (1, 1, k, k) kernel."""
    return F.conv2d(x[:, None], kernel)[:, 0]


def _pair_ssim(img_a, img_b, mu_a, mu_b, var_a, var_b, kernel) -> torch.Tensor:
    """Mean SSIM of aligned pair batches (P, H, W) → (P,)."""
    cov = _filter2(img_a * img_b, kernel) - mu_a * mu_b
    num = (2 * mu_a * mu_b + _C1) * (2 * cov + _C2)
    den = (mu_a ** 2 + mu_b ** 2 + _C1) * (var_a + var_b + _C2)
    return (num / den).mean(dim=(1, 2))


def ssim_pairwise(images: np.ndarray, pairs: np.ndarray, chunk: int = 512,
                  device=None) -> np.ndarray:
    """Mean SSIM of every (i, j) row of ``pairs`` over (N, H, W) images in
    [0, 255], on ``device`` (``cuda`` unless ``"cpu"``)."""
    device = resolve_device(device)
    set_float32_policy(device, "float32")
    kernel = torch.from_numpy(_gaussian_kernel())[None, None].to(device)
    imgs = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    with torch.inference_mode():
        mu = _filter2(imgs, kernel)
        var = _filter2(imgs * imgs, kernel) - mu * mu
        idx = torch.from_numpy(np.asarray(pairs, np.int64).reshape(-1, 2)).to(device)
        vals = [_pair_ssim(imgs[ia], imgs[ib], mu[ia], mu[ib], var[ia], var[ib], kernel)
                for ia, ib in (idx[s:s + chunk].T for s in range(0, len(idx), chunk))]
        out = torch.cat(vals) if vals else torch.empty(0, device=device)
    return out.cpu().numpy()


def ssim(img_a: np.ndarray, img_b: np.ndarray, device=None) -> float:
    """One pair's SSIM."""
    images = np.stack([img_a, img_b]).astype(np.float32)
    return float(ssim_pairwise(images, np.array([[0, 1]]), device=device)[0])


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, a: int) -> int:
        while self.parent[a] != a:
            self.parent[a] = self.parent[self.parent[a]]
            a = self.parent[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


@dataclasses.dataclass
class DuplicateReport:
    groups: List[List[int]]          # index groups of size ≥ 2
    ssim_matrix_pairs: np.ndarray    # (n_pairs, 3): i, j, ssim

    @property
    def n_duplicated_images(self) -> int:
        return sum(len(g) for g in self.groups)

    def group_size_histogram(self) -> Dict[int, int]:
        hist: Dict[int, int] = {}
        for g in self.groups:
            hist[len(g)] = hist.get(len(g), 0) + 1
        return hist


def find_duplicates(images: np.ndarray, threshold: float = 0.9, chunk: int = 512,
                    device=None) -> DuplicateReport:
    """SSIM of all pairs of (N, H, W) images; pairs at or above ``threshold``
    are joined into duplicate groups (duplets, triplets, …), largest first."""
    n = images.shape[0]
    ii, jj = np.triu_indices(n, k=1)
    pairs = np.stack([ii, jj], axis=1)
    vals = ssim_pairwise(images, pairs, chunk=chunk, device=device)

    uf = _UnionFind(n)
    for i, j in pairs[vals >= threshold]:
        uf.union(int(i), int(j))
    clusters: Dict[int, List[int]] = {}
    for i in range(n):
        clusters.setdefault(uf.find(i), []).append(i)
    groups = sorted((g for g in clusters.values() if len(g) > 1), key=lambda g: (-len(g), g[0]))
    trip = np.concatenate([pairs, vals[:, None]], axis=1)
    return DuplicateReport(groups=groups, ssim_matrix_pairs=trip)


def curate_dataset(class_images: Dict[str, Tuple[np.ndarray, Sequence[int]]],
                   threshold: float = 0.9, output_csv: str | Path | None = None,
                   device=None):
    """Per-class duplicate sweep keeping one image (the lowest id) per group;
    returns (the curated 'class;id' DataFrame, the report per class). This
    regenerates a ``mapping_curated_BUSI.csv``-style file from a raw BUSI
    tree (README.md:40-47 of the reference)."""
    import pandas as pd

    rows = []
    reports = {}
    for cls, (imgs, ids) in class_images.items():
        ids = list(ids)
        report = find_duplicates(imgs, threshold=threshold, device=device)
        reports[cls] = report
        drop = set()
        for g in report.groups:
            keep = min(g, key=lambda ix: ids[ix])
            drop.update(ix for ix in g if ix != keep)
        for ix, id_ in enumerate(ids):
            if ix not in drop:
                rows.append({"class": cls, "id": id_})
        logging.info("ssim-curate[%s]: %d images, %d duplicate groups %s, kept %d",
                     cls, len(ids), len(report.groups),
                     report.group_size_histogram(), len(ids) - len(drop))
    df = pd.DataFrame(rows)
    if output_csv is not None:
        df.to_csv(output_csv, sep=";", index=False)
    return df, reports


def main(argv=None) -> None:
    """CLI: sweep a raw BUSI tree and write the curated-id CSV."""
    import argparse

    import cv2

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", default="./data/Dataset_BUSI_with_GT")
    parser.add_argument("--output", default="./data/mapping_curated_generated.csv")
    parser.add_argument("--threshold", type=float, default=0.9)
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    class_images = {}
    for cls in ("benign", "malignant", "normal"):
        folder = Path(args.input) / cls
        imgs, ids = [], []
        for f in sorted(folder.glob("*.png")):
            if "mask" in f.stem:
                continue
            raw = f.stem.split(" ")[-1].replace("(", "").replace(")", "")
            img = cv2.imread(str(f), 0)
            imgs.append(cv2.resize(img, (args.size, args.size), interpolation=cv2.INTER_NEAREST))
            ids.append(int(raw))
        if imgs:
            class_images[cls] = (np.stack(imgs).astype(np.float32), ids)
    curate_dataset(class_images, threshold=args.threshold, output_csv=args.output, device=device)


if __name__ == "__main__":
    main()
