"""BUSI raw-dataset preprocessing (twin of
``multi_task_breast_cancer_tpu/data/preprocessing.py``): walk
``Dataset_BUSI_with_GT``, merge multi-mask images, resize to 128×128
(nearest), optionally filter to the curated mapping, and write
``images/``, ``masks/`` and ``mapping.csv`` with dims / tumor pixels / bbox,
as the reference's ``src/dataset/Curated_BUSI_preprocessing.py:147-178``
does.

    python -m multi_task_breast_cancer_tpu_torch.data.preprocessing \\
        --input ./data/Dataset_BUSI_with_GT --output ./data/Curated_BUSI_128

Host work only: cv2 reads and writes the PNGs, :mod:`..native` resizes,
merges and measures. Like every tool of the port it runs where the port
runs, ``cuda`` unless ``--device cpu``, though it does no device work.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from multi_task_breast_cancer_tpu_torch import native
from multi_task_breast_cancer_tpu_torch.device import resolve_device

CLASS_NAMES = ["benign", "malignant", "normal"]
RESIZE_DIMENSIONS = (128, 128)


def _imread_gray(path: Path) -> np.ndarray:
    import cv2
    img = cv2.imread(str(path), 0)
    if img is None:
        raise FileNotFoundError(path)
    return img


def size_tumor(seg: np.ndarray) -> Tuple[int, int, int, int, int, int]:
    """Tumor bounding box (ymax, ymin, xmax, xmin, y_size, x_size); zeros when
    empty (``Curated_BUSI_preprocessing.py:45-51``)."""
    s = native.mask_stats(seg)
    return (s["y_max"], s["y_min"], s["x_max"], s["x_min"], s["y_size"], s["x_size"])


def _list_class_ids(class_path: Path) -> Tuple[List[str], Dict[str, int]]:
    """All image ids of a class folder and each id's mask count. BUSI names
    its files ``benign (7).png`` / ``benign (7)_mask.png`` /
    ``benign (7)_mask_1.png`` …"""
    ids, mask_counts = [], {}
    for f in sorted(class_path.glob("*.png")):
        stem = f.stem
        raw = stem.split(" ")[-1].split("_")[0].replace("(", "").replace(")", "")
        if "mask" in stem:
            mask_counts[raw] = mask_counts.get(raw, 0) + 1
        else:
            ids.append(raw)
    return ids, mask_counts


def preprocess_busi(input_folder: str | Path, output_folder: str | Path,
                    curated_csv: Optional[str | Path] = None,
                    resize: Tuple[int, int] = RESIZE_DIMENSIONS) -> pd.DataFrame:
    """The whole pass; returns (and writes) the mapping frame. ``resize`` is
    (width, height), as cv2's ``dsize``.

    - every ``_mask*.png`` of an id is merged by saturating addition;
    - image and merged mask are resized nearest-neighbour;
    - ``curated_csv`` (``class;id``, as ``mapping_curated_BUSI.csv``) keeps
      only the ids it lists.
    """
    import cv2

    input_path = Path(input_folder)
    output_path = Path(output_folder)
    (output_path / "images").mkdir(parents=True, exist_ok=True)
    (output_path / "masks").mkdir(parents=True, exist_ok=True)

    curated_ids: Dict[str, Optional[set]] = {cls: None for cls in CLASS_NAMES}
    if curated_csv is not None:
        curated = pd.read_csv(curated_csv, sep=";")
        for cls in CLASS_NAMES:
            curated_ids[cls] = set(curated[curated["class"] == cls]["id"].astype(int))

    rows = []
    for cls in CLASS_NAMES:
        class_path = input_path / cls
        if not class_path.exists():
            logging.warning("preprocess: class folder missing: %s", class_path)
            continue
        ids, mask_counts = _list_class_ids(class_path)
        for raw_id in sorted(set(ids), key=int):
            j = int(raw_id)
            if curated_ids[cls] is not None and j not in curated_ids[cls]:
                continue
            img_file = class_path / f"{cls} ({raw_id}).png"
            if not img_file.exists():
                continue
            img = _imread_gray(img_file)
            total_mask = _imread_gray(class_path / f"{cls} ({raw_id})_mask.png")
            for extra in range(1, mask_counts.get(raw_id, 1)):
                total_mask = native.add_saturate(total_mask, _imread_gray(
                    class_path / f"{cls} ({raw_id})_mask_{extra}.png"))

            img_r = native.nearest_resize(img, resize[1], resize[0])
            mask_r = native.nearest_resize(total_mask, resize[1], resize[0])

            img_out = output_path / "images" / f"{cls}_id_{raw_id}.png"
            mask_out = output_path / "masks" / f"{cls}_id_{raw_id}_mask.png"
            cv2.imwrite(str(img_out), img_r)
            cv2.imwrite(str(mask_out), mask_r)

            ymax, ymin, xmax, xmin, ys, xs = size_tumor(mask_r)
            rows.append({
                "img_path": str(img_out), "mask_path": str(mask_out),
                "class": cls, "id": j,
                "dim1": img_r.shape[0], "dim2": img_r.shape[1],
                "tumor_pixels": int(np.sum(mask_r == 255)),
                "y_max": ymax, "y_min": ymin, "x_max": xmax, "x_min": xmin,
                "y_size": ys, "x_size": xs,
            })

    mapping = pd.DataFrame(rows).sort_values(by=["class", "id"]).reset_index(drop=True)
    mapping.to_csv(output_path / "mapping.csv", index=False)
    logging.info("preprocess: %d images → %s", len(mapping), output_path)
    return mapping


def main(argv=None) -> pd.DataFrame:
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", default="./data/Dataset_BUSI_with_GT")
    parser.add_argument("--output", default="./data/Curated_BUSI_128")
    parser.add_argument("--curated-csv", default=None,
                        help="mapping_curated_BUSI.csv (class;id) to filter with")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    resolve_device(args.device)
    return preprocess_busi(args.input, args.output, args.curated_csv, (args.size, args.size))


if __name__ == "__main__":
    main()
