"""Dataset loading dispatcher (twin of
``multi_task_breast_cancer_tpu/data/loader.py``): the reference's
``load_datasets(config_training, config_data, transforms, mode)``
(``src/dataset/BUSI_dataloader.py:343-377``), returning per-fold
:class:`ArrayDataset` bundles read from a preprocessed BUSI tree
(``mapping.csv``, ``images/``, ``masks/``).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import List, Optional

import pandas as pd

from multi_task_breast_cancer_tpu_torch.config import DataConfig, TrainingConfig
from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset, build_array_dataset
from multi_task_breast_cancer_tpu_torch.data.splits import holdout_split, stratified_cv_splits


@dataclasses.dataclass
class FoldData:
    train: ArrayDataset
    test: ArrayDataset
    val: Optional[ArrayDataset] = None  # absent in CV_PROD mode


def _read_mapping(path_images, classes: Optional[List[str]] = None) -> pd.DataFrame:
    """Read ``mapping.csv``; filter classes only when ``classes`` is given.
    The CV modes leave the filter to :func:`stratified_cv_splits`, so the
    ``use_duplicated_to_train`` complement sees the full mapping first
    (reference order, ``BUSI_dataloader.py:95-100``)."""
    path_images = Path(path_images).resolve()
    if not path_images.exists():
        raise FileNotFoundError(f"Path '{path_images}' it doesn't exist")
    logging.info("Images are contained in the following path: %s", path_images)
    mapping = pd.read_csv(path_images / "mapping.csv")
    if classes is not None:
        mapping = mapping[mapping["class"].isin(classes)]
    return mapping


def load_datasets(config_training: TrainingConfig, config_data: DataConfig,
                  mode: str = "CV", uclm_path: Optional[str] = None) -> List[FoldData]:
    """Per-fold datasets. ``mode``: 'CV' (train/val/test), 'CV_PROD'
    (train = train ∪ val, test) or 'UCLM' (an external set, one fold)."""
    classes = list(config_data.classes)
    aug = config_data.augmentation.as_dict()
    semantic = config_data.semantic_segmentation

    if mode == "UCLM":
        mapping = _read_mapping(uclm_path or config_data.input_img, classes)
        ds = build_array_dataset(mapping, aug, None, semantic)
        return [FoldData(train=ds, test=ds)]

    mapping = _read_mapping(config_data.input_img)
    merge_val = mode == "CV_PROD"
    # the reference dispatcher never forwards use_duplicated_to_train to the
    # CV_PROD loader (BUSI_dataloader.py:358-369): the flag is CV-only
    use_dup = config_data.use_duplicated_to_train and not merge_val
    folds = stratified_cv_splits(
        mapping, seed=config_training.seed, n_folds=config_training.CV,
        train_size=config_data.train_size,
        remove_outliers=config_data.remove_outliers,
        use_duplicated_to_train=use_dup,
        oversampling=config_data.oversampling, merge_val=merge_val,
        classes=classes)

    out = []
    for n, fold in enumerate(folds):
        if n == 0:
            dist = fold["train"]["class"].value_counts(normalize=True)
            logging.info("Class distribution for train set (fold 0):\n%s", dist)
        out.append(FoldData(
            train=build_array_dataset(fold["train"], aug, None, semantic),
            val=(build_array_dataset(fold["val"], aug, None, semantic)
                 if "val" in fold else None),
            test=build_array_dataset(fold["test"], aug, None, semantic),
        ))
        logging.info("Fold %d sizes: train=%d%s test=%d", n, len(out[-1].train),
                     f" val={len(out[-1].val)}" if out[-1].val is not None else "",
                     len(out[-1].test))
    return out


def load_holdout(config_training: TrainingConfig, config_data: DataConfig) -> FoldData:
    """One 80/10/10 stratified holdout (the reference's ``BUSI_dataloader``)."""
    mapping = _read_mapping(config_data.input_img, list(config_data.classes))
    split = holdout_split(mapping, seed=config_training.seed,
                          train_size=config_data.train_size,
                          remove_outliers=config_data.remove_outliers,
                          oversampling=config_data.oversampling)
    aug = config_data.augmentation.as_dict()
    semantic = config_data.semantic_segmentation
    return FoldData(train=build_array_dataset(split["train"], aug, None, semantic),
                    val=build_array_dataset(split["val"], aug, None, semantic),
                    test=build_array_dataset(split["test"], aug, None, semantic))
