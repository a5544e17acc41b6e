"""Cross-validation splits, case filters and oversampling (twin of
``multi_task_breast_cancer_tpu/data/splits.py``).

The JAX package calls sklearn's ``StratifiedKFold`` and ``train_test_split``
so that fold membership under seed 1993 is the reference's
(``src/dataset/BUSI_dataloader.py:79-218``). The port runs where sklearn is
not installed, so it carries those two splitters in numpy, draw for draw:
the same ``RandomState`` calls in the same order give the same rows in the
same order (``tests/test_torch_splits.py`` holds them to sklearn). A splitter
that is merely "stratified and seeded" would put other patients in each fold
and silently change every fold metric of the paper's protocol.

The curated case lists are copies of the JAX module's data constants.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

ANOMALOUS_CASES: Dict[str, List[int]] = {
    "benign": [435, 433, 42, 131, 437, 269, 333, 399, 403, 406, 85, 164, 61, 94,
               108, 114, 116, 119, 122, 201, 302, 394, 402, 199, 248, 242, 288,
               236, 247, 233, 299, 4, 321, 25, 153],
    "malignant": [145, 51, 77, 78, 93, 94, 52, 106, 107, 18, 116],
    "normal": [34, 1],
}

INCONGRUENT_CASES: Dict[str, List[int]] = {
    "benign": [42, 131, 269, 333, 399, 406, 433, 437, 85, 164, 333],
    "malignant": [51, 52, 77, 78, 93, 94, 145, 51, 52],
    "normal": [1, 34],
}

TRAIN_ONLY_CASES: Dict[str, List[int]] = {
    "benign": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
               21, 25, 30, 33, 35, 37, 38, 44, 50, 51, 52, 58, 60, 62, 64, 65, 81,
               86, 96, 99, 105, 110, 127, 128, 129, 130, 132, 133, 134, 135, 136,
               138, 139, 140, 141, 150, 151, 152, 153, 154, 155, 156, 157, 158,
               163, 177, 197, 199, 200, 201, 202, 203, 204, 205, 206, 207, 208,
               209, 210, 211, 213, 214, 215, 216, 217, 218, 219, 220, 221, 222,
               223, 224, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 235,
               236, 237, 238, 239, 240, 241, 242, 244, 245, 246, 247, 248, 249,
               250, 251, 252, 253, 254, 255, 256, 257, 258, 259, 260, 261, 262,
               263, 264, 265, 266, 267, 268, 270, 271, 272, 273, 274, 275, 276,
               277, 278, 279, 280, 281, 282, 284, 285, 287, 288, 289, 290, 291,
               292, 293, 294, 295, 296, 297, 298, 299, 300, 301, 302, 303, 304,
               305, 306, 307, 308, 309, 310, 312, 316, 318, 319, 320, 321, 322,
               323, 324, 325, 326, 327, 328, 329, 330, 331, 332, 395, 396, 400,
               404, 411, 412, 413, 415, 419, 421, 422, 423, 424, 425, 426],
    "malignant": [4, 5, 7, 8, 9, 10, 12, 13, 14, 15, 17, 18, 34, 39, 42, 65, 66,
                  80, 81, 88, 92, 95, 96, 97, 98, 99, 106, 107, 109, 110, 111,
                  112, 114, 116, 118, 119, 123, 128, 129],
    "normal": [5, 13, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33,
               35, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53,
               54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 67, 68, 69, 81, 97, 98,
               104, 107, 119, 120, 121, 122, 123, 124, 125, 126, 127, 128, 129,
               130, 131, 132],
}


# ---------------------------------------------------------------------------
# sklearn's two splitters, in numpy
# ---------------------------------------------------------------------------


def stratified_kfold_test_folds(y, n_splits: int, seed: int) -> np.ndarray:
    """The fold number of every row: ``StratifiedKFold(n_splits,
    shuffle=True, random_state=seed)._make_test_folds``. Classes are numbered
    by first occurrence; fold k takes ``bincount(sorted(y)[k::n_splits])``
    rows of each class; one ``RandomState(seed).shuffle`` per class, in class
    order, deals the fold numbers to that class's rows."""
    y = np.asarray(y)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater "
                         f"than the number of samples: n_samples={len(y)}.")
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    encoded = class_perm[inverse.reshape(-1)]
    n_classes = len(first)
    counts = np.bincount(encoded)
    if np.all(n_splits > counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         f"members in each class.")
    ordered = np.sort(encoded)
    allocation = np.asarray([np.bincount(ordered[i::n_splits], minlength=n_classes)
                             for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[encoded == k] = folds_for_class
    return test_folds


def stratified_kfold_split(y, n_splits: int, seed: int):
    """``(train_index, test_index)`` per fold, each ascending, as
    ``StratifiedKFold.split`` yields them."""
    folds = stratified_kfold_test_folds(y, n_splits, seed)
    idx = np.arange(len(folds))
    return [(idx[folds != k], idx[folds == k]) for k in range(n_splits)]


def _shuffle_split_sizes(n: int, test_size, train_size) -> Tuple[int, int]:
    """``sklearn.model_selection._split._validate_shuffle_split`` for float
    or int sizes (a float test size rounds up, a float train size down)."""
    def kind(v):
        return None if v is None else ("f" if isinstance(v, float) else "i")

    if test_size is None and train_size is None:
        test_size = 0.25
    n_test = (math.ceil(test_size * n) if kind(test_size) == "f"
              else test_size)
    n_train = (math.floor(train_size * n) if kind(train_size) == "f"
               else train_size)
    if train_size is None:
        n_train = n - n_test
    elif test_size is None:
        n_test = n - n_train
    if n_train + n_test > n:
        raise ValueError(f"The sum of train_size and test_size = {n_train + n_test}, "
                         f"should be smaller than the number of samples {n}.")
    if n_train == 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size} and "
                         f"train_size={train_size}, the resulting train set will be empty.")
    return int(n_train), int(n_test)


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """``sklearn.utils._approximate_mode``: floor of the proportional share,
    the rest handed out by largest remainder, ties broken by ``rng.choice``
    (called for every remainder value it reaches, even when it takes all)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_indices(y, seed: int, train_size=None, test_size=None
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """``(train, test)`` row indices of ``train_test_split(...,
    random_state=seed, shuffle=True, stratify=y)``: the first split of
    ``StratifiedShuffleSplit._iter_indices``. Classes sorted as
    ``np.unique`` sorts them; per class one permutation of its rows; then the
    train and the test rows each permuted, all from one ``RandomState(seed)``."""
    y = np.asarray(y)
    n_train, n_test = _shuffle_split_sizes(len(y), test_size, train_size)
    classes, y_indices = np.unique(y, return_inverse=True)
    y_indices = y_indices.reshape(-1)
    class_counts = np.bincount(y_indices)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated class in y has only 1 member, which is "
                         "too few. The minimum number of groups for any class cannot "
                         "be less than 2.")
    if n_train < len(classes):
        raise ValueError(f"The train_size = {n_train} should be greater or equal to "
                         f"the number of classes = {len(classes)}")
    if n_test < len(classes):
        raise ValueError(f"The test_size = {n_test} should be greater or equal to "
                         f"the number of classes = {len(classes)}")
    class_indices = np.split(np.argsort(y_indices, kind="mergesort"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train: list = []
    test: list = []
    for i in range(len(classes)):
        permutation = rng.permutation(class_counts[i])
        rows = class_indices[i].take(permutation, mode="clip")
        train.extend(rows[:n_i[i]])
        test.extend(rows[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_train_test_split(df: pd.DataFrame, seed: int, train_size=None,
                                test_size=None) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """``train_test_split(df, train_size=…, test_size=…, random_state=seed,
    shuffle=True, stratify=df["class"])``."""
    train, test = stratified_train_test_indices(df["class"], seed, train_size, test_size)
    return df.iloc[train], df.iloc[test]


# ---------------------------------------------------------------------------
# filters, oversampling and the split plans (copies of the JAX module)
# ---------------------------------------------------------------------------


def filter_anomalous_cases(mapping: pd.DataFrame) -> pd.DataFrame:
    """Drop known outlier cases (``BUSI_dataloader.py:247-259``)."""
    logging.info("Filtering anomalous cases")
    for cls, ids in ANOMALOUS_CASES.items():
        mapping = mapping[~((mapping["class"] == cls) & (mapping["id"].isin(ids)))]
    return mapping


def filter_incongruent_cases(mapping: pd.DataFrame) -> pd.DataFrame:
    """Drop incongruent duplicates (``BUSI_dataloader.py:262-274``)."""
    logging.info("Filtering incongruent cases")
    out = mapping.copy()
    for cls, ids in INCONGRUENT_CASES.items():
        out = out[~((out["class"] == cls) & (out["id"].isin(ids)))]
    return out


def filter_train_cases(mapping: pd.DataFrame) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Split into (splittable, train-only complement): the complement holds
    cases with known duplicates, safe only for training
    (``BUSI_dataloader.py:277-303``)."""
    out = mapping.copy()
    for cls, ids in TRAIN_ONLY_CASES.items():
        out = out[~((out["class"] == cls) & (out["id"].isin(ids)))]
    complement = mapping.loc[~mapping.index.isin(out.index)]
    return out, complement


def deterministic_oversampling(mapping_df: pd.DataFrame) -> pd.DataFrame:
    """Per-class replication factor ``round(1/proportion)``; each class
    appended ``factor-1`` extra times, and the majority class (factor 1) once
    more through the else-branch, a reference quirk
    (``BUSI_dataloader.py:320-340``)."""
    proportions = mapping_df["class"].value_counts(normalize=True)
    scaling = {cls: int(round(1.0 / p, 0)) for cls, p in proportions.items()}

    extra = []
    for cls, factor in scaling.items():
        class_df = mapping_df[mapping_df["class"] == cls]
        if factor > 1:
            extra.append(pd.concat([class_df] * (factor - 1)))
        else:
            extra.append(class_df)
    return pd.concat([mapping_df] + extra, ignore_index=True)


def oversampling_busi(mapping_df: pd.DataFrame, seed: int) -> pd.DataFrame:
    """Legacy random oversampling to the benign class's size
    (``BUSI_dataloader.py:306-317``), latent API as in the reference, with
    its quirks: ``n_malignant > n_benign`` raises, and the malignant branch
    samples without replacement."""
    n_ben = len(mapping_df[mapping_df["class"] == "benign"])
    if "malignant" in set(mapping_df["class"]):
        n_mal = len(mapping_df[mapping_df["class"] == "malignant"])
        extra = mapping_df[mapping_df["class"] == "malignant"].sample(
            n=n_ben - n_mal, random_state=seed)
        mapping_df = pd.concat([mapping_df, extra])
    if "normal" in set(mapping_df["class"]):
        n_nor = len(mapping_df[mapping_df["class"] == "normal"])
        extra = mapping_df[mapping_df["class"] == "normal"].sample(
            n=n_ben - n_nor, random_state=seed, replace=True)
        mapping_df = pd.concat([mapping_df, extra])
    return mapping_df


def stratified_cv_splits(mapping: pd.DataFrame, seed: int, n_folds: int,
                         train_size: float = 0.8, remove_outliers: bool = False,
                         use_duplicated_to_train: bool = False,
                         oversampling: bool = True, merge_val: bool = False,
                         classes: Optional[List[str]] = None
                         ) -> List[Dict[str, pd.DataFrame]]:
    """Stratified k-fold plan with an inner train/val split
    (``BUSI_dataloader_CV`` ``:79-150``; ``_CV_prod`` ``:153-218`` with
    ``merge_val=True``). The class filter comes after the incongruent and
    train-only filters, in the reference's order, so the train-only
    complement may re-add out-of-class rows to every fold's train set."""
    complement = None
    if use_duplicated_to_train:
        mapping = filter_incongruent_cases(mapping)
        mapping, complement = filter_train_cases(mapping)
    if classes is not None:
        mapping = mapping[mapping["class"].isin(classes)]

    folds = []
    for n, (train_ix, test_ix) in enumerate(
            stratified_kfold_split(mapping["class"], n_folds, int(seed))):
        train_val, test = mapping.iloc[train_ix], mapping.iloc[test_ix].copy()
        test["fold"] = n
        train, val = stratified_train_test_split(train_val, int(seed), train_size=train_size)
        if remove_outliers:
            train = filter_anomalous_cases(train)
            val = filter_anomalous_cases(val)
            test = filter_anomalous_cases(test)
        if use_duplicated_to_train and complement is not None:
            train = pd.concat([train, complement])
        if oversampling:
            train = deterministic_oversampling(train)
        if merge_val:
            train = pd.concat([train, val])
            folds.append({"train": train, "test": test})
        else:
            folds.append({"train": train, "val": val, "test": test})
    return folds


def holdout_split(mapping: pd.DataFrame, seed: int, train_size: float = 0.8,
                  remove_outliers: bool = False, oversampling: bool = True
                  ) -> Dict[str, pd.DataFrame]:
    """80/10/10 stratified holdout (``BUSI_dataloader`` ``:17-76``)."""
    train, rest = stratified_train_test_split(mapping, int(seed), train_size=train_size)
    val, test = stratified_train_test_split(rest, int(seed), test_size=0.5)
    if remove_outliers:
        train = filter_anomalous_cases(train)
        val = filter_anomalous_cases(val)
        test = filter_anomalous_cases(test)
    if oversampling:
        malignant = train[train["class"] == "malignant"]
        train = pd.concat([train, malignant])
    return {"train": train, "val": val, "test": test}
