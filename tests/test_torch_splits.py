"""The port's splits, oversampling and classification metrics against the
JAX package's, which call sklearn.

The port runs where sklearn is not installed, so it carries numpy twins of
``StratifiedKFold(shuffle=True)`` and the stratified ``train_test_split``.
A splitter that is only "stratified and seeded" would put other patients in
each fold; these tests hold fold membership and row order to sklearn's,
element for element (index, columns and values of every frame). The
classification metrics must give sklearn's keys, in sklearn's order, and its
values (NaN where sklearn gives NaN).
"""

from __future__ import annotations

import math

import numpy as np
import pandas as pd
import pytest
from sklearn.model_selection import StratifiedKFold

from multi_task_breast_cancer_tpu.data import splits as jax_splits
from multi_task_breast_cancer_tpu.ops import metrics as jax_metrics
from multi_task_breast_cancer_tpu_torch.data import splits
from multi_task_breast_cancer_tpu_torch.ops import metrics

BALANCED = {"benign": 30, "malignant": 30, "normal": 30}
BUSI = {"benign": 222, "malignant": 164, "normal": 64}  # Curated BUSI's class counts


def _mapping(counts, seed: int = 0) -> pd.DataFrame:
    """A mapping.csv frame, ids 1..n per class (so the curated case lists
    hit), rows shuffled so class order is not sorted."""
    rows = [{"img_path": f"images/{c}_id_{i}.png", "mask_path": f"masks/{c}_id_{i}_mask.png",
             "class": c, "id": i, "tumor_pixels": i % 7}
            for c, n in counts.items() for i in range(1, n + 1)]
    df = pd.DataFrame(rows)
    return df.iloc[np.random.default_rng(seed).permutation(len(df))].reset_index(drop=True)


def _same_outcome(run_jax, run_port):
    """Both raise ValueError, or both return equal plans (frames equal,
    index and order included)."""
    try:
        want = run_jax()
    except ValueError:
        with pytest.raises(ValueError):
            run_port()
        return 0
    got = run_port()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            pd.testing.assert_frame_equal(g[k], w[k])
    return 1


OPTIONS = [
    {},
    {"remove_outliers": True},
    {"use_duplicated_to_train": True},
    {"merge_val": True},
    {"oversampling": False},
    {"classes": ["benign", "malignant"]},
    {"use_duplicated_to_train": True, "classes": ["benign", "malignant"]},
]


@pytest.mark.parametrize("counts", [BALANCED, BUSI], ids=["balanced", "busi"])
@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(o) or "default")
def test_stratified_cv_splits_match_sklearn(counts, options):
    mapping = _mapping(counts)
    compared = 0
    for seed in (1, 1993):
        for n_folds, train_size in ((2, 0.8), (4, 0.6), (7, 0.9), (10, 0.75)):
            kw = dict(seed=seed, n_folds=n_folds, train_size=train_size, **options)
            compared += _same_outcome(
                lambda: jax_splits.stratified_cv_splits(mapping, **kw),
                lambda: splits.stratified_cv_splits(mapping, **kw))
    assert compared >= 4


@pytest.mark.parametrize("counts", [BALANCED, BUSI, {"benign": 9, "malignant": 5, "normal": 3}],
                         ids=["balanced", "busi", "tiny"])
def test_kfold_and_train_test_split_indices_match_sklearn(counts):
    """The two splitters alone, on labels in shuffled order (sklearn numbers
    the classes by first occurrence for the folds, sorted for the inner
    split), every seed and size, including the ones sklearn refuses."""
    from sklearn.model_selection import train_test_split
    y = _mapping(counts, seed=3)["class"].to_numpy()
    for seed in (0, 7, 1993, 123456):
        for k in range(2, 11):
            try:
                want = [(a.tolist(), b.tolist())
                        for a, b in StratifiedKFold(k, shuffle=True, random_state=seed).split(y, y)]
            except ValueError:
                with pytest.raises(ValueError):
                    splits.stratified_kfold_split(y, k, seed)
                continue
            got = [(a.tolist(), b.tolist()) for a, b in splits.stratified_kfold_split(y, k, seed)]
            assert got == want, (seed, k)
        idx = np.arange(len(y))
        for kw in ({"train_size": 0.6}, {"train_size": 0.8}, {"train_size": 0.9}, {"test_size": 0.5}):
            try:
                want = train_test_split(idx, random_state=seed, shuffle=True, stratify=y, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    splits.stratified_train_test_indices(y, seed, **kw)
                continue
            got = splits.stratified_train_test_indices(y, seed, **kw)
            assert [g.tolist() for g in got] == [w.tolist() for w in want], (seed, kw)


@pytest.mark.parametrize("counts", [BALANCED, BUSI], ids=["balanced", "busi"])
@pytest.mark.parametrize("options", [{}, {"remove_outliers": True}, {"oversampling": False}],
                         ids=["default", "remove_outliers", "no_oversampling"])
def test_holdout_split_matches_sklearn(counts, options):
    mapping = _mapping(counts, seed=5)
    for seed in (0, 1993):
        for train_size in (0.6, 0.8, 0.9):
            kw = dict(seed=seed, train_size=train_size, **options)
            _same_outcome(lambda: [jax_splits.holdout_split(mapping, **kw)],
                          lambda: [splits.holdout_split(mapping, **kw)])


@pytest.mark.parametrize("counts,want", [
    (BUSI, {"benign": 444, "malignant": 492, "normal": 448}),          # factors 2, 3, 7
    ({"benign": 60, "malignant": 30, "normal": 10}, {"benign": 120, "malignant": 90, "normal": 100}),
    # majority class with factor 1 still gets one extra copy (reference quirk)
    ({"benign": 80, "malignant": 15, "normal": 5}, {"benign": 160, "malignant": 105, "normal": 100}),
])
def test_deterministic_oversampling_golden_factors(counts, want):
    mapping = _mapping(counts)
    got = splits.deterministic_oversampling(mapping)
    assert got["class"].value_counts().to_dict() == want
    pd.testing.assert_frame_equal(got, jax_splits.deterministic_oversampling(mapping))


def test_filters_and_legacy_oversampling_match_jax():
    mapping = _mapping(BUSI)
    for fn in ("filter_anomalous_cases", "filter_incongruent_cases"):
        pd.testing.assert_frame_equal(getattr(splits, fn)(mapping), getattr(jax_splits, fn)(mapping))
    for got, want in zip(splits.filter_train_cases(mapping), jax_splits.filter_train_cases(mapping)):
        pd.testing.assert_frame_equal(got, want)
    small = mapping[mapping["class"] != "malignant"].iloc[:150]
    pd.testing.assert_frame_equal(splits.oversampling_busi(small, 3),
                                  jax_splits.oversampling_busi(small, 3))


def _same_metrics(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert (math.isnan(g) and math.isnan(w)) or g == w, (k, g, w)


def _label_cases():
    rng = np.random.default_rng(0)
    cases = [
        (np.zeros(5, int), np.zeros(5, int)),          # one class, all right
        (np.zeros(4, int), np.ones(4, int)),           # one class, all wrong
        (np.array([2, 2, 2]), np.array([0, 1, 2])),    # only 'normal' in the truth
        (np.array([0, 1, 2, 1]), np.array([1, 1, 1, 1])),
    ]
    for _ in range(6):
        n = int(rng.integers(2, 40))
        cases.append((rng.integers(0, 3, n), rng.integers(0, 3, n)))
    return cases


@pytest.mark.parametrize("case", range(10))
def test_multiclass_classification_metrics_match_sklearn(case):
    y, p = _label_cases()[case]
    for truth, pred in ((y, p), (pd.Series(y.astype(float)), pd.Series(p))):
        _same_metrics(metrics.multiclass_classification_metrics(truth, pred),
                      jax_metrics.multiclass_classification_metrics(truth, pred))


@pytest.mark.parametrize("y,p", [
    ([0, 0, 0], [0, 0, 0]), ([1, 1], [1, 1]), ([0, 1], [1, 0]), ([1, 1, 1], [0, 0, 0]),
    ([0.0, 1.0, 1.0, 0.0, 1.0], [0.0, 1.0, 0.0, 0.0, 1.0]),
])
@pytest.mark.filterwarnings("ignore::RuntimeWarning")
def test_binary_classification_metrics_match_sklearn(y, p):
    _same_metrics(metrics.binary_classification_metrics(np.array(y), np.array(p)),
                  jax_metrics.binary_classification_metrics(np.array(y), np.array(p)))


def test_classification_metrics_refuse_what_sklearn_refuses():
    for fn in (metrics.binary_classification_metrics, metrics.multiclass_classification_metrics):
        with pytest.raises(ValueError):
            fn(np.array([], int), np.array([], int))
    with pytest.raises(ValueError):
        jax_metrics.binary_classification_metrics(np.array([2, 2]), np.array([2, 1]))
    with pytest.raises(ValueError):
        metrics.binary_classification_metrics(np.array([2, 2]), np.array([2, 1]))
