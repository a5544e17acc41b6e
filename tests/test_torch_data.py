"""Data from disk, port against the JAX package: the synthetic BUSI trees,
``build_array_dataset``, ``load_datasets`` (CV, CV_PROD, UCLM),
``load_holdout``, the host image ops and the server's ``prepare_image``.
Every array must be equal bit for bit, ids and classes equal."""

from __future__ import annotations

import dataclasses
import filecmp

import numpy as np
import pandas as pd
import pytest
import torch

from multi_task_breast_cancer_tpu.config import (
    DataConfig as JaxDataConfig,
    TrainingConfig as JaxTrainingConfig,
)
from multi_task_breast_cancer_tpu.data import dataset as jax_dataset
from multi_task_breast_cancer_tpu.data import loader as jax_loader
from multi_task_breast_cancer_tpu.data import synthetic as jax_synthetic
from multi_task_breast_cancer_tpu.ops import image_ops as jax_image_ops
from multi_task_breast_cancer_tpu.serve.server import prepare_image as jax_prepare_image
from multi_task_breast_cancer_tpu_torch.config import DataConfig, TrainingConfig
from multi_task_breast_cancer_tpu_torch.data import dataset, loader, synthetic
from multi_task_breast_cancer_tpu_torch.ops import image_ops
from multi_task_breast_cancer_tpu_torch.serve.server import prepare_image

ALL_AUG = {"CLAHE": True, "SOBEL": True, "brightness_brighter": True,
           "brightness_darker": True, "contrast_high": True, "contrast_low": True}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return jax_synthetic.make_preprocessed_busi(tmp_path_factory.mktemp("busi"), n_per_class=10,
                                                size=32, class_counts={"normal": 6})


def _same_dataset(got, want) -> None:
    for field in ("images", "masks", "labels", "patient_ids", "tumor_pixels"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.class_names == want.class_names


@pytest.mark.parametrize("maker,kw", [
    ("make_preprocessed_busi", {"n_per_class": 3, "size": 32, "seed": 4}),
    ("make_preprocessed_busi", {"size": 32, "learnable": True, "class_counts": {"benign": 4,
                                                                               "malignant": 2,
                                                                               "normal": 1}}),
    ("make_hard_busi", {"size": 32, "seed": 2, "class_counts": {"benign": 3, "malignant": 3,
                                                               "normal": 2}}),
    ("make_raw_busi", {"n_per_class": 2, "size": 32, "seed": 1}),
])
def test_synthetic_trees_equal_the_jax_generators(tmp_path, maker, kw):
    a = getattr(synthetic, maker)(tmp_path / "port", **kw)
    b = getattr(jax_synthetic, maker)(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    for rel in files:
        if rel.name == "mapping.csv":
            ma, mb = pd.read_csv(a / rel), pd.read_csv(b / rel)
            for col in ("img_path", "mask_path"):
                ma[col] = ma[col].str.replace(str(a), "", regex=False)
                mb[col] = mb[col].str.replace(str(b), "", regex=False)
            pd.testing.assert_frame_equal(ma, mb)
        else:
            assert filecmp.cmp(a / rel, b / rel, shallow=False), rel


@pytest.mark.parametrize("semantic,aug", [
    (False, {}), (False, ALL_AUG), (False, {"CLAHE": True, "contrast_low": True}),
    (True, {}), (True, ALL_AUG),  # semantic mode builds no augment channels, as in JAX
])
def test_build_array_dataset_matches_jax(tree, semantic, aug):
    mapping = pd.read_csv(tree / "mapping.csv")
    _same_dataset(dataset.build_array_dataset(mapping, aug, None, semantic),
                  jax_dataset.build_array_dataset(mapping, aug, None, semantic))
    assert dataset.LABEL_MAP == jax_dataset.LABEL_MAP
    assert dataset.LABEL_MAP_SEMANTIC == jax_dataset.LABEL_MAP_SEMANTIC


def _configs(tree, **data):
    kw = dict(input_img=str(tree), batch_size=2, train_size=0.8, **data)
    return ((TrainingConfig(seed=1993, CV=3), DataConfig(**kw)),
            (JaxTrainingConfig(seed=1993, CV=3), JaxDataConfig(**kw)))


@pytest.mark.parametrize("mode,data", [
    ("CV", {}),
    ("CV", {"oversampling": False, "classes": ["benign", "malignant"]}),
    ("CV", {"remove_outliers": True}),
    ("CV_PROD", {}),
    ("CV", {"semantic_segmentation": True}),
    ("UCLM", {"classes": ["benign", "normal"]}),
])
def test_load_datasets_matches_jax(tree, mode, data):
    (tc, dc), (jtc, jdc) = _configs(tree, **data)
    if data.get("semantic_segmentation"):
        # augment channels on, to show semantic mode leaves them out in both
        dc.augmentation.CLAHE = jdc.augmentation.CLAHE = True
    got = loader.load_datasets(tc, dc, mode=mode)
    want = jax_loader.load_datasets(jtc, jdc, mode=mode)
    assert len(got) == len(want) == (1 if mode == "UCLM" else 3)
    for g, w in zip(got, want):
        assert (g.val is None) == (w.val is None) == (mode != "CV")
        for split in ("train", "val", "test"):
            if getattr(w, split) is not None:
                _same_dataset(getattr(g, split), getattr(w, split))


def test_load_holdout_and_augment_channels_match_jax(tree):
    (tc, dc), (jtc, jdc) = _configs(tree)
    dc.augmentation.SOBEL = jdc.augmentation.SOBEL = True
    got, want = loader.load_holdout(tc, dc), jax_loader.load_holdout(jtc, jdc)
    for split in ("train", "val", "test"):
        _same_dataset(getattr(got, split), getattr(want, split))
    assert got.train.n_channels == 2


def test_image_ops_match_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 33), dtype=np.uint8)
    for name in image_ops.AUGMENT_CHANNEL_FNS:
        np.testing.assert_array_equal(image_ops.AUGMENT_CHANNEL_FNS[name](img),
                                      jax_image_ops.AUGMENT_CHANNEL_FNS[name](img), err_msg=name)
    assert list(image_ops.AUGMENT_CHANNEL_FNS) == list(jax_image_ops.AUGMENT_CHANNEL_FNS)
    for aug in ({}, ALL_AUG, {"SOBEL": True, "brightness_darker": True}):
        got, want = image_ops.build_augment_channels(img, aug), jax_image_ops.build_augment_channels(img, aug)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    mask = np.zeros((20, 20), np.uint8)
    mask[3:9, 3:9] = 1
    mask[5, 5] = 0                      # a hole
    small = np.zeros_like(mask)
    small[0, :3] = 1
    labels = rng.integers(0, 3, (20, 20))
    for seg in (mask, small, np.zeros_like(mask)):
        assert image_ops.count_pixels(seg) == jax_image_ops.count_pixels(seg)
        np.testing.assert_array_equal(image_ops.fill_holes(seg), jax_image_ops.fill_holes(seg))
        for threshold in (0, 3, 100):
            np.testing.assert_array_equal(
                image_ops.postprocess_binary_segmentation(seg, threshold),
                jax_image_ops.postprocess_binary_segmentation(seg, threshold))
    for lab in (labels, np.where(labels == 2, 1, labels), np.where(labels == 1, 2, labels)):
        np.testing.assert_array_equal(image_ops.postprocess_semantic_segmentation(lab),
                                      jax_image_ops.postprocess_semantic_segmentation(lab))
    assert image_ops.fill_holes(mask)[5, 5] == 1

    x = rng.normal(size=(3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(image_ops.min_max_scaler(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_image_ops.min_max_scaler(x)), rtol=0, atol=1e-6)
    const = torch.full((4, 4), 7.0)
    assert torch.equal(image_ops.min_max_scaler(const), torch.zeros(4, 4))


@pytest.mark.parametrize("shape,aug", [((32, 32), ALL_AUG), ((50, 41), {"CLAHE": True}),
                                       ((32, 32), {"SOBEL": False})])
def test_prepare_image_with_augment_channels_matches_jax(shape, aug):
    gray = np.random.default_rng(shape[1]).integers(0, 256, shape, dtype=np.uint8)
    got, want = prepare_image(gray, 32, aug), jax_prepare_image(gray, 32, aug)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.shape[-1] == 1 + sum(aug.values())


def test_fold_data_fields_match_jax():
    assert [f.name for f in dataclasses.fields(loader.FoldData)] == \
        [f.name for f in dataclasses.fields(jax_loader.FoldData)]
