"""The port's test-phase inference (``train/inference.py``) against the JAX
package's, fed the same model outputs through a stub engine: NHWC numpy on
the JAX side, NCHW tensors on the port's, as each ``Engine.predict`` returns
them. The CSVs and every PNG (masks, feature maps) must be equal byte for
byte, with the Prediction-Refinement rules (a) threshold, (b) class from the
FIRST head, (c) class from the raw mask, deep supervision and single heads.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.train import inference as JI
from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.train import inference as PI

N, S = 6, 16


def _test_ds(semantic: bool = False) -> ArrayDataset:
    rng = np.random.default_rng(0)
    labels = np.array([0, 1, 2, 0, 1, 2], np.int32)
    masks = (rng.random((N, S, S, 1)) > 0.6).astype(np.float32)
    masks[2] = 0.0  # a 'normal' image: empty mask
    if semantic:
        masks = np.eye(3, dtype=np.float32)[(masks[..., 0] * (labels[:, None, None] % 2 + 1)).astype(int)]
    return ArrayDataset(images=rng.integers(0, 256, (N, S, S, 1)).astype(np.float32), masks=masks,
                        labels=labels, patient_ids=np.arange(10, 10 + N),
                        class_names=["benign", "malignant", "normal"] * 2,
                        tumor_pixels=np.zeros(N, np.int64))


def _outputs(task: str, regions: int, n_classes: int, ds: bool, cls_heads: int, seed: int):
    """A model output tree, NHWC numpy. Sample 1 gets an empty final mask
    (rule c) and sample 3 a tiny one (rule a); the two cls heads disagree
    on sample 0 (rule b reads the first)."""
    rng = np.random.default_rng(seed)
    heads = [rng.normal(0, 2, (N, S, S, regions)).astype(np.float32) for _ in range(4 if ds else 1)]
    heads[-1][1] = -5.0
    heads[-1][3] = -5.0
    heads[-1][3, :2, 0] = 5.0
    seg = tuple(heads) if ds else heads[0]
    n_out = 1 if n_classes == 2 else n_classes
    cls = [rng.normal(0, 1, (N, n_out)).astype(np.float32) for _ in range(cls_heads)]
    if n_out == 3 and cls_heads == 2:
        cls[0][0] = [0.0, 0.0, 9.0]
        cls[1][0] = [0.0, 0.0, -20.0]
    if task == "multitask":
        return tuple(cls), seg
    if task == "classification":
        return cls[0]
    return seg


def _nchw(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_nchw(t) for t in tree)
    t = torch.from_numpy(tree.copy())
    return t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t


def _engine(task: str, out, port: bool):
    def predict(state, images, pad_to=None, **kw):
        assert len(images) == N
        return _nchw(out) if port else out
    return types.SimpleNamespace(cfg=types.SimpleNamespace(task=task), predict=predict)


def _run(tmp_path, fn: str, task: str, out, semantic: bool = False, **kw):
    """Run the JAX and the port's function on the same outputs; return the
    two frames and the two artifact trees as {relative path: bytes}."""
    trees, frames = [], []
    for name, mod, port in (("jax", JI, False), ("port", PI, True)):
        d = tmp_path / name
        for sub in ("segs", "features_map"):
            (d / sub).mkdir(parents=True, exist_ok=True)
        res = getattr(mod, fn)(_engine(task, out, port), None, _test_ds(semantic), str(d), **kw)
        frames.append(res)
        trees.append({str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
                      if p.is_file()})
    return frames, trees


def _same(frames, trees) -> int:
    (jf, pf), (jt, pt) = frames, trees
    assert sorted(jt) == sorted(pt)
    for rel in jt:
        assert jt[rel] == pt[rel], rel
    for a, b in zip(jf if isinstance(jf, tuple) else (jf,), pf if isinstance(pf, tuple) else (pf,)):
        assert a.equals(b)
    return len(jt)


@pytest.mark.parametrize("ds,cls_heads,threshold,rule_b,rule_c", [
    (True, 1, 0, True, True),
    (True, 2, 0, True, True),      # rule (b) reads the FIRST of two cls heads
    (True, 2, 10, True, False),    # rule (a) zeroes the tiny mask
    (False, 1, 3, False, True),    # single seg head
    (True, 1, 0, False, False),
])
def test_multitask_multiclass_matches_jax(tmp_path, ds, cls_heads, threshold, rule_b, rule_c):
    out = _outputs("multitask", 1, 3, ds, cls_heads, seed=cls_heads + threshold)
    frames, trees = _run(tmp_path, "inference_multitask_multiclass", "multitask", out,
                         threshold=threshold, overlap_seg_based_on_class=rule_b,
                         overlap_class_based_on_seg=rule_c, pad_to=8)
    assert _same(frames, trees) >= N + 2
    seg_res, cls_res = frames[1]
    assert list(cls_res.columns)[-3:] == ["prob_benign", "prob_malignant", "prob_normal"]
    assert (cls_res.predicted_label.iloc[1] == 2) == rule_c      # empty raw mask
    if cls_heads == 2 and rule_b:
        assert seg_res.DICE.iloc[0] == 0.0   # first head said normal: mask emptied


@pytest.mark.parametrize("ds", [True, False])
def test_multitask_binary_matches_jax(tmp_path, ds):
    out = _outputs("multitask", 1, 2, ds, 1, seed=3)
    _same(*_run(tmp_path, "inference_multitask_binary", "multitask", out))


@pytest.mark.parametrize("ds,fill", [(True, True), (False, True), (True, False)])
def test_binary_segmentation_matches_jax(tmp_path, ds, fill):
    """Feature maps of the deep-supervision heads through sigmoid (the
    reference's asymmetry), hole filling, the per-image CSV."""
    out = _outputs("segmentation", 1, 3, ds, 1, seed=4)
    assert _same(*_run(tmp_path, "inference_binary_segmentation", "segmentation", out,
                       fill_holes=fill)) >= N + 1


@pytest.mark.parametrize("postprocessing", [False, True])
def test_multilabel_segmentation_matches_jax(tmp_path, postprocessing):
    out = _outputs("segmentation", 3, 3, True, 1, seed=5)
    _same(*_run(tmp_path, "inference_multilabel_segmentation", "segmentation", out,
                semantic=True, postprocessing=postprocessing))


@pytest.mark.parametrize("fn,n_classes", [("inference_multiclass_classification", 3),
                                          ("inference_binary_classification", 2)])
def test_classification_matches_jax(tmp_path, fn, n_classes):
    """Binary classification writes ``results.csv`` (the reference's file
    name), multiclass ``results_classification.csv``."""
    out = _outputs("classification", 1, n_classes, False, 1, seed=6)
    frames, trees = _run(tmp_path, fn, "classification", out)
    _same(frames, trees)
    assert ("results.csv" in trees[1]) == (n_classes == 2)


def test_to_host_views_nchw_as_nhwc():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    (cls,), seg = PI.to_host(((x[:, :, 0, 0],), (x, x)))
    assert cls.shape == (2, 3) and seg[0].shape == (2, 4, 5, 3)
    np.testing.assert_array_equal(seg[1], x.numpy().transpose(0, 2, 3, 1))
