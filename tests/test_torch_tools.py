"""The port's command-line tools against the JAX package's, in-process on the
CPU: ``predict``, ``evaluate``, ``data/holdout_check``,
``data/preprocessing`` and the numpy host ops of ``native``.

``predict`` and ``evaluate`` read one checkpoint that the JAX package's
``save_checkpoint`` wrote (flax-msgpack), of the port's seeded MTnnUNet at
narrow widths. The JAX tools build their train state through
``create_train_state``, whose weights the checkpoint then replaces; the test
hands them a state of the right tree instead of compiling a JAX ``init``.

Tolerances: probabilities and logits to 1e-4 absolute, as
``tests/test_torch_models.py`` holds the forward (two frameworks' f32
convolutions; the logits of these random weights are ~0.03, so a tolerance
relative to their scale would ask for more than f32 gives); predicted
classes, result-CSV columns, ids and classes exactly; masks by the rule of ``tests/test_torch_driver.py``: at most
1 % of an image's pixels differ (they sit at the 0.5 threshold), and a
per-image Dice and tumor-pixel count move by no more than those pixels allow.
``holdout_check``'s output, ``preprocess_busi``'s files and the host ops:
exactly.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multi_task_breast_cancer_tpu import evaluate as jax_evaluate
from multi_task_breast_cancer_tpu import native as jax_native
from multi_task_breast_cancer_tpu import predict as jax_predict
from multi_task_breast_cancer_tpu.data import holdout_check as jax_holdout
from multi_task_breast_cancer_tpu.data import preprocessing as jax_pre
from multi_task_breast_cancer_tpu.data import synthetic as jax_synthetic
from multi_task_breast_cancer_tpu.train import checkpoint as jax_ckpt
from multi_task_breast_cancer_tpu.train import driver as jax_driver
from multi_task_breast_cancer_tpu.train.optim import init_optimizer as jax_optimizer
from multi_task_breast_cancer_tpu.train.state import TrainState as JaxTrainState
from multi_task_breast_cancer_tpu_torch import evaluate, native, predict
from multi_task_breast_cancer_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    config_to_yaml,
)
from multi_task_breast_cancer_tpu_torch.data import holdout_check, preprocessing
from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_to_jax
from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
from test_torch_driver import _check_seg_dice, one_torch_thread  # noqa: F401  (a fixture)

WIDTHS = [4, 8, 8, 16, 16]
SIZE = 32
TOL = 1e-4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A JAX-written checkpoint, the config, a folder of raw PNGs of another
    size, a UCLM-style preprocessed tree, and the JAX train state's tree."""
    root = tmp_path_factory.mktemp("tools")
    port = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                generator=torch.Generator().manual_seed(11))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict(), port))
    tx = jax_optimizer("Adam", 1e-3)
    state = JaxTrainState(params=params, batch_stats={}, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))
    ckpt = root / "model_fold_0"
    jax_ckpt.save_checkpoint(str(ckpt), state, epoch=3, val_loss=0.5)
    uclm = jax_synthetic.make_preprocessed_busi(root / "uclm", n_per_class=3, size=SIZE, seed=4)
    cfg = root / "config.yaml"
    cfg.write_text(config_to_yaml(Config(model=ModelConfig(architecture="MTnnUNet",
                                                           nnunet_widths=WIDTHS),
                                         data=DataConfig(input_img=str(uclm), batch_size=2))))
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        cv2.imwrite(str(images / f"case_{i}.png"), rng.integers(0, 256, (40, 36), dtype=np.uint8))
    return {"ckpt": ckpt, "cfg": cfg, "images": images, "uclm": uclm, "state": state}


def _jax_state(setup):
    return lambda model, tx, key, sample: setup["state"]


def _pixels_apart(a: Path, b: Path) -> int:
    pa, pb = cv2.imread(str(a), 0) > 0, cv2.imread(str(b), 0) > 0
    k = int((pa != pb).sum())
    assert k <= 0.01 * pa.size, (a.name, k)
    return k


def test_predict_matches_the_jax_cli(setup, tmp_path, monkeypatch):
    args = ["--config", str(setup["cfg"]), "--task", "multitask", "--checkpoint",
            str(setup["ckpt"]), "--images", str(setup["images"]), "--size", str(SIZE)]
    monkeypatch.setattr(jax_driver, "create_train_state", _jax_state(setup))
    monkeypatch.setattr(sys, "argv", ["predict"] + args + ["--output", str(tmp_path / "jax")])
    jax_predict.main()
    predict.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])

    want = json.loads((tmp_path / "jax" / "predictions.json").read_text())
    got = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["image"] == w["image"]
        assert g["predicted_class"] == w["predicted_class"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=TOL)
        seg = f"segs/{Path(g['image']).stem}_seg.png"
        k = _pixels_apart(tmp_path / "jax" / seg, tmp_path / "port" / seg)
        assert abs(g["tumor_pixels"] - w["tumor_pixels"]) <= k


def test_evaluate_matches_the_jax_cli(setup, tmp_path, monkeypatch):
    args = ["--config", str(setup["cfg"]), "--task", "multitask", "--checkpoint",
            str(setup["ckpt"]), "--data", str(setup["uclm"])]
    monkeypatch.setattr(jax_evaluate, "create_train_state", _jax_state(setup))
    monkeypatch.setattr(sys, "argv", ["evaluate"] + args + ["--output", str(tmp_path / "jax")])
    jax_evaluate.main()
    evaluate.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])

    fj, fp = tmp_path / "jax", tmp_path / "port"
    for sub in ("segs", "features_map"):
        assert sorted(p.name for p in (fp / sub).iterdir()) == \
            sorted(p.name for p in (fj / sub).iterdir())
    sj = pd.read_csv(fj / "results_segmentation.csv")
    sp = pd.read_csv(fp / "results_segmentation.csv")
    assert list(sj.columns) == list(sp.columns) and len(sp) == 9
    pd.testing.assert_series_equal(sj["patient_id"], sp["patient_id"])
    pd.testing.assert_series_equal(sj["class"], sp["class"])
    _check_seg_dice(setup["uclm"], fj, fp, sj, sp)
    cj, cp = pd.read_csv(fj / "results_classification.csv"), \
        pd.read_csv(fp / "results_classification.csv")
    assert list(cj.columns) == list(cp.columns)
    for col in ("patient_id", "ground_truth", "predicted_label"):
        pd.testing.assert_series_equal(cj[col], cp[col])
    for col in (c for c in cj.columns if c.startswith("prob_")):
        np.testing.assert_allclose(cp[col], cj[col], rtol=0, atol=TOL)


@pytest.mark.parametrize("mode", ["CV", "CV_PROD", "holdout"])
def test_holdout_check_prints_what_the_jax_cli_prints(tmp_path, monkeypatch, capsys, mode):
    counts = {"benign": 14, "malignant": 10, "normal": 8}
    mapping = tmp_path / "mapping.csv"
    pd.DataFrame([{"class": c, "id": i} for c, n in counts.items()
                  for i in range(1, n + 1)]).to_csv(mapping, index=False)
    args = ["--mapping", str(mapping), "--seed", "7", "--folds", "3", "--mode", mode]
    monkeypatch.setattr(sys, "argv", ["holdout_check"] + args)
    jax_holdout.main()
    want = capsys.readouterr().out
    holdout_check.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) >= 4


@pytest.mark.parametrize("curated", [False, True])
def test_preprocessing_writes_the_jax_tools_files(tmp_path, curated):
    """Both tools on one raw tree (multi-mask ids included), resized from
    40² to 32²: every PNG byte for byte and ``mapping.csv`` with the output
    roots swapped."""
    raw = jax_synthetic.make_raw_busi(tmp_path / "raw", n_per_class=4, size=40, seed=1)
    csv = None
    if curated:
        csv = tmp_path / "curated.csv"
        csv.write_text("class;id\nbenign;1\nbenign;3\nmalignant;2\nnormal;4\n")
    jax_pre.preprocess_busi(raw, tmp_path / "jax", csv, (SIZE, SIZE))
    argv = ["--input", str(raw), "--output", str(tmp_path / "port"), "--size", str(SIZE)]
    preprocessing.main(argv + (["--curated-csv", str(csv)] if curated else [])
                       + ["--device", "cpu"])
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == (8 if curated else 24)
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert (tmp_path / "port" / "mapping.csv").read_text() == \
        (tmp_path / "jax" / "mapping.csv").read_text().replace(str(tmp_path / "jax"),
                                                               str(tmp_path / "port"))


def _host_op_cases():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    mask = np.zeros((20, 24), np.uint8)
    mask[3:9, 5:17] = 255
    return [
        ("nearest_resize", (img, 32, 29)), ("nearest_resize", (img, 128, 96)),
        ("add_saturate", (img, img[::-1])), ("binarize", (img,)), ("binarize", (img, 200)),
        ("mask_stats", (mask,)), ("mask_stats", (np.zeros((8, 8), np.uint8),)),
        ("u8_to_f32", (img,)), ("u8_to_f32", (img, True)),
        ("u8_to_f32", (np.full((4, 4), 9, np.uint8), True)),
    ]


@pytest.mark.parametrize("name,args", _host_op_cases())
def test_host_ops_equal_the_jax_fallbacks(monkeypatch, name, args):
    """The port's numpy ops against ``native.py``'s numpy fallbacks (the
    native library kept out) and against whatever path ``native.py`` takes
    here, the C++ one when it builds."""
    got = getattr(native, name)(*args)
    default = getattr(jax_native, name)(*args)
    monkeypatch.setattr(jax_native, "_load", lambda: None)
    fallback = getattr(jax_native, name)(*args)
    for want in (fallback, default):
        if isinstance(want, dict):
            assert got == want
        else:
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("module,argv", [
    (predict, ["--checkpoint", "c", "--images", "i"]),
    (evaluate, ["--checkpoint", "c", "--data", "d"]),
    (holdout_check, ["--mapping", "m"]),
    (preprocessing, ["--input", "i", "--output", "o"]),
])
def test_tools_need_a_gpu_unless_told(monkeypatch, tmp_path, module, argv):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not any(tmp_path.iterdir())
