"""The port's experiment driver against the JAX driver, on one synthetic
BUSI tree and one config: narrow nnU-Net widths (4, 8, 8, 16, 16), 64²,
CV 2, 2 epochs, batch 2, oversampling on.

The JAX fold initialisation is carried into the port through the seam
``driver.fold_init_state_dict`` (``params_from_jax`` of the JAX fold key's
``init``), and augmentation is off in both drivers (each module's
``EngineConfig`` name is monkeypatched with ``use_transforms=False``): the
two frameworks' draws cannot match. The port runs on the CPU. Both drivers
call one jitted ``init`` per model (``_JitInit``, through the JAX driver's
``create_train_state``): run op by op, ``init`` compiled each op anew and
cost ~50 s of a case on one CPU.

Held equal: fold membership (the test ids of the result CSVs) and every
epoch's permutation; the metrics.csv header and its ``epoch`` / ``LR``
columns exactly; losses to 1e-3 relative (two frameworks' f32 sums over
two epochs of Adam; ``tests/test_torch_engine.py`` holds one epoch to
1e-4); accuracy / F1 / Dice to within the share of images whose prediction
flips (two images of the column's split, +5e-5 for the CSV's 4-decimal
rounding); the result CSVs' columns and patient ids exactly, at most one
test label flipped per fold, and per-image Dice within the bound that the
pixels whose mask label differs put on it (``_check_seg_dice``). The test
prints the flips it counted.
"""

from __future__ import annotations

import functools
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multi_task_breast_cancer_tpu.config import (
    Config as JaxConfig,
    DataConfig as JaxDataConfig,
    ModelConfig as JaxModelConfig,
    TrainingConfig as JaxTrainingConfig,
)
from multi_task_breast_cancer_tpu.data import synthetic as jax_synthetic
from multi_task_breast_cancer_tpu.train import driver as jax_driver
from multi_task_breast_cancer_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainingConfig,
)
from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax
from multi_task_breast_cancer_tpu_torch.train import driver

WIDTHS = [4, 8, 8, 16, 16]
SIZE = 64
LOSS_RTOL = 1e-3
ROUND = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's CPU runs. The gate runs six
    workers on eight cores, and torch's default of an OpenMP thread per core
    oversubscribed them: with five busy processes beside it, the MTnnUNet
    CV_PROD case took 400 s with the default threads and 120 s with one;
    alone it takes ~35 s either way."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return jax_synthetic.make_preprocessed_busi(tmp_path_factory.mktemp("busi"), n_per_class=8,
                                                size=SIZE, class_counts={"benign": 10})


def _configs(tree, arch: str):
    kw = dict(model=dict(architecture=arch, nnunet_widths=WIDTHS),
              training=dict(seed=1993, epochs=2, CV=2, data_parallel=False),
              data=dict(input_img=str(tree), batch_size=2, oversampling=True))
    port = Config(model=ModelConfig(**kw["model"]), training=TrainingConfig(**kw["training"]),
                  data=DataConfig(**kw["data"]))
    jax = JaxConfig(model=JaxModelConfig(**kw["model"]), training=JaxTrainingConfig(**kw["training"]),
                    data=JaxDataConfig(**kw["data"]))
    return port, jax


_JIT_INITS: dict = {}


class _JitInit:
    """A flax model as ``create_train_state`` sees it, with ``init`` jitted
    once per model (flax modules compare by their fields)."""

    def __init__(self, model):
        if model not in _JIT_INITS:
            import jax
            _JIT_INITS[model] = jax.jit(model.init, static_argnames="train")
        self.init = _JIT_INITS[model]


def _run_both(tmp_path, monkeypatch, tree, task: str, mode: str, arch: str):
    """Run the JAX driver, then the port's from the same fold weights;
    return both run dirs and both drivers' epoch permutations."""
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.train.loop import EngineConfig as JaxEngineConfig
    from multi_task_breast_cancer_tpu_torch.train.loop import EngineConfig

    port_cfg, jax_cfg = _configs(tree, arch)
    perms = {"jax": [], "port": []}

    def spy(name, real):
        def plan(*args, **kwargs):
            perms[name].append(real(*args, **kwargs))
            return perms[name][-1]
        return plan

    monkeypatch.setattr(jax_driver, "EngineConfig",
                        functools.partial(JaxEngineConfig, use_transforms=False))
    monkeypatch.setattr(driver, "EngineConfig",
                        functools.partial(EngineConfig, use_transforms=False))
    monkeypatch.setattr(jax_driver, "plan_epoch_indices", spy("jax", jax_driver.plan_epoch_indices))
    monkeypatch.setattr(driver, "plan_epoch_indices", spy("port", driver.plan_epoch_indices))

    jax_model = jax_driver._build_model(jax_cfg, task)
    create_train_state = jax_driver.create_train_state
    monkeypatch.setattr(jax_driver, "create_train_state",
                        lambda model, *args: create_train_state(_JitInit(model), *args))

    def jax_fold_init(cfg, task_, seed, fold, size=SIZE):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
        params = _JitInit(jax_model).init(key, jnp.zeros((1, size, size, 1)), train=False)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, params["params"]),
                               driver._build_model(cfg, task_, size=size))

    monkeypatch.setattr(driver, "fold_init_state_dict", jax_fold_init)
    jax_run = Path(jax_driver.run_experiment(jax_cfg, task, mode, run_root=str(tmp_path / "jax")))
    port_run = Path(driver.run_experiment(port_cfg, task, mode, run_root=str(tmp_path / "port"),
                                          device="cpu"))
    return jax_run, port_run, perms


def _compare_runs(tree: Path, jax_run: Path, port_run: Path, perms, task: str, mode: str
                  ) -> dict:
    """Every comparison of the module docstring; returns the flips per fold."""
    assert len(perms["jax"]) == len(perms["port"]) == 4
    for a, b in zip(perms["jax"], perms["port"]):
        np.testing.assert_array_equal(a, b)

    header = driver.METRIC_HEADERS[(task, mode)]
    assert header == jax_driver.METRIC_HEADERS[(task, mode)]
    seg_csv = task in ("segmentation", "multitask")
    cls_csv = {"segmentation": None, "multitask": "results_classification.csv",
               "classification": "results_classification.csv"}[task]
    flips = {}
    for n in range(2):
        fj, fp = jax_run / f"fold_{n}", port_run / f"fold_{n}"
        assert (fp / ".fold_complete").is_file()
        mj, mp = pd.read_csv(fj / "metrics.csv"), pd.read_csv(fp / "metrics.csv")
        assert (fj / "metrics.csv").read_text().splitlines()[0] == \
            (fp / "metrics.csv").read_text().splitlines()[0] == header
        pd.testing.assert_series_equal(mj["epoch"], mp["epoch"])
        pd.testing.assert_series_equal(mj["LR"], mp["LR"])

        n_flip, n_test = 0, 0
        if cls_csv:
            cj, cp = pd.read_csv(fj / cls_csv), pd.read_csv(fp / cls_csv)
            assert list(cj.columns) == list(cp.columns)
            pd.testing.assert_series_equal(cj["patient_id"], cp["patient_id"])
            pd.testing.assert_series_equal(cj["ground_truth"], cp["ground_truth"])
            n_flip += int((cj["predicted_label"] != cp["predicted_label"]).sum())
            n_test = len(cj)
        if seg_csv:
            sj, sp = pd.read_csv(fj / "results_segmentation.csv"), \
                pd.read_csv(fp / "results_segmentation.csv")
            assert list(sj.columns) == list(sp.columns)
            pd.testing.assert_series_equal(sj["patient_id"], sp["patient_id"])
            pd.testing.assert_series_equal(sj["class"], sp["class"])
            flips[f"pixels_{n}"] = _check_seg_dice(tree, fj, fp, sj, sp)
        flips[n] = n_flip
        assert n_flip <= 1, f"fold {n}: {n_flip} of {n_test} test labels flipped"

        for col in (c for c in mj.columns if "loss" in c.lower()):
            tol = LOSS_RTOL * mj[col].abs().max() + ROUND
            assert (mj[col] - mp[col]).abs().max() <= tol, (n, col)
    return flips


def _check_seg_dice(tree: Path, fj: Path, fp: Path, sj: pd.DataFrame, sp: pd.DataFrame) -> int:
    """Per-image Dice of the two drivers, bounded by the pixels whose
    predicted label differs in the two ``segs/`` PNGs: with ``k`` such
    pixels and ``S = |ground truth| + |prediction|``, Dice = 2TP/S moves by
    at most 3k/(S - k). At most 1 % of an image's pixels may differ (they lie
    at the 0.5 threshold of a barely trained net). Returns the pixels that
    differ over the split."""
    import cv2

    masks = pd.read_csv(tree / "mapping.csv").set_index(["class", "id"])["mask_path"]
    total = 0
    for i, (pid, cls) in enumerate(zip(sp["patient_id"], sp["class"])):
        name = f"segs/{cls}_{pid}_seg.png"
        pj, pp = cv2.imread(str(fj / name), 0) > 0, cv2.imread(str(fp / name), 0) > 0
        k = int((pj != pp).sum())
        assert k <= 0.01 * pp.size, (name, k)
        s = int((cv2.imread(masks[(cls, pid)], 0) > 0).sum() + pp.sum())
        tol = 3 * k / (s - k) if k else 0.0
        assert abs(sj["DICE"][i] - sp["DICE"][i]) <= tol, (name, k, sj["DICE"][i], sp["DICE"][i])
        total += k
    return total


def _metric_tolerances(jax_run: Path, port_run: Path, mode: str) -> None:
    """Accuracy / F1 / Dice columns: at most one image's flip of the split
    the column measures (train or validation) apart."""
    import re
    text = (jax_run / "execution.log").read_text()
    sizes = [tuple(int(v) if v else 0 for v in m)
             for m in re.findall(r"Fold \d+ sizes: train=(\d+)(?: val=(\d+))? test=(\d+)", text)]
    for n, (train, val, _) in enumerate(sizes):
        mj = pd.read_csv(jax_run / f"fold_{n}" / "metrics.csv")
        mp = pd.read_csv(port_run / f"fold_{n}" / "metrics.csv")
        for col in mj.columns:
            if col in ("epoch", "LR") or "loss" in col.lower() or col == "Test":
                continue
            split = val if col.startswith("Validation") else train
            tol = 2.0 / split + ROUND
            diff = float((mj[col] - mp[col]).abs().max())
            assert diff <= tol, (n, col, diff, tol)


def check_driver_matches_jax_driver(tmp_path, monkeypatch, tree, task, mode, arch):
    """Both drivers on ``tree``: every comparison of the module docstring,
    and the same run-dir layout."""
    jax_run, port_run, perms = _run_both(tmp_path, monkeypatch, tree, task, mode, arch)
    flips = _compare_runs(tree, jax_run, port_run, perms, task, mode)
    _metric_tolerances(jax_run, port_run, mode)
    assert (port_run / "config.yaml").is_file() and (port_run / "model.txt").is_file()
    names = {p.name for p in port_run.iterdir()}
    assert names == {p.name for p in jax_run.iterdir()}
    for n in range(2):
        assert sorted(p.name for p in (port_run / f"fold_{n}").iterdir()
                      if not p.name.startswith("model_")) == \
            sorted(p.name for p in (jax_run / f"fold_{n}").iterdir()
                   if not p.name.startswith("model_"))
        for sub in ("segs", "features_map"):
            assert sorted(p.name for p in (port_run / f"fold_{n}" / sub).iterdir()) == \
                sorted(p.name for p in (jax_run / f"fold_{n}" / sub).iterdir())
    print(f"{task} {mode}: test-phase flips per fold {flips}")


# multitask CV_PROD is in test_torch_driver_prod.py: the two MTnnUNet cases
# are the slowest of the suite, and the gate gives each file one worker
@pytest.mark.parametrize("task,mode,arch", [
    ("multitask", "CV", "MTnnUNet"),
    ("segmentation", "CV", "nnUNet"),
    ("classification", "CV", "nnUNetClassifier"),
])
def test_driver_matches_jax_driver(tmp_path, monkeypatch, tree, task, mode, arch):
    check_driver_matches_jax_driver(tmp_path, monkeypatch, tree, task, mode, arch)


def _resume_config(root, task: str, arch: str = "") -> Config:
    """``tests/test_resume.py``'s configuration, on the port's nnU-Net
    family at the narrow widths, or ``arch`` at width 4."""
    from multi_task_breast_cancer_tpu_torch.config import OptimizerConfig
    model = (ModelConfig(architecture=arch, width=4) if arch else ModelConfig(
        architecture={"multitask": "MTnnUNet", "segmentation": "nnUNet"}[task],
        nnunet_widths=WIDTHS))
    return Config(
        model=model,
        optimizer=OptimizerConfig(opt="Adam", lr=1e-3, scheduler="cosine", t_max=4),
        training=TrainingConfig(seed=1993, epochs=3, CV=2, checkpoint_every_epoch=True,
                                data_parallel=False,
                                per_epoch_test_artifacts=(task == "segmentation")),
        data=DataConfig(input_img=str(root), batch_size=4, oversampling=False))


def _artifact_bytes(run: Path) -> dict:
    """Checkpoints and CSVs, keyed by their path with the run's timestamp
    taken out of the checkpoint names."""
    out = {}
    for f in sorted(run.rglob("*")):
        if f.is_file() and (f.name.startswith("model_2") or f.suffix == ".csv"):
            rel = str(f.relative_to(run))
            if f.name.startswith("model_2"):
                rel = rel.replace(f.name, "CKPT" + f.suffix)
            out[rel] = f.read_bytes()
    return out


@pytest.mark.parametrize("task,mode,crash_at", [
    ("multitask", "CV_PROD", 3),  # a checkpoint every epoch: killed mid fold 0
    ("segmentation", "CV", 2),  # epoch 0 of a fold always improves
])
def test_kill_and_resume_byte_identical(tmp_path, monkeypatch, task, mode, crash_at):
    """Killed between a metrics.csv row and its checkpoint, the worst-ordered
    point, and resumed in place: every checkpoint and CSV equals an
    uninterrupted run's, byte for byte."""
    _kill_and_resume(tmp_path, monkeypatch, task, mode, crash_at)


def test_residual_unet_kill_and_resume_byte_identical(tmp_path, monkeypatch):
    """ResidualUNet, whose batch statistics are in every checkpoint and whose
    dropout draws from each epoch's generator: killed and resumed, every
    checkpoint and CSV equals an uninterrupted run's, byte for byte; the
    running statistics moved from their start."""
    import torch

    from multi_task_breast_cancer_tpu_torch.train.checkpoint import is_torch_checkpoint

    run = _kill_and_resume(tmp_path, monkeypatch, "segmentation", "CV", 2, "ResidualUNet")
    ckpt = next(f for f in (run / "fold_0").iterdir() if f.name.startswith("model_2"))
    assert is_torch_checkpoint(str(ckpt))
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["model_state_dict"]
    assert not torch.equal(sd["in_block.bn1.bn.var"], torch.ones(4))
    assert not torch.equal(sd["up_block1.bn3.bn.mean"], torch.zeros(4))


def _kill_and_resume(tmp_path, monkeypatch, task, mode, crash_at, arch: str = "") -> Path:
    root = jax_synthetic.make_preprocessed_busi(tmp_path / "busi", n_per_class=8, size=32)
    run_a = Path(driver.run_experiment(_resume_config(root, task, arch), task, mode,
                                       run_root=str(tmp_path / "a"), device="cpu"))
    real_save = driver.save_checkpoint
    calls = {"n": 0}

    def crashing_save(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == crash_at:
            raise RuntimeError("simulated kill between metrics row and checkpoint")
        return real_save(*args, **kwargs)

    monkeypatch.setattr(driver, "save_checkpoint", crashing_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        driver.run_experiment(_resume_config(root, task, arch), task, mode,
                              run_root=str(tmp_path / "b"), device="cpu")
    monkeypatch.setattr(driver, "save_checkpoint", real_save)
    run_b = next((tmp_path / "b").iterdir())
    resumed = Path(driver.run_experiment(_resume_config(root, task, arch), task, mode,
                                         resume_dir=str(run_b), device="cpu"))
    assert resumed == run_b
    assert "Fold 0: resuming from epoch" in (run_b / "execution.log").read_text()
    a, b = _artifact_bytes(run_a), _artifact_bytes(run_b)
    assert set(a) == set(b) and any(k.endswith("CKPT" + (".tar" if task == "segmentation"
                                                         else "")) for k in a)
    for rel in a:
        assert a[rel] == b[rel], f"artifact differs after resume: {rel}"
    return run_b


def test_resume_rejects_changed_seed_optimizer_and_entry_point(tmp_path):
    """The guard of ``tests/test_resume.py``: a changed seed or optimizer
    would not replay the run, and a resume through another entry point is
    caught by the metrics.csv header."""
    from multi_task_breast_cancer_tpu_torch.config import DEFAULT_CONFIG_YAML, config_to_yaml

    root = jax_synthetic.make_preprocessed_busi(tmp_path / "busi", n_per_class=4, size=32)
    run_dir = tmp_path / "20260101_000000_nnUNet_24_batch_4_x"
    (run_dir / "fold_0").mkdir(parents=True)
    (run_dir / "config.yaml").write_text(DEFAULT_CONFIG_YAML)
    for change in (lambda c: setattr(c.training, "seed", 7),
                   lambda c: setattr(c.optimizer, "lr", 0.5)):
        cfg = _resume_config(root, "segmentation")
        change(cfg)
        with pytest.raises(SystemExit, match="config mismatch"):
            driver.run_experiment(cfg, "segmentation", "CV", resume_dir=str(run_dir),
                                  device="cpu")

    cfg = _resume_config(root, "segmentation")
    (run_dir / "config.yaml").write_text(config_to_yaml(cfg))
    (run_dir / "fold_0" / "metrics.csv").write_text(
        driver.METRIC_HEADERS[("segmentation", "CV")] + "\n")
    with pytest.raises(SystemExit, match="entry point"):
        driver.run_experiment(cfg, "segmentation", "CV_PROD", resume_dir=str(run_dir),
                              device="cpu")


@pytest.mark.parametrize("entry,task,mode", [
    ("training_segmentation", "segmentation", "CV"),
    ("training_segmentation_prod", "segmentation", "CV_PROD"),
    ("training_classification", "classification", "CV"),
    ("training_classification_prod", "classification", "CV_PROD"),
    ("training_multitask", "multitask", "CV"),
    ("training_multitask_prod", "multitask", "CV_PROD"),
])
def test_training_entry_points_parse_and_default_to_cuda(tmp_path, monkeypatch, entry, task,
                                                         mode):
    """Each entry point hands its task and mode and the parsed flags to
    ``run_experiment``, which runs on ``cuda``: with no GPU it raises and
    does not go on on the CPU."""
    import importlib

    import torch

    from multi_task_breast_cancer_tpu_torch import _entry

    mod = importlib.import_module(f"multi_task_breast_cancer_tpu_torch.{entry}")
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text("training: {seed: 7}\n")
    argv = [entry, "--config", str(cfg_path), "--run-root", str(tmp_path / "runs")]
    seen = {}

    def fake_run(cfg, **kwargs):
        seen.update(kwargs, seed=cfg.training.seed)
        return "run"

    monkeypatch.setattr(sys, "argv", argv + ["--resume", str(tmp_path / "r")])
    monkeypatch.setattr(_entry, "run_experiment", fake_run)
    mod.main()
    assert seen == dict(task=task, mode=mode, config_src=str(cfg_path),
                        run_root=str(tmp_path / "runs"), resume_dir=str(tmp_path / "r"),
                        seed=7)

    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()
    assert not (tmp_path / "runs").exists()
