"""The experiment driver (twin of ``multi_task_breast_cancer_tpu/train/driver.py``):
one parameterised k-fold runner behind the six ``training_*`` entry points,
with the JAX driver's run-directory layout, ``metrics.csv`` schemas,
checkpoint names, plots, test-phase inference and resume.

Task × mode:
- task: 'segmentation' | 'classification' | 'multitask';
- mode: 'CV' (train / val / test, best-validation checkpoint, early
  stopping) | 'CV_PROD' (train = train ∪ val, no validation, the scheduler
  steps on the train loss, early stopping dead: the reference's quirk,
  ``training_multitask_prod.py:213-216``).

Randomness, chosen so that a resumed run replays exactly:
- ``host_rng = np.random.default_rng(seed)`` draws every epoch's
  permutation (``plan_epoch_indices``), as in JAX, so the permutations equal
  the JAX driver's for equal fold sizes; a resume replays it row by row;
- the segmentation entry's ``max_angle`` is ``np.random.choice(range(0,
  360))`` right after seeding, the JAX driver's draw;
- fold ``n``'s initial weights come from ``torch.Generator().manual_seed(
  derive_seed(seed, n))`` and epoch ``e``'s augmentation draws from
  ``derive_seed(seed, n, e + 1)``, where ``derive_seed(*k)`` is the first
  uint64 word of ``np.random.SeedSequence(list(k))`` modulo 2**63: the twins
  of JAX's ``fold_in(root_key, n)`` and ``fold_in(fold_key, e + 1)``;
- epoch ``e``'s dropout masks (ResidualUNet) come from a generator on the
  run's device seeded with ``derive_seed(seed, n, e + 1, DROPOUT_STREAM)``,
  a stream apart from the augmentation's (JAX splits ``k_drop`` from each
  step's key).

The best epoch's state is copied on the device (no host fetch per epoch)
and written once per fold unless ``training.checkpoint_every_epoch``.

Data parallelism, as in JAX: with ``training.data_parallel`` and a process
group of more than one rank (:mod:`..parallel.multihost`), every rank runs
the whole driver on its own device over the data mesh (``data_mesh()``),
each step on its shard of the global batch; rank 0's fresh or restored
state is broadcast to the others, so every rank takes the same steps and
writes the same rows. Only rank 0's run root is the user's (the CLI sends
the others to scratch). A batch that does not divide over the ranks of the
``data`` axis turns fast augmentation off, with a warning.

Spatial partitioning, as in JAX: ``training.spatial_partitions: n`` (with
``data_parallel``) makes the mesh ``data_space_mesh(n)``, a ``(W/n data ×
n space)`` grid of the W ranks, whose ``space`` groups split every image's
rows (:mod:`..parallel.spatial`). n must divide W (``ValueError``, before
anything is written). Every architecture and every criterion runs on it;
the image height must be a multiple of n_space · ``space_row_multiple``
(the Engine's ``ValueError``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from datetime import datetime
from pathlib import Path
from pprint import pformat
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from multi_task_breast_cancer_tpu_torch.config import Config, config_to_yaml, load_config
from multi_task_breast_cancer_tpu_torch.data.loader import load_datasets
from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.models.registry import (
    init_classification_model,
    init_multitask_model,
    init_segmentation_model,
    save_model_summary,
)
from multi_task_breast_cancer_tpu_torch.ops.image_ops import fill_holes as fill_holes_fn
from multi_task_breast_cancer_tpu_torch.ops.losses import check_finite_loss
from multi_task_breast_cancer_tpu_torch.ops.metrics import (
    binary_classification_metrics,
    dice_score,
    multiclass_classification_metrics,
)
from multi_task_breast_cancer_tpu_torch.parallel import multihost
from multi_task_breast_cancer_tpu_torch.parallel.mesh import data_space_mesh, replicate_to_mesh
from multi_task_breast_cancer_tpu_torch.train import inference as I
from multi_task_breast_cancer_tpu_torch.train.checkpoint import (
    load_pretrained_model,
    restore_checkpoint,
    save_checkpoint,
    snapshot,
)
from multi_task_breast_cancer_tpu_torch.train.loop import (
    Engine,
    EngineConfig,
    plan_epoch_indices,
    step_valid_mask,
)
from multi_task_breast_cancer_tpu_torch.train.optim import (
    CosineAnnealingScheduler,
    init_lr_scheduler,
    set_learning_rate,
)
from multi_task_breast_cancer_tpu_torch.train.state import TrainState, create_train_state
from multi_task_breast_cancer_tpu_torch.utils.miscellany import (
    init_log,
    save_classification_results,
    save_segmentation_results,
    seed_everything,
    write_metrics_file,
)
from multi_task_breast_cancer_tpu_torch.utils.profiling import StepTimer, maybe_profile
from multi_task_breast_cancer_tpu_torch.utils.visualization import plot_evolution


DROPOUT_STREAM = 1


def derive_seed(*keys: int) -> int:
    """A 63-bit seed from integer keys (the root seed, the fold, the epoch)."""
    word = np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0]
    return int(word % np.uint64(2 ** 63))


def input_channels(cfg: Config) -> int:
    """Model input width: raw sequences + config-enabled augment channels."""
    return cfg.model.sequences + cfg.data.augmentation.n_active()


def _build_model(cfg: Config, task: str, generator: Optional[torch.Generator] = None,
                 size: int = 128):
    """The task's model on the CPU, its weights drawn from ``generator``, for
    ``size``² inputs. ``data.semantic_segmentation`` gives the segmentation
    head 3 channels."""
    sequences = input_channels(cfg)
    n_classes = len(cfg.data.classes)
    nw = cfg.model.nnunet_widths
    if task == "segmentation":
        regions = 3 if cfg.data.semantic_segmentation else 1
        return init_segmentation_model(cfg.model.architecture, sequences=sequences,
                                       regions=regions, width=cfg.model.width,
                                       deep_supervision=cfg.model.deep_supervision,
                                       nnunet_widths=nw, size=size, generator=generator)
    if task == "classification":
        return init_classification_model(cfg.model.architecture, sequences=sequences,
                                         n_classes=n_classes, width=cfg.model.width,
                                         nnunet_widths=nw, size=size, generator=generator)
    return init_multitask_model(cfg.model.architecture, sequences=sequences,
                                n_classes=n_classes, width=cfg.model.width,
                                deep_supervision=cfg.model.deep_supervision,
                                nnunet_widths=nw, size=size, generator=generator)


def fold_init_state_dict(cfg: Config, task: str, seed: int, fold: int,
                         size: int = 128) -> Dict[str, torch.Tensor]:
    """Fold ``fold``'s initial weights (CPU), from the generator seeded with
    ``derive_seed(seed, fold)``."""
    gen = torch.Generator().manual_seed(derive_seed(seed, fold))
    return _build_model(cfg, task, gen, size).state_dict()


def build_inference_state(cfg: Config, task: str, checkpoint: Optional[str] = None,
                          device=None, size: int = 128):
    """Model for ``size``² inputs and fresh train state on ``device`` (+
    optional checkpoint weights): the recipe the deployment paths share with
    training. Returns ``(state, channels)``."""
    model = _build_model(cfg, task, size=size).to(resolve_device(device))
    state = create_train_state(model, cfg.optimizer.opt, cfg.optimizer.lr)
    if checkpoint is not None:
        state = load_pretrained_model(state, checkpoint)
    return state, input_channels(cfg)


def quick_test_dice(engine: Engine, state: TrainState, test_ds, fill_holes: bool = True,
                    pad_to: Optional[int] = None, device_images=None) -> float:
    """Per-image mean test Dice, the number the segmentation drivers log
    each epoch (``training_segmentation.py:179-196``), without the per-epoch
    PNGs: one batched forward and host hole filling. ``device_images``: the
    split already on the device (placed once per fold, not every epoch)."""
    images = test_ds.images if device_images is None else device_images
    out = engine.predict(state, images, pad_to=pad_to)
    if engine.cfg.task == "multitask":
        out = out[-1]  # (cls, seg) or Adityan's (cls, rec, seg): seg is last
    final = out[-1] if isinstance(out, (tuple, list)) else out
    final = I.to_host(final)
    if final.shape[-1] > 1:
        # semantic head: the mean of per-class Dice over classes 1..C-1
        pred = np.argmax(final, axis=-1)
        dices = []
        for i in range(len(test_ds)):
            gt = np.argmax(test_ds.masks[i], axis=-1)
            per_class = []
            for c in range(1, final.shape[-1]):
                g, s = gt == c, pred[i] == c
                tp = float(np.logical_and(s, g).sum())
                fp = float(np.logical_and(s, ~g).sum())
                fn = float(np.logical_and(~s, g).sum())
                per_class.append(dice_score(tp, fp, fn, g, s))
            dices.append(np.nanmean(per_class))
        return float(np.nanmean(dices))
    probs = I._sigmoid(final[..., 0])
    dices = []
    for i in range(len(test_ds)):
        seg = (probs[i] > 0.5).astype(np.uint8)
        if fill_holes:
            seg = fill_holes_fn(seg)
        gt = test_ds.masks[i, :, :, 0]
        tp = float(np.logical_and(seg, gt).sum())
        fp = float(np.logical_and(seg, 1 - gt).sum())
        fn = float(np.logical_and(1 - seg, gt).sum())
        dices.append(dice_score(tp, fp, fn, gt, seg))
    return float(np.mean(dices))


METRIC_HEADERS = {
    ("segmentation", "CV"): "epoch,LR,Train,Validation,Test,Train_loss,Val_loss",
    ("segmentation", "CV_PROD"): "epoch,LR,Train,Test,Train_loss",
    ("classification", "CV"): "epoch,LR,Train_loss,Validation_loss,Train_acc,Train_F1,Validation_acc,Validation_F1",
    ("classification", "CV_PROD"): "epoch,LR,Train_loss,Train_acc,Train_F1",
    ("multitask", "CV"): "epoch,LR,Train_loss,Validation_loss,Train_dice,Validation_dice,Train_acc,Train_F1,Validation_acc,Validation_F1",
    ("multitask", "CV_PROD"): "epoch,LR,Train_loss,Train_dice,Train_acc,Train_F1",
}


def _cls_f1(metrics: dict, task: str, n_classes: int) -> float:
    """The reference's F1: weighted for multitask; micro (multiclass) or
    binary for the classification driver (``training_classification.py:92``)."""
    if task == "multitask":
        return metrics["f1"]
    return metrics["f1_micro"] if n_classes > 2 else metrics["f1_binary"]


def _log_epoch(task: str, mode: str, n_classes: int, epoch: int,
               current_lr: float, tm: dict, vm: Optional[dict],
               test_dice: Optional[float], patience: int, dt: float,
               best_validation_loss: float) -> str:
    """The reference's per-epoch log line; returns the metrics.csv row."""
    if task == "segmentation":
        if mode == "CV":
            logging.info(
                "EPOCH %d --> || Training loss %.4f || Validation loss %.4f "
                "|| Training DICE %.4f || Validation DICE  %.4f || Patience: %d "
                "|| Epoch time: %.4f || LR: %.8f", epoch, tm["loss"], vm["loss"],
                tm["dice"], vm["dice"], patience, dt, current_lr)
            return (f"{epoch},{current_lr:.8f},{tm['dice']:.4f}, {vm['dice']:.4f},"
                    f"{test_dice:.4f},{tm['loss']:.4f},{vm['loss']:.4f}")
        logging.info(
            "EPOCH %d --> || Training loss %.4f || Training DICE %.4f "
            "|| Patience: %d || Epoch time: %.4f || LR: %.8f",
            epoch, tm["loss"], tm["dice"], patience, dt, current_lr)
        return (f"{epoch},{current_lr:.8f},{tm['dice']:.4f},{test_dice:.4f},"
                f"{tm['loss']:.4f}")
    if task == "classification":
        tf1 = _cls_f1(tm, task, n_classes)
        if mode == "CV":
            vf1 = _cls_f1(vm, task, n_classes)
            logging.info(
                "EPOCH %d --> || Training loss %.4f || Validation loss %.4f "
                "|| Training ACC %.4f || Training F1 %.4f || Validation ACC %.4f "
                "|| Validation F1 %.4f || Patience: %d || Epoch time: %.4f",
                epoch, tm["loss"], vm["loss"], tm["acc"], tf1, vm["acc"], vf1,
                patience, dt)
            return (f"{epoch},{current_lr:.8f},{tm['loss']:.4f},{vm['loss']:.4f},"
                    f"{tm['acc']:.4f},{tf1:.4f},{vm['acc']:.4f},{vf1:.4f}")
        logging.info(
            "EPOCH %d --> || Training loss %.4f || Training ACC %.4f "
            "|| Training F1 %.4f || Patience: %d || Epoch time: %.4f",
            epoch, tm["loss"], tm["acc"], tf1, patience, dt)
        return f"{epoch},{current_lr:.8f},{tm['loss']:.4f},{tm['acc']:.4f},{tf1:.4f}"
    if mode == "CV":
        logging.info(
            "EPOCH %d --> || Training loss %.4f || Validation loss %.4f "
            "|| Segmentation val loss %.4f || Classification val loss %.4f "
            "|| Training DICE %.4f || Validation DICE  %.4f || Training ACC %.4f "
            "|| Training F1 %.4f || Validation ACC %.4f || Validation F1 %.4f "
            "|| Patience: %d || Epoch time: %.4f || Best validation performance: %.4f",
            epoch, tm["loss"], vm["loss"], vm["seg_loss"], vm["cls_loss"],
            tm["dice"], vm["dice"], tm["acc"], tm["f1"], vm["acc"], vm["f1"],
            patience, dt, best_validation_loss)
        return (f"{epoch},{current_lr:.8f},{tm['loss']:.4f},{vm['loss']:.4f},"
                f"{tm['dice']:.4f}, {vm['dice']:.4f},{tm['acc']:.4f},"
                f"{tm['f1']:.4f},{vm['acc']:.4f},{vm['f1']:.4f}")
    logging.info(
        "EPOCH %d --> || Training loss %.4f || Training DICE %.4f "
        "|| Training ACC %.4f || Training F1 %.4f || Patience: %d "
        "|| Epoch time: %.4f", epoch, tm["loss"], tm["dice"],
        tm["acc"], tm["f1"], patience, dt)
    return (f"{epoch},{current_lr:.8f},{tm['loss']:.4f},"
            f"{tm['dice']:.4f}, {tm['acc']:.4f},{tm['f1']:.4f}")


def _fold_plots(task: str, mode: str, metrics_path: str, run_path: str, n: int) -> None:
    """Evolution plots (CV mode; the prod scripts have them commented out)."""
    if mode != "CV":
        return
    metrics_df = pd.read_csv(metrics_path)
    if task == "segmentation":
        plot_evolution(metrics_df, ["Train", "Validation", "Test"],
                       f"{run_path}/fold_{n}/plots/metrics_evolution.png",
                       title="DICE coefficient", ylabel="DICE")
        plot_evolution(metrics_df, ["Train_loss", "Val_loss"],
                       f"{run_path}/fold_{n}/plots/loss_evolution.png",
                       title="DICE loss function", ylabel="Loss DICE")
    elif task == "classification":
        plot_evolution(metrics_df, ["Train_loss", "Validation_loss"],
                       f"{run_path}/fold_{n}/loss_evolution.png")
        plot_evolution(metrics_df, ["Train_acc", "Train_F1", "Validation_acc",
                                    "Validation_F1"],
                       f"{run_path}/fold_{n}/classification_metrics_evolution.png")
    else:
        plot_evolution(metrics_df, ["Train_loss", "Validation_loss"],
                       f"{run_path}/fold_{n}/loss_evolution.png")
        plot_evolution(metrics_df, ["Train_dice", "Validation_dice"],
                       f"{run_path}/fold_{n}/segmentation_metrics_evolution.png")
        plot_evolution(metrics_df, ["Train_acc", "Train_F1", "Validation_acc",
                                    "Validation_F1"],
                       f"{run_path}/fold_{n}/classification_metrics_evolution.png")


def _fold_inference(task: str, n_classes: int, cfg: Config, engine: Engine,
                    state: TrainState, fold, fold_dir: str, ckpt_path: str,
                    pad_to: Optional[int] = None) -> None:
    """The testing phase. Classification and multitask score the best
    checkpoint (``training_multitask.py:294``); segmentation scores the
    LAST-epoch weights, because the reference's segmentation drivers never
    reload (``training_segmentation.py:218`` is commented out)."""
    logging.info("\n\n ###############  TESTING PHASE  ###############  \n\n")
    if task != "segmentation":
        state = load_pretrained_model(state, ckpt_path)

    if task == "segmentation":
        if cfg.data.semantic_segmentation:
            test_results = I.inference_multilabel_segmentation(engine, state, fold.test, fold_dir)
        else:
            test_results = I.inference_binary_segmentation(engine, state, fold.test, fold_dir,
                                                           pad_to=pad_to)
        logging.info("%s", test_results.mean(numeric_only=True))
    elif task == "classification":
        if n_classes <= 2:
            cls_results = I.inference_binary_classification(engine, state, fold.test, fold_dir,
                                                             pad_to=pad_to)
            logging.info("\nClassification metrics:\n\n%s", pformat(
                binary_classification_metrics(cls_results.ground_truth,
                                              cls_results.predicted_label)))
        else:
            cls_results = I.inference_multiclass_classification(engine, state, fold.test,
                                                                 fold_dir, pad_to=pad_to)
            logging.info("\nClassification metrics:\n\n%s", pformat(
                multiclass_classification_metrics(cls_results.ground_truth,
                                                  cls_results.predicted_label)))
    elif n_classes <= 2:
        seg_res, cls_res = I.inference_multitask_binary(engine, state, fold.test, fold_dir,
                                                        pad_to=pad_to)
        logging.info("Segmentation metric:\n\n%s\n", seg_res.mean(numeric_only=True))
        logging.info("\nClassification metrics:\n\n%s", pformat(
            binary_classification_metrics(cls_res.ground_truth, cls_res.predicted_label)))
    else:
        seg_res, cls_res = I.inference_multitask_multiclass(
            engine, state, fold.test, fold_dir,
            threshold=cfg.training.threshold_postprocessing,
            overlap_seg_based_on_class=cfg.training.overlap_seg_based_on_class,
            overlap_class_based_on_seg=cfg.training.overlap_class_based_on_seg,
            pad_to=pad_to)
        logging.info("Segmentation metric:\n\n%s\n", seg_res.mean(numeric_only=True))
        logging.info("\nClassification metrics:\n\n%s", pformat(
            multiclass_classification_metrics(cls_res.ground_truth, cls_res.predicted_label)))


def _metrics_rows(path: str) -> list:
    """Data rows (header excluded) of a fold's metrics.csv; [] if absent."""
    p = Path(path)
    if not p.is_file():
        return []
    lines = [ln for ln in p.read_text().splitlines() if ln.strip()]
    return lines[1:]


def _rewrite_metrics(path: str, header: str, rows: list) -> None:
    """Rewrite a fold's metrics.csv atomically (tmp + os.replace): --resume
    counts its rows to replay the host RNG, so a torn row would shift every
    later fold's permutations."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(p.name + ".tmp")
    tmp.write_text("\n".join([header] + list(rows)) + "\n")
    os.replace(tmp, p)


def _fold_complete(run_path: str, n: int) -> bool:
    """A fold is complete once its end-of-fold marker exists (written after
    the testing phase; the result CSVs alone are ambiguous)."""
    return (Path(f"{run_path}/fold_{n}") / ".fold_complete").is_file()


def _find_checkpoint(run_path: str, n: int, default: str) -> str:
    """The fold's checkpoint, also in a renamed run dir (whose name no longer
    gives the timestamp in the file name)."""
    if Path(default).is_file():
        return default
    found = sorted(p for p in Path(f"{run_path}/fold_{n}").glob("model_*")
                   if p.is_file() and not p.name.endswith(".tmp"))
    return str(found[0]) if found else default


def _check_resume_config(cfg: Config, run_cfg_yaml: Path, run_path: str,
                         task: str, mode: str) -> None:
    """Resume only under the original run's critical settings and entry
    point; exit with the mismatches otherwise."""
    import yaml
    saved = load_config(run_cfg_yaml)
    # a config.yaml written before the fast_augmentation default flipped to
    # True may lack the key: read its absence as the old default (False)
    raw = yaml.safe_load(run_cfg_yaml.read_text()) or {}
    if "fast_augmentation" not in (raw.get("training") or {}):
        saved.training.fast_augmentation = False
    critical = [
        ("training.seed", cfg.training.seed, saved.training.seed),
        ("training.CV", cfg.training.CV, saved.training.CV),
        ("training.epochs", cfg.training.epochs, saved.training.epochs),
        ("training.max_patience", cfg.training.max_patience, saved.training.max_patience),
        ("training.alpha", cfg.training.alpha, saved.training.alpha),
        ("training.compute_dtype", cfg.training.compute_dtype, saved.training.compute_dtype),
        ("training.fast_augmentation", cfg.training.fast_augmentation,
         saved.training.fast_augmentation),
        ("model.architecture", cfg.model.architecture, saved.model.architecture),
        ("model.width", cfg.model.width, saved.model.width),
        ("model.sequences", cfg.model.sequences, saved.model.sequences),
        ("model.nnunet_widths", cfg.model.nnunet_widths, saved.model.nnunet_widths),
        ("model.deep_supervision", cfg.model.deep_supervision, saved.model.deep_supervision),
        ("optimizer", dataclasses.asdict(cfg.optimizer), dataclasses.asdict(saved.optimizer)),
        ("loss", dataclasses.asdict(cfg.loss), dataclasses.asdict(saved.loss)),
        ("data.batch_size", cfg.data.batch_size, saved.data.batch_size),
        ("data.input_img", cfg.data.input_img, saved.data.input_img),
        ("data.oversampling", cfg.data.oversampling, saved.data.oversampling),
        ("data.classes", list(cfg.data.classes), list(saved.data.classes)),
        ("data.classes_weighted", cfg.data.classes_weighted, saved.data.classes_weighted),
        ("data.train_size", cfg.data.train_size, saved.data.train_size),
        ("data.remove_outliers", cfg.data.remove_outliers, saved.data.remove_outliers),
        ("data.use_duplicated_to_train", cfg.data.use_duplicated_to_train,
         saved.data.use_duplicated_to_train),
        ("data.semantic_segmentation", cfg.data.semantic_segmentation,
         saved.data.semantic_segmentation),
        ("data.transforms", dataclasses.asdict(cfg.data.transforms),
         dataclasses.asdict(saved.data.transforms)),
        ("data.augmentation", cfg.data.augmentation.as_dict(),
         saved.data.augmentation.as_dict()),
    ]
    mismatched = [(k, now, was) for k, now, was in critical if now != was]
    if mismatched:
        sys.exit("--resume: config mismatch vs the run's own config.yaml "
                 f"(resume would not reproduce the original trajectory): {mismatched}")
    # task and mode are the entry point, not config: the metrics.csv header
    # is their contract
    m0 = Path(run_path) / "fold_0" / "metrics.csv"
    if m0.is_file() and m0.read_text().strip():
        header = m0.read_text().splitlines()[0].replace(" ", "")
        want = METRIC_HEADERS[(task, mode)].replace(" ", "")
        if header != want:
            sys.exit(f"--resume: fold_0/metrics.csv header {header!r} does "
                     f"not match task={task!r} mode={mode!r} ({want!r}) — "
                     "resuming through a different entry point than the "
                     "original run")


def _engine_config(cfg: Config, task: str, max_angle: float,
                   fast_augmentation: Optional[bool] = None) -> EngineConfig:
    return EngineConfig(
        task=task, n_classes=len(cfg.data.classes), batch_size=cfg.data.batch_size,
        alpha=cfg.training.alpha,
        inversely_weighted=cfg.loss.inversely_weighted,
        seg_criterion=cfg.loss.function,
        cls_criterion=cfg.loss.classification_criterion,
        classes_weighted=cfg.data.classes_weighted,
        max_angle=max_angle,
        p_hflip=cfg.data.transforms.horizontal_flip,
        p_vflip=cfg.data.transforms.vertical_flip,
        compute_dtype=cfg.training.compute_dtype,
        fast_augmentation=(cfg.training.fast_augmentation if fast_augmentation is None
                           else fast_augmentation),
    )


def _fast_augmentation(cfg: Config, mesh) -> bool:
    """``training.fast_augmentation``, unless the batch does not divide over
    the ranks of the mesh's ``data`` axis: then the exact augmentation, with
    a warning (JAX's fallback; the Engine built directly raises instead)."""
    n = mesh.data.world_size if mesh is not None else 1
    if cfg.training.fast_augmentation and n > 1 and cfg.data.batch_size % n:
        logging.warning(
            "fast_augmentation disabled for this run: batch_size (%d) does not divide "
            "the data mesh (%d ranks) — falling back to the exact-parity augmentation. "
            "Raise data.batch_size to a multiple of %d to re-enable the fast path.",
            cfg.data.batch_size, n, n)
        return False
    return cfg.training.fast_augmentation


def run_experiment(cfg: Config, task: str, mode: str = "CV",
                   config_src: Optional[str] = None, run_root: str = "runs",
                   uclm_path: Optional[str] = None,
                   resume_dir: Optional[str] = None, device=None,
                   timer: Optional[StepTimer] = None) -> str:
    """Run the k-fold experiment on ``device`` (``cuda`` unless the caller
    asks for ``"cpu"``); returns the run directory.

    ``resume_dir`` continues a killed run in place: complete folds are
    skipped, an interrupted fold restarts from its last checkpoint
    (per-epoch with ``training.checkpoint_every_epoch``), and the host RNG
    is replayed, so the finished run equals an uninterrupted one.
    ``config_src`` is accepted for the CLI; the run dir stores the resolved
    config. ``timer`` collects wall-clock phases ('fold', 'epoch', 'engine',
    'test_phase', 'checkpoint')."""
    init_time = time.perf_counter()
    timer = timer or StepTimer()
    if cfg.data.semantic_segmentation and task != "segmentation":
        raise ValueError(
            "data.semantic_segmentation is only supported for the "
            "segmentation task: the classification/multitask heads have no "
            "semantic-mask objective (the reference has no such path either "
            "— its flag only changes the dataset, BUSI_dataset.py:51)")
    device = resolve_device(device)
    mesh = (data_space_mesh(cfg.training.spatial_partitions, device=device)
            if cfg.training.data_parallel else None)
    if cfg.training.CV < 2:
        sys.exit("This code is prepared for receiving a CV greater than 1")

    seed = seed_everything(cfg.training.seed)
    host_rng = np.random.default_rng(cfg.training.seed)

    n_classes = len(cfg.data.classes)
    if resume_dir is not None:
        run_path = str(resume_dir).rstrip("/")
        if not Path(run_path).is_dir():
            sys.exit(f"--resume: run directory '{run_path}' does not exist")
        timestamp = "_".join(Path(run_path).name.split("_")[:2])
    else:
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        alpha_part = f"_alpha_{cfg.training.alpha}" if task == "multitask" else ""
        run_path = (f"{run_root}/{timestamp}_{cfg.model.architecture}_{cfg.model.width}"
                    f"{alpha_part}_batch_{cfg.data.batch_size}_{'_'.join(cfg.data.classes)}")
    Path(run_path).mkdir(parents=True, exist_ok=True)
    init_log(log_name=f"{run_path}/execution.log")
    logging.info("Device: %s (%s), torch %s", device,
                 torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU",
                 torch.__version__)
    if multihost.active():
        logging.info("Process group: rank %d of %d (%s)", multihost.process_index(),
                     multihost.process_count(), torch.distributed.get_backend())
    if mesh is not None and mesh.space is not None:
        logging.info("Parallelism over %d ranks (mesh axes ('data', 'space'), shape %s), "
                     "this rank %d", mesh.world_size, mesh.shape, mesh.rank)
    elif mesh is not None:
        logging.info("Parallelism over %d ranks (data mesh), this rank %d",
                     mesh.world_size, mesh.rank)
    if resume_dir is not None:
        logging.info("Resuming run in place: %s", run_path)
    run_cfg_yaml = Path(run_path) / "config.yaml"
    if resume_dir is not None and run_cfg_yaml.exists():
        _check_resume_config(cfg, run_cfg_yaml, run_path, task, mode)
    else:
        run_cfg_yaml.write_text(config_to_yaml(cfg))
    logging.info(pformat(dataclasses.asdict(cfg)))

    # the reference's segmentation quirk (training_segmentation.py:113-120):
    # the rotation's max angle is drawn once at startup from U{0..359}
    max_angle = float(np.random.choice(range(0, 360))) if task == "segmentation" else 360.0

    folds = load_datasets(cfg.training, cfg.data, mode=mode, uclm_path=uclm_path)
    expected_ch = input_channels(cfg)
    actual_ch = folds[0].train.images.shape[-1]
    if actual_ch != expected_ch:
        raise ValueError(
            f"model.sequences + active augmentation channels = {expected_ch} "
            f"but the dataset provides {actual_ch} input channel(s)")

    header = METRIC_HEADERS[(task, mode)]
    size = folds[0].train.images.shape[1]
    engine = Engine(_build_model(cfg, task, size=size),
                    _engine_config(cfg, task, max_angle, _fast_augmentation(cfg, mesh)),
                    device=device, mesh=mesh)

    # cross-fold padding, as the JAX driver wires it: every fold's train data
    # and plan padded to the largest fold (padding steps are no-ops), and
    # train + validation fused into one call when the val sizes agree
    B = cfg.data.batch_size
    max_train_n = max(len(f.train) for f in folds)
    max_steps = -(-max_train_n // B)
    max_test_n = max(len(f.test) for f in folds)
    fuse_eval = len({len(f.val) for f in folds if f.val is not None}) <= 1

    for n, fold in enumerate(folds):
        logging.info("\n\n *********************  FOLD %d  ********************* \n\n", n)
        fold_time = time.perf_counter()
        metrics_path = f"{run_path}/fold_{n}/metrics.csv"
        ckpt_suffix = ".tar" if task == "segmentation" else ""
        ckpt_path = f"{run_path}/fold_{n}/model_{timestamp}_fold_{n}{ckpt_suffix}"

        if resume_dir is not None:
            ckpt_path = _find_checkpoint(run_path, n, ckpt_path)
        if resume_dir is not None and _fold_complete(run_path, n):
            rows = _metrics_rows(metrics_path)
            logging.info("Fold %d already complete (%d epochs) — skipping", n, len(rows))
            for _ in rows:
                plan_epoch_indices(len(fold.train), B, host_rng, pad_to_steps=max_steps)
            continue

        for sub in ("segs", "plots", "features_map"):
            Path(f"{run_path}/fold_{n}/{sub}").mkdir(parents=True, exist_ok=True)

        def fresh_state() -> TrainState:
            engine.model.load_state_dict(fold_init_state_dict(cfg, task, seed, n, size))
            return replicate_to_mesh(mesh, create_train_state(
                engine.model, cfg.optimizer.opt, cfg.optimizer.lr))

        state = fresh_state()
        save_model_summary(engine.model, Path(run_path))

        scheduler = init_lr_scheduler(
            cfg.optimizer.scheduler, cfg.optimizer.lr,
            t_max=int(cfg.optimizer.t_max), factor=float(cfg.optimizer.decrease_factor),
            min_lr=float(cfg.optimizer.min_lr), patience=int(cfg.optimizer.patience))

        train_data = engine.device_data(fold.train, pad_to=max_train_n)
        val_data = (engine.device_data(fold.val, for_training=False)
                    if fold.val is not None else None)
        step_valid = step_valid_mask(len(fold.train), B, max_steps)
        test_images_dev = None
        if task == "segmentation" and not cfg.training.per_epoch_test_artifacts:
            test_images_dev = torch.from_numpy(fold.test.images).to(device)

        best_validation_loss = 1_000_000.0
        patience = 0
        eager_ckpt = cfg.training.checkpoint_every_epoch
        best_state, best_epoch = None, 0
        best_resume_state, resume_state = None, None
        resume_epoch = 0
        restored = None
        if resume_dir is not None and Path(ckpt_path).is_file():
            restored = restore_checkpoint(state, ckpt_path)
            if restored[3]["valid"] <= 0:
                logging.info("Fold %d: checkpoint predates resume support — "
                             "restarting fold", n)
                restored = None
                state = fresh_state()
        if restored is not None:
            # an interrupted fold: the last written checkpoint, metrics.csv
            # cut back to its epoch, and the RNG replayed to that point
            state, ckpt_epoch, _, rstate = restored
            replicate_to_mesh(mesh, state)
            resume_epoch = ckpt_epoch + 1
            resume_state = rstate
            scheduler.load_state_dict(rstate)
            patience = int(rstate["patience"])
            best_validation_loss = rstate["best_val_loss"]
            best_epoch = ckpt_epoch
            set_learning_rate(state.optimizer, scheduler.lr)
            rows = _metrics_rows(metrics_path)
            _rewrite_metrics(metrics_path, header, rows[:resume_epoch])
            for _ in range(resume_epoch):
                plan_epoch_indices(len(fold.train), B, host_rng, pad_to_steps=max_steps)
            logging.info("Fold %d: resuming from epoch %d (checkpoint epoch %d)",
                         n, resume_epoch, ckpt_epoch)
        elif resume_dir is not None:
            _rewrite_metrics(metrics_path, header, [])
            logging.info("Fold %d: no checkpoint found — restarting fold", n)
        else:
            write_metrics_file(metrics_path, header)

        epoch = resume_epoch - 1  # stays so when no epoch runs
        for epoch in range(resume_epoch, cfg.training.epochs):
            with timer("epoch"):
                current_lr = scheduler.lr
                t0 = time.perf_counter()
                perm = plan_epoch_indices(len(fold.train), B, host_rng, pad_to_steps=max_steps)
                gen = torch.Generator().manual_seed(derive_seed(seed, n, epoch + 1))
                drop = torch.Generator(device=device).manual_seed(
                    derive_seed(seed, n, epoch + 1, DROPOUT_STREAM))
                with maybe_profile(epoch, n), timer("engine"):
                    if val_data is not None and fuse_eval:
                        state, tm, vm = engine.train_and_eval_epoch(
                            state, train_data, val_data, perm, gen, step_valid, drop)
                    else:
                        state, tm = engine.train_epoch(state, train_data, perm, gen,
                                                       step_valid, drop)
                        vm = engine.eval_epoch(state, val_data) if val_data is not None else None
                check_finite_loss(tm["loss"])
                monitor = vm["loss"] if vm is not None else tm["loss"]
                if vm is not None:
                    check_finite_loss(vm["loss"])

                if isinstance(scheduler, CosineAnnealingScheduler):
                    scheduler.step()
                else:
                    scheduler.step(monitor)
                set_learning_rate(state.optimizer, scheduler.lr)

                improved = False
                if mode == "CV_PROD":
                    pass  # no validation; prod early stopping is dead (reference quirk)
                elif vm["loss"] < best_validation_loss:
                    patience = 0
                    best_validation_loss = vm["loss"]
                    best_epoch = epoch
                    improved = True
                else:
                    patience += 1

                dt = time.perf_counter() - t0
                if task == "segmentation":
                    if cfg.training.per_epoch_test_artifacts:
                        # the reference's cadence (training_segmentation.py:
                        # 179-180): full test inference every epoch
                        if cfg.data.semantic_segmentation:
                            test_results = I.inference_multilabel_segmentation(
                                engine, state, fold.test, f"{run_path}/fold_{n}")
                        else:
                            test_results = I.inference_binary_segmentation(
                                engine, state, fold.test, f"{run_path}/fold_{n}",
                                pad_to=max_test_n)
                        test_dice = float(test_results["DICE"].mean())
                    else:
                        test_dice = quick_test_dice(engine, state, fold.test, pad_to=max_test_n,
                                                    device_images=test_images_dev)
                else:
                    test_dice = None
                line = _log_epoch(task, mode, n_classes, epoch, current_lr, tm, vm,
                                  test_dice, patience, dt, best_validation_loss)
                # the row goes before the checkpoint: a kill between the two
                # leaves more rows than checkpointed epochs, which --resume cuts
                write_metrics_file(metrics_path, line)

                resume_state = dict(scheduler.state_dict(), patience=float(patience),
                                    best_val_loss=float(best_validation_loss))
                with timer("checkpoint"):
                    if mode == "CV_PROD":
                        if eager_ckpt:
                            save_checkpoint(ckpt_path, state, epoch, best_validation_loss,
                                            resume_state)
                    elif improved:
                        if eager_ckpt:
                            save_checkpoint(ckpt_path, state, epoch, best_validation_loss,
                                            resume_state)
                        else:
                            best_state = snapshot(state)
                            best_resume_state = resume_state

            if patience > cfg.training.max_patience:
                logging.info("\nValidation loss did not improve over the last %d "
                             "epochs. Stopping training", patience)
                break

        with timer("checkpoint"):
            if not eager_ckpt:
                if mode == "CV_PROD":
                    if epoch >= 0 and resume_state is not None:
                        save_checkpoint(ckpt_path, state, epoch, best_validation_loss,
                                        resume_state)
                elif best_state is not None:
                    save_checkpoint(ckpt_path, best_state, best_epoch, best_validation_loss,
                                    best_resume_state)
                    best_state = None

        _fold_plots(task, mode, metrics_path, run_path, n)
        with timer("test_phase"):
            _fold_inference(task, n_classes, cfg, engine, state, fold,
                            f"{run_path}/fold_{n}", ckpt_path, pad_to=max_test_n)
        (Path(f"{run_path}/fold_{n}") / ".fold_complete").touch()
        timer.totals["fold"] += time.perf_counter() - fold_time
        timer.counts["fold"] += 1
        logging.info("Total time for fold %d: %.2f", n, time.perf_counter() - fold_time)
        del state, train_data, val_data, test_images_dev

    if task in ("segmentation", "multitask"):
        save_segmentation_results(run_path)
    if task in ("classification", "multitask"):
        save_classification_results(run_path, n_classes)

    logging.info("Wall time per call (s): %s",
                 ", ".join(f"{k} {v:.3f} x{timer.counts[k]}" for k, v in timer.summary().items()))
    logging.info("Total time for all of the folds: %.2f", time.perf_counter() - init_time)
    return run_path
