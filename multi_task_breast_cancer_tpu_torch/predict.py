"""Prediction entry point (twin of ``multi_task_breast_cancer_tpu/predict.py``):
run a trained checkpoint over a folder of raw ultrasound PNGs (no masks
needed) and write segmentation masks and class probabilities.

    python -m multi_task_breast_cancer_tpu_torch.predict \\
        --config config.yaml --task multitask \\
        --checkpoint runs/.../fold_0/model_..._fold_0 \\
        --images ./incoming_pngs --output ./predictions

The checkpoint is the port's (``torch.save``) or the JAX driver's
(flax-msgpack). Writes ``segs/<stem>_seg.png`` and ``predictions.json``. Runs
on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from multi_task_breast_cancer_tpu_torch.config import load_config
from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.serve.post import model_applies_softmax, postprocess
from multi_task_breast_cancer_tpu_torch.serve.server import prepare_image
from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state
from multi_task_breast_cancer_tpu_torch.train.inference import (
    save_binary_segmentation,
    save_multilabel_segmentation,
    to_host,
)
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig


def load_images(folder: str | Path, size: int = 128,
                augmentations: dict | None = None) -> tuple[np.ndarray, list]:
    """The folder's PNGs with the channel stack the model was trained on:
    grayscale plus the config's augment channels (``prepare_image``)."""
    import cv2

    augmentations = augmentations or {}
    imgs, kept_paths = [], []
    for p in sorted(Path(folder).glob("*.png")):
        img = cv2.imread(str(p), 0)
        if img is None:
            logging.warning("skipping unreadable %s", p)
            continue
        imgs.append(prepare_image(img, size, augmentations))
        kept_paths.append(p)
    if not imgs:
        raise SystemExit(f"no readable PNG images found in {folder}")
    return np.stack(imgs), kept_paths


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config.yaml")
    parser.add_argument("--task", default="multitask",
                        choices=["segmentation", "classification", "multitask"])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--images", required=True)
    parser.add_argument("--output", default="./predictions")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    n_classes = len(cfg.data.classes)
    images, paths = load_images(args.images, args.size,
                                augmentations=cfg.data.augmentation.as_dict())
    logging.info("loaded %d images (%d channels)", len(images), images.shape[-1])

    state, channels = build_inference_state(cfg, args.task, checkpoint=args.checkpoint,
                                            device=device, size=args.size)
    if channels != images.shape[-1]:
        raise SystemExit(f"config expects {channels} input channels, "
                         f"loaded images have {images.shape[-1]}")
    engine = Engine(state.model, EngineConfig(task=args.task, n_classes=n_classes,
                                              batch_size=cfg.data.batch_size,
                                              compute_dtype=cfg.training.compute_dtype),
                    device=device)

    out_dir = Path(args.output)
    (out_dir / "segs").mkdir(parents=True, exist_ok=True)

    t0 = time.perf_counter()
    out = engine.predict(state, images)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    logging.info("inference: %d imgs in %.3fs (%.1f imgs/s)", len(images), dt, len(images) / dt)

    pred = postprocess(to_host(out), args.task, n_classes,
                       cfg.training.overlap_class_based_on_seg,
                       model_applies_softmax(args.task, cfg.model.architecture, n_classes))
    records = []
    save_mask = (save_binary_segmentation if pred.mask_scale == 255
                 else save_multilabel_segmentation)  # semantic: label PNGs
    for i, p in enumerate(paths):
        if pred.masks is not None:
            save_mask(pred.masks[i], str(out_dir / "segs" / f"{p.stem}_seg.png"))
        records.append({"image": p.name, **pred.record(i)})

    with (out_dir / "predictions.json").open("w") as f:
        json.dump(records, f, indent=2)
    logging.info("wrote %s", out_dir / "predictions.json")


if __name__ == "__main__":
    main()
