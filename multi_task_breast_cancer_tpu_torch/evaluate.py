"""External-dataset evaluation entry point (twin of
``multi_task_breast_cancer_tpu/evaluate.py``): the test phase of the k-fold
driver, over a preprocessed external set (the reference's ``UCLM`` loader
mode, ``src/dataset/BUSI_dataloader.py:221-244,371-377``).

    python -m multi_task_breast_cancer_tpu_torch.evaluate \\
        --config config.yaml --task multitask \\
        --checkpoint runs/.../fold_0/model_..._fold_0 \\
        --data ./Datasets/BUS_UCLM_postprocessed_128 --output ./eval_uclm

The checkpoint is the port's (``torch.save``) or the JAX driver's
(flax-msgpack). Writes the driver's result CSVs, ``segs/`` and
``features_map/`` under ``--output``. Runs on ``cuda`` unless
``--device cpu``, in ``training.compute_dtype`` as the driver's test phase
does (the JAX tool builds its Engine without it, so it evaluates a bf16
configuration in float32).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from multi_task_breast_cancer_tpu_torch.config import load_config
from multi_task_breast_cancer_tpu_torch.data.loader import load_datasets
from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.train.checkpoint import load_pretrained_model
from multi_task_breast_cancer_tpu_torch.train.driver import _build_model, _fold_inference
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="./config.yaml")
    parser.add_argument("--task", default="multitask",
                        choices=["segmentation", "classification", "multitask"])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--data", required=True, help="preprocessed dataset folder")
    parser.add_argument("--output", default="./eval_out")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    cfg = load_config(args.config)
    n_classes = len(cfg.data.classes)
    folds = load_datasets(cfg.training, cfg.data, mode="UCLM", uclm_path=args.data)

    ecfg = EngineConfig(task=args.task, n_classes=n_classes,
                        batch_size=cfg.data.batch_size,
                        alpha=cfg.training.alpha,
                        inversely_weighted=cfg.loss.inversely_weighted,
                        seg_criterion=cfg.loss.function,
                        cls_criterion=cfg.loss.classification_criterion,
                        compute_dtype=cfg.training.compute_dtype)
    engine = Engine(_build_model(cfg, args.task, size=folds[0].test.images.shape[1]), ecfg,
                    device=device)
    state = create_train_state(engine.model, cfg.optimizer.opt, cfg.optimizer.lr)
    state = load_pretrained_model(state, args.checkpoint)

    out = Path(args.output)
    for sub in ("segs", "features_map"):
        (out / sub).mkdir(parents=True, exist_ok=True)

    # the driver's per-fold test phase, so external evaluation runs the same
    # inference code (the config's prediction-refinement flags included)
    _fold_inference(args.task, n_classes, cfg, engine, state, folds[0], str(out), args.checkpoint)


if __name__ == "__main__":
    main()
