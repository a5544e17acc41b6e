"""Shared CLI of the six training entry points (twin of
``multi_task_breast_cancer_tpu/_entry.py``, without its multi-host flags):

    python -m multi_task_breast_cancer_tpu_torch.training_multitask \
        --config CFG --run-root DIR [--resume RUN_DIR]

The run goes on the GPU (``cuda``); without one it raises. ``--config``
defaults to the resumed run's own ``config.yaml``, then ``./config.yaml`` or
``./src/config.yaml``, and else writes the default config to
``./config.yaml``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from multi_task_breast_cancer_tpu_torch.config import DEFAULT_CONFIG_YAML, load_config
from multi_task_breast_cancer_tpu_torch.train.driver import run_experiment

DEFAULT_CONFIG_PATHS = ("./config.yaml", "./src/config.yaml")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None,
                        help="YAML config (defaults to ./config.yaml or ./src/config.yaml)")
    parser.add_argument("--run-root", default="runs")
    parser.add_argument("--resume", default=None, metavar="RUN_DIR",
                        help="continue a killed run in place: complete folds are "
                             "skipped and an interrupted fold restarts from its last "
                             "checkpoint (per epoch with "
                             "training.checkpoint_every_epoch=True); the config "
                             "defaults to the run dir's own config.yaml")
    return parser.parse_args(argv)


def resolve_config_path(args: argparse.Namespace) -> str:
    if args.config is not None:
        return args.config
    if args.resume is not None and (Path(args.resume) / "config.yaml").exists():
        return str(Path(args.resume) / "config.yaml")
    for cand in DEFAULT_CONFIG_PATHS:
        if Path(cand).exists():
            return cand
    Path("./config.yaml").write_text(DEFAULT_CONFIG_YAML)
    return "./config.yaml"


def run_entry(task: str, mode: str, argv=None) -> str:
    args = parse_args(argv)
    config_path = resolve_config_path(args)
    return run_experiment(load_config(config_path), task=task, mode=mode,
                          config_src=config_path, run_root=args.run_root,
                          resume_dir=args.resume)
