"""Shared CLI of the six training entry points (twin of
``multi_task_breast_cancer_tpu/_entry.py``):

    python -m multi_task_breast_cancer_tpu_torch.training_multitask \
        --config CFG --run-root DIR [--resume RUN_DIR] \
        [--coordinator HOST:PORT --num-processes N --process-id I]

The run goes on the GPU (``cuda``); without one it raises. ``--config``
defaults to the resumed run's own ``config.yaml``, then ``./config.yaml`` or
``./src/config.yaml``, and else writes the default config to
``./config.yaml``.

Several GPUs (``training.data_parallel``, the default): one process runs per
GPU, each a rank of one process group (:mod:`.parallel.multihost`), started

- by the command itself, when no process group is set up and more than one
  GPU is visible: it starts one worker per GPU with a rendezvous on this
  host, and fails (stopping the others) if any worker fails;
- by ``torchrun --nproc-per-node N -m ...`` (its environment is detected);
- by hand, on one host or several: ``--coordinator``, ``--num-processes``
  and ``--process-id`` on every process.

With ``training.spatial_partitions: n`` the same ranks form the ``(W/n
data × n space)`` mesh of spatial partitioning (``train/driver.py``), for
every architecture and criterion; n must divide the W ranks.

Rank 0 writes the run directory under ``--run-root``; every other rank runs
the whole experiment too but writes to a scratch directory of its own (with
``--resume``, into a private copy of the resumed run).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path
from typing import Optional

import torch

from multi_task_breast_cancer_tpu_torch.config import DEFAULT_CONFIG_YAML, load_config
from multi_task_breast_cancer_tpu_torch.parallel import multihost
from multi_task_breast_cancer_tpu_torch.train.driver import run_experiment

DEFAULT_CONFIG_PATHS = ("./config.yaml", "./src/config.yaml")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None,
                        help="YAML config (defaults to ./config.yaml or ./src/config.yaml)")
    parser.add_argument("--run-root", default="runs")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous (multi-process runs "
                             "started by hand; torchrun's environment is detected)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
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


def run_entry(task: str, mode: str, argv=None) -> Optional[str]:
    """Run the experiment; returns the run directory (``None`` in the
    command that only started one worker per GPU)."""
    args = parse_args(argv)
    # the process group comes before any device query
    active = multihost.initialize(coordinator_address=args.coordinator,
                                  num_processes=args.num_processes,
                                  process_id=args.process_id)
    config_path = resolve_config_path(args)
    cfg = load_config(config_path)
    n_gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not active and cfg.training.data_parallel and n_gpus > 1:
        argv = sys.argv[1:] if argv is None else list(argv)
        code = multihost.launch_local_workers(
            n_gpus, [sys.executable, "-m", __name__, task, mode, *argv])
        if code:
            sys.exit(f"a training worker failed with exit code {code}")
        return None
    run_root = multihost.coordinator_run_root(args.run_root)
    resume = args.resume
    if resume is not None and multihost.process_count() > 1:
        if run_root != args.run_root:
            # a resumed run writes into its directory: the other ranks replay
            # it in a private copy, taken before rank 0 goes on
            dst = str(Path(run_root) / Path(resume.rstrip("/")).name)
            shutil.copytree(resume, dst)
            resume = dst
        multihost.barrier()
    return run_experiment(cfg, task=task, mode=mode, config_src=config_path,
                          run_root=run_root, resume_dir=resume)


if __name__ == "__main__":  # a worker started by run_entry: TASK MODE [flags]
    run_entry(sys.argv[1], sys.argv[2], sys.argv[3:])
