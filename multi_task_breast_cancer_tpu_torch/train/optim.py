"""Optimizers and learning-rate schedulers (twin of
``multi_task_breast_cancer_tpu/train/optim.py``).

Optimizers are ``torch.optim`` ones with the reference factory's
hyper-parameters (``src/utils/experiment_init.py:177-196``), which the JAX
package gives optax: Adam(eps=1e-4), SGD(momentum 0.9, nesterov),
AdamW(weight_decay 0.01, eps 1e-8). Their updates equal optax's
(``tests/test_torch_optim.py``). The learning rate lives in the optimizer's
``param_groups``, where the host-side schedulers set it between epochs.

Schedulers are copies of the JAX package's torch-semantics twins:
ReduceLROnPlateau(mode='min') and CosineAnnealingLR, stepped per epoch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Iterable, Optional

import torch


def init_optimizer(opt: str, learning_rate: float,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The reference's optimizer over ``params``; an unknown name falls back
    to SGD(lr=0.001, momentum 0.9, nesterov), as the reference does."""
    if opt == "Adam":
        return torch.optim.Adam(params, lr=learning_rate, eps=1e-4)
    if opt == "SGD":
        return torch.optim.SGD(params, lr=learning_rate, momentum=0.9, nesterov=True)
    if opt == "AdamW":
        # torch AdamW defaults (weight_decay=0.01), which the reference uses
        return torch.optim.AdamW(params, lr=learning_rate, weight_decay=0.01, eps=1e-8)
    logging.info("The optimizer '%s' is not recognized. SGD will be used instead.", opt)
    return torch.optim.SGD(params, lr=0.001, momentum=0.9, nesterov=True)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write the learning rate into every parameter group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


@dataclasses.dataclass
class PlateauScheduler:
    """torch ``ReduceLROnPlateau(mode='min')`` twin."""

    base_lr: float
    factor: float = 0.5
    patience: int = 20
    min_lr: float = 1e-6
    threshold: float = 1e-4  # relative improvement threshold (torch default)

    lr: float = dataclasses.field(init=False)
    best: float = dataclasses.field(default=math.inf, init=False)
    num_bad_epochs: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        self.lr = self.base_lr

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if new_lr < self.lr:
                logging.info("Plateau scheduler: reducing LR %.2e → %.2e", self.lr, new_lr)
            self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        """Flat float dict for checkpoint embedding (mid-training resume)."""
        return {"sched_lr": float(self.lr), "sched_best": float(self.best),
                "sched_bad": float(self.num_bad_epochs), "sched_epoch": 0.0}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["sched_lr"])
        self.best = float(d["sched_best"])
        self.num_bad_epochs = int(d["sched_bad"])


@dataclasses.dataclass
class CosineAnnealingScheduler:
    """torch ``CosineAnnealingLR`` twin (per-epoch step)."""

    base_lr: float
    t_max: int = 40
    eta_min: float = 1e-6

    epoch: int = dataclasses.field(default=0, init=False)
    lr: float = dataclasses.field(init=False)

    def __post_init__(self):
        self.lr = self.base_lr

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.epoch / self.t_max)) / 2
        return self.lr

    def state_dict(self) -> dict:
        """Flat float dict for checkpoint embedding (mid-training resume)."""
        return {"sched_lr": float(self.lr), "sched_best": 0.0,
                "sched_bad": 0.0, "sched_epoch": float(self.epoch)}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["sched_lr"])
        self.epoch = int(d["sched_epoch"])


def init_lr_scheduler(scheduler: str, base_lr: float, *, t_max: int = 20,
                      factor: float = 0.5, min_lr: float = 1e-6,
                      patience: int = 20):
    """Equivalent of ``experiment_init.py:266-283``."""
    if scheduler == "plateau":
        return PlateauScheduler(base_lr=base_lr, factor=factor,
                                patience=patience, min_lr=min_lr)
    if scheduler == "cosine":
        return CosineAnnealingScheduler(base_lr=base_lr, t_max=t_max,
                                        eta_min=min_lr)
    raise ValueError("Select a scheduler allowed: ['plateau', 'cosine']")
