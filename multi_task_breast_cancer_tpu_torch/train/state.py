"""Train state: the model, its optimizer and the count of steps taken (twin
of ``multi_task_breast_cancer_tpu/train/state.py``, whose pytree carries
params, batch statistics and optimizer state). The model holds the
parameters and, as buffers, the batch statistics (ResidualUNet's
``BatchNorm`` ``mean``/``var``, JAX's ``batch_stats``): its ``state_dict``
is the learned state, and training steps update both in place."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch.train.optim import init_optimizer
from multi_task_breast_cancer_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


@profiling.spanned("train.create_state")
def create_train_state(model: nn.Module, opt: str, learning_rate: float) -> TrainState:
    """A fresh state over ``model``'s parameters, on the device the model is
    on (move the model first: ``Engine`` does)."""
    return TrainState(model=model,
                      optimizer=init_optimizer(opt, learning_rate, model.parameters()))
