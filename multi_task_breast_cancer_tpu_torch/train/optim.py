"""Optimizers and learning-rate schedulers (twin of
``multi_task_breast_cancer_tpu/train/optim.py``).

Optimizers are ``torch.optim`` ones (SGD the port's :class:`DeviceLrSGD`,
a ``torch.optim.SGD``) with the reference factory's hyper-parameters
(``src/utils/experiment_init.py:177-196``), which the JAX package gives
optax: Adam(eps=1e-4), SGD(momentum 0.9, nesterov), AdamW(weight_decay
0.01, eps 1e-8). Their updates equal optax's (``tests/test_torch_optim.py``). The learning rate lives in the optimizer's
``param_groups``, where the host-side schedulers set it between epochs.

On CUDA the optimizers are built so that a CUDA graph can replay their step
(:mod:`..graphs`): the learning rate is a 0-d float32 tensor on the device,
which :func:`set_learning_rate` fills in place (a Python float would be
baked into the captured kernels, and a replay would keep the old rate);
Adam and AdamW run ``capturable=True`` (their step count lives on the
device); SGD is :class:`DeviceLrSGD` on every device, because
``torch.optim.SGD``'s own step turns a tensor rate into a host number
(``.item()``), which a capture refuses. The eager Engine on the card uses
the same optimizers, so a graphed and an eager run share their arithmetic
bit for bit. The exact float last set is kept beside the tensor
(``host_lr``), and :func:`host_state_dict` gives the state as the plain
optimizer holds it (the float rate, ``capturable`` off), which is what
checkpoints store. On the CPU the rate stays a float and Adam and AdamW
are not ``capturable``.

Schedulers are copies of the JAX package's torch-semantics twins:
ReduceLROnPlateau(mode='min') and CosineAnnealingLR, stepped per epoch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Iterable, Optional

import torch


class DeviceLrSGD(torch.optim.SGD):
    """``torch.optim.SGD(momentum, nesterov=True)`` whose update reads its
    learning rate, a 0-d tensor, on the device: buffer ``b ← m·b + g`` (``g``
    on the first step, as torch), update ``u = g + m·b``, ``p ← p − lr·u``.
    The same recursion as torch's; the rate multiplies the update before the
    subtraction (optax's order) instead of being the subtraction's ``alpha``,
    a host number. Without weight decay or dampening, as the reference's SGD."""

    def __init__(self, params, lr, momentum: float):
        super().__init__(params, lr=lr, momentum=momentum, nesterov=True)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            m = group["momentum"]
            bufs = [self.state[p].get("momentum_buffer") for p in params]
            old = [i for i, b in enumerate(bufs) if b is not None]
            if old:
                torch._foreach_mul_([bufs[i] for i in old], m)
                torch._foreach_add_([bufs[i] for i in old], [grads[i] for i in old])
            for i, p in enumerate(params):
                if bufs[i] is None:
                    bufs[i] = self.state[p]["momentum_buffer"] = grads[i].detach().clone()
            update = torch._foreach_add(grads, bufs, alpha=m)
            torch._foreach_mul_(update, group["lr"])
            torch._foreach_sub_(params, update)


def init_optimizer(opt: str, learning_rate: float,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """The reference's optimizer over ``params``; an unknown name falls back
    to SGD(lr=0.001, momentum 0.9, nesterov), as the reference does. On CUDA
    parameters, the graph-safe form (module docstring)."""
    params = list(params)
    cuda = bool(params) and params[0].device.type == "cuda"
    if opt not in ("Adam", "SGD", "AdamW"):
        logging.info("The optimizer '%s' is not recognized. SGD will be used instead.", opt)
        opt, learning_rate = "SGD", 0.001
    if opt == "Adam":
        optimizer = torch.optim.Adam(params, lr=learning_rate, eps=1e-4, capturable=cuda)
    elif opt == "AdamW":
        # torch AdamW defaults (weight_decay=0.01), which the reference uses
        optimizer = torch.optim.AdamW(params, lr=learning_rate, weight_decay=0.01, eps=1e-8,
                                      capturable=cuda)
    else:
        optimizer = DeviceLrSGD(params, lr=learning_rate, momentum=0.9)
    return device_hyperparameters(optimizer)


def device_hyperparameters(optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """The graph-safe form of ``optimizer``, in place, when its parameters
    are on a CUDA device: every group's rate a 0-d float32 tensor there (the
    float kept as ``host_lr``), ``capturable`` on where the optimizer has
    it, and Adam's step counts on the device. Also what a resume calls after
    ``load_state_dict``, which brings back the host form. On the CPU
    ``optimizer`` is left as it is."""
    device = next((p.device for g in optimizer.param_groups for p in g["params"]), None)
    if device is None or device.type != "cuda":
        return optimizer
    for group in optimizer.param_groups:
        if not torch.is_tensor(group["lr"]):
            group["host_lr"] = float(group["lr"])
            group["lr"] = torch.tensor(group["host_lr"], dtype=torch.float32, device=device)
        if "capturable" in group:
            group["capturable"] = True
    for state in optimizer.state.values():
        if torch.is_tensor(state.get("step")):
            state["step"] = state["step"].to(device, torch.float32)
    return optimizer


def host_state_dict(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` as the plain optimizer holds it: each
    group's rate the float last set, ``capturable`` off; tensors stay where
    they are. What checkpoints store, so that a graph-safe optimizer writes
    the bytes a plain one writes."""
    sd = optimizer.state_dict()
    groups = []
    for group in sd["param_groups"]:
        group = dict(group)
        if "host_lr" in group:
            group["lr"] = group.pop("host_lr")
            if "capturable" in group:
                group["capturable"] = False
        groups.append(group)
    return {"state": sd["state"], "param_groups": groups}


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Write the learning rate into every parameter group: a tensor rate is
    filled in place (a replayed graph reads it), a float one replaced."""
    for group in optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(float(lr))
            group["host_lr"] = float(lr)
        else:
            group["lr"] = float(lr)
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    """The rate last set, as a float."""
    group = optimizer.param_groups[0]
    return float(group.get("host_lr", group["lr"]))


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
