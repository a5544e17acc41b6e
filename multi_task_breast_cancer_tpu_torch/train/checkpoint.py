"""Checkpoints of the train state (twin of
``multi_task_breast_cancer_tpu/train/checkpoint.py``).

The port's format is ``torch.save`` of the reference's own dict, ``epoch``,
``model_state_dict`` (parameters and buffers: ResidualUNet's batch
statistics), ``optimizer_state_dict``, ``val_loss``
(``training_multitask.py:243-249`` of the reference), with two more keys, as
the JAX package writes them: ``step`` and ``resume_state``, the host-side
scheduler and early-stopping counters (:data:`EMPTY_RESUME_STATE`; ``valid``
is 1.0 when they were saved). Tensors are stored on the CPU, and the
optimizer's state as the plain optimizer holds it
(``optim.host_state_dict``: the learning rate a float, ``capturable`` off),
so the card's graph-safe optimizers write the bytes a plain one writes; a
resume on the card makes it graph-safe again (``optim.device_hyperparameters``:
the rate a device tensor, Adam's step on the device). A file is
written to ``<path>.tmp`` and moved over ``<path>`` with ``os.replace``, so a
kill mid-write never destroys the previous good file.

``load_pretrained_model`` restores the weights only (the reference's
optimizer restore is commented out, ``src/utils/models.py:29-31``);
``restore_checkpoint`` restores the weights, the optimizer's state, the step
count, the epoch and the resume counters. A parameter whose shape differs from the
model's raises ``ValueError``, as the JAX ``_check_shapes`` does.

Both read the JAX package's flax-msgpack checkpoints too, current and legacy
(written before ``resume_state`` existed), decoded by :mod:`.flax_msgpack`
without flax: the weights and any batch statistics map through
``models/jax_weights.params_from_jax``, and ``restore_checkpoint`` carries
optax Adam's ``mu`` / ``nu`` / ``count`` and
injected learning rate into ``torch.optim.Adam``'s (or ``AdamW``'s)
``exp_avg`` / ``exp_avg_sq`` / ``step`` and ``lr``, and optax SGD's Nesterov
``trace`` into ``torch.optim.SGD``'s ``momentum_buffer``, so a JAX run
resumes in the port.
"""

from __future__ import annotations

import copy
import io
import logging
import os
import sys
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax
from multi_task_breast_cancer_tpu_torch.train.flax_msgpack import msgpack_restore
from multi_task_breast_cancer_tpu_torch.train.optim import device_hyperparameters, host_state_dict
from multi_task_breast_cancer_tpu_torch.train.state import TrainState

EMPTY_RESUME_STATE: Dict[str, float] = {
    "valid": 0.0, "sched_lr": 0.0, "sched_best": 0.0, "sched_bad": 0.0,
    "sched_epoch": 0.0, "patience": 0.0, "best_val_loss": 0.0,
}


class StateSnapshot(NamedTuple):
    """A copy of a train state on its device (the best epoch's, kept until
    the fold's one checkpoint write)."""
    model_state_dict: dict
    optimizer_state_dict: dict
    step: int


def snapshot(state: TrainState) -> StateSnapshot:
    """Device-to-device copies of the weights and the optimizer state: no
    host fetch."""
    return StateSnapshot({k: v.detach().clone() for k, v in state.model.state_dict().items()},
                         copy.deepcopy(host_state_dict(state.optimizer)), int(state.step))


def _to_cpu(obj):
    """Tensors to the CPU, and every string interned: pickle writes a string
    once per object, so equal strings that are distinct objects (as after an
    optimizer's ``load_state_dict``) would give a resumed run other bytes."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, str):
        return sys.intern(obj)
    if isinstance(obj, dict):
        return {_to_cpu(k): _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state: Union[TrainState, StateSnapshot], epoch: int,
                    val_loss: float, resume_state: Optional[Dict[str, float]] = None) -> None:
    if isinstance(state, TrainState):
        state = StateSnapshot(state.model.state_dict(), host_state_dict(state.optimizer),
                              int(state.step))
    rs = dict(EMPTY_RESUME_STATE)
    if resume_state is not None:
        rs.update(resume_state, valid=1.0)
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _to_cpu(state.model_state_dict),
        "optimizer_state_dict": _to_cpu(state.optimizer_state_dict),
        "val_loss": float(val_loss),
        "step": int(state.step),
        "resume_state": {k: float(v) for k, v in rs.items()},
    }
    # through a buffer: torch.save names the archive inside the file after
    # the file, so equal states would give different bytes under the run
    # dirs' different timestamps
    buf = io.BytesIO()
    torch.save(payload, buf)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def is_torch_checkpoint(path: str) -> bool:
    """True for a file ``torch.save`` wrote: a zip archive, which opens with
    a local file header (a flax-msgpack file opens with a map header)."""
    if not os.path.isfile(path):
        return False
    with open(path, "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def _read_flax(path: str, model: torch.nn.Module) -> dict:
    """A JAX checkpoint as the port's payload: the weights (and the batch
    statistics, ``model_state_dict["batch_stats"]``) as ``model``'s
    ``state_dict``; optax's state kept, under ``jax_optimizer_state``, for
    ``restore_checkpoint``; a legacy file's counters empty (``valid`` 0)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        raw = msgpack_restore(data)
    except (ValueError, TypeError) as e:  # TypeError: a dtype name numpy lacks
        raise ValueError(f"'{path}' is neither a torch.save checkpoint nor a "
                         f"flax-msgpack one: {e}") from e
    if not (isinstance(raw, dict) and "model_state_dict" in raw):
        raise ValueError(f"'{path}' holds no model_state_dict")
    return {
        "epoch": int(raw["epoch"]),
        "model_state_dict": params_from_jax(raw["model_state_dict"], model),
        "jax_optimizer_state": raw["optimizer_state_dict"],
        "val_loss": float(raw["val_loss"]),
        "step": int(raw.get("step", 0)),
        "resume_state": raw.get("resume_state", dict(EMPTY_RESUME_STATE)),
    }


def _load(path: str, model: torch.nn.Module) -> dict:
    if not os.path.isfile(path):
        raise ValueError(f"\n\t-> No checkpoint found at '{path}'")
    if is_torch_checkpoint(path):
        payload = torch.load(path, map_location="cpu", weights_only=True)
    else:
        payload = _read_flax(path, model)
    check_fits(payload["model_state_dict"], model)
    return payload


def check_fits(state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module,
               what: str = "checkpoint") -> None:
    """Raise ``ValueError`` naming the parameters of ``state_dict`` that are
    missing, unexpected or of another shape than ``model``'s."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    bad = [(k, got.get(k), want.get(k)) for k in sorted(set(want) | set(got))
           if got.get(k) != want.get(k)]
    if bad:
        detail = "; ".join(f"{k}: {what} {cs} vs model {ms}" for k, cs, ms in bad[:5])
        raise ValueError(
            f"{what} does not fit this model: {len(bad)} parameter shape "
            f"mismatch(es) — wrong architecture/width? ({detail})")


def _optimizer_state_from_jax(opt_state: dict, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> dict:
    """optax ``inject_hyperparams(...)`` state → the optimizer's
    ``state_dict``; ``hyperparams`` holds the lr. ``inner_state["0"]`` is

    - ``ScaleByAdamState`` (count, mu, nu) of ``adam | adamw``: Adam's or
      AdamW's step and moments;
    - ``TraceState`` (trace) of ``sgd(momentum, nesterov)``: SGD's
      ``momentum_buffer``. optax's Nesterov trace ``t ← g + m·t`` (update
      ``g + m·t``) and torch's buffer without dampening ``b ← m·b + g``
      (step ``g + m·b``) are one recursion from zero.

    The trees map like the weights."""
    inner = opt_state.get("inner_state", {}).get("0", {})
    names = [name for name, _ in model.named_parameters()]
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)) \
            and {"count", "mu", "nu"} <= set(inner):
        mu, nu = params_from_jax(inner["mu"], model), params_from_jax(inner["nu"], model)
        step = torch.tensor(float(inner["count"]), dtype=torch.float32)
        state = {i: {"step": step.clone(), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                 for i, name in enumerate(names)}
    elif isinstance(optimizer, torch.optim.SGD) and "trace" in inner:
        trace = params_from_jax(inner["trace"], model)
        state = {i: {"momentum_buffer": trace[name]} for i, name in enumerate(names)}
    else:
        raise ValueError(
            f"only Adam's, AdamW's and SGD's state is carried over from a JAX checkpoint; "
            f"got optax state {sorted(inner)} for {type(optimizer).__name__}")
    sd = optimizer.state_dict()
    sd["state"] = state
    for group in sd["param_groups"]:
        group["lr"] = float(opt_state["hyperparams"]["learning_rate"])
    return sd


def load_pretrained_model(state: TrainState, ckpt_path: str) -> TrainState:
    """Weights-only restore (reference parity), into ``state.model``."""
    payload = _load(ckpt_path, state.model)
    logging.info("Loaded checkpoint '%s'. Last epoch: %s", ckpt_path, payload["epoch"])
    state.model.load_state_dict(payload["model_state_dict"], strict=True)
    return state


def restore_checkpoint(state: TrainState, ckpt_path: str
                       ) -> Tuple[TrainState, int, float, Dict[str, float]]:
    """Full restore (weights, optimizer, step, epoch, resume counters) for a
    resume mid-training. A checkpoint without ``resume_state`` restores with
    ``valid == 0``."""
    payload = _load(ckpt_path, state.model)
    state.model.load_state_dict(payload["model_state_dict"], strict=True)
    if "jax_optimizer_state" in payload:
        state.optimizer.load_state_dict(_optimizer_state_from_jax(
            payload["jax_optimizer_state"], state.model, state.optimizer))
    else:
        state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    device_hyperparameters(state.optimizer)
    state.step = int(payload["step"])
    resume = dict(EMPTY_RESUME_STATE)
    resume.update({k: float(v) for k, v in payload.get("resume_state", {}).items()})
    return state, int(payload["epoch"]), float(payload["val_loss"]), resume
