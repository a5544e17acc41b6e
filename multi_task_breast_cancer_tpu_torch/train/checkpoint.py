"""Checkpoints of the train state (twin of
``multi_task_breast_cancer_tpu/train/checkpoint.py``).

The port's format is ``torch.save`` of the reference's own dict, ``epoch``,
``model_state_dict``, ``optimizer_state_dict``, ``val_loss``
(``training_multitask.py:243-249`` of the reference), with two more keys, as
the JAX package writes them: ``step`` and ``resume_state``, the host-side
scheduler and early-stopping counters (:data:`EMPTY_RESUME_STATE`; ``valid``
is 1.0 when they were saved). Tensors are stored on the CPU. A file is
written to ``<path>.tmp`` and moved over ``<path>`` with ``os.replace``, so a
kill mid-write never destroys the previous good file.

``load_pretrained_model`` restores the weights only (the reference's
optimizer restore is commented out, ``src/utils/models.py:29-31``);
``restore_checkpoint`` restores the weights, Adam's moments, the step count,
the epoch and the resume counters. A parameter whose shape differs from the
model's raises ``ValueError``, as the JAX ``_check_shapes`` does. The JAX
package's flax-msgpack checkpoints are not read here (``ROADMAP.md``).
"""

from __future__ import annotations

import copy
import io
import logging
import os
import sys
import zipfile
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

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
                         copy.deepcopy(state.optimizer.state_dict()), int(state.step))


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
        state = StateSnapshot(state.model.state_dict(), state.optimizer.state_dict(),
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
    """True for a file ``torch.save`` wrote (a zip archive)."""
    return os.path.isfile(path) and zipfile.is_zipfile(path)


def _load(path: str, model: torch.nn.Module) -> dict:
    if not os.path.isfile(path):
        raise ValueError(f"\n\t-> No checkpoint found at '{path}'")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in payload["model_state_dict"].items()}
    bad = [(k, got.get(k), want.get(k)) for k in sorted(set(want) | set(got))
           if got.get(k) != want.get(k)]
    if bad:
        detail = "; ".join(f"{k}: checkpoint {cs} vs model {ms}" for k, cs, ms in bad[:5])
        raise ValueError(
            f"checkpoint does not fit this model: {len(bad)} parameter shape "
            f"mismatch(es) — wrong architecture/width? ({detail})")
    return payload


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
    state.optimizer.load_state_dict(payload["optimizer_state_dict"])
    state.step = int(payload["step"])
    resume = dict(EMPTY_RESUME_STATE)
    resume.update({k: float(v) for k, v in payload.get("resume_state", {}).items()})
    return state, int(payload["epoch"]), float(payload["val_loss"]), resume
