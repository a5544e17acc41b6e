"""The port's checkpoints (``train/checkpoint.py``): a save / restore round
trip of the weights, Adam's moments, the step count and the resume
counters; atomic writes; shape mismatches; checkpoints without resume
counters. Serving a checkpoint the driver wrote is in
``tests/test_torch_serving.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.train import checkpoint as C
from multi_task_breast_cancer_tpu_torch.train.driver import _find_checkpoint
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

WIDTHS = (4, 8, 8, 16, 16)
RESUME = {"sched_lr": 5e-5, "sched_best": 0.75, "sched_bad": 2.0, "sched_epoch": 0.0,
          "patience": 3.0, "best_val_loss": 0.75}


def _state(seed: int = 0, widths=WIDTHS):
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=widths,
                                          generator=torch.Generator().manual_seed(seed))
    engine = Engine(model, EngineConfig(task="multitask", use_transforms=False), device="cpu")
    return engine, create_train_state(engine.model, "Adam", 1e-3)


def _trained_state():
    """A state one Adam step in, so the moments are not zero."""
    engine, state = _state()
    rng = np.random.default_rng(0)
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    ds = ArrayDataset(images=rng.integers(0, 256, (2, 32, 32, 1)).astype(np.float32),
                      masks=(rng.random((2, 32, 32, 1)) > 0.7).astype(np.float32),
                      labels=np.array([0, 2], np.int32), patient_ids=np.arange(2),
                      class_names=["benign", "normal"], tumor_pixels=np.zeros(2, np.int64))
    engine.train_epoch(state, engine.device_data(ds), np.array([0, 1]))
    return state


def _assert_same_state(a, b) -> None:
    assert a.step == b.step
    for (k, va), vb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]


def test_round_trip_restores_weights_moments_step_and_counters(tmp_path):
    state = _trained_state()
    assert state.step == 1
    path = str(tmp_path / "model_20260101_000000_fold_0")
    C.save_checkpoint(path, state, epoch=4, val_loss=0.75, resume_state=RESUME)
    _, fresh = _state(seed=1)
    restored, epoch, val_loss, resume = C.restore_checkpoint(fresh, path)
    assert (epoch, val_loss) == (4, 0.75)
    assert resume == dict(RESUME, valid=1.0)
    _assert_same_state(restored, state)
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"epoch", "model_state_dict", "optimizer_state_dict", "val_loss",
                            "step", "resume_state"}
    assert set(payload["resume_state"]) == set(C.EMPTY_RESUME_STATE)


def test_snapshot_is_a_copy_and_saves_like_the_state(tmp_path):
    state = _trained_state()
    snap = C.snapshot(state)
    C.save_checkpoint(str(tmp_path / "from_state"), state, 1, 0.5, RESUME)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)  # training goes on; the snapshot must not move
    C.save_checkpoint(str(tmp_path / "from_snapshot"), snap, 1, 0.5, RESUME)
    assert (tmp_path / "from_state").read_bytes() == (tmp_path / "from_snapshot").read_bytes()


def test_weights_only_restore_leaves_the_optimizer(tmp_path):
    state = _trained_state()
    path = str(tmp_path / "ckpt")
    C.save_checkpoint(path, state, 0, 1.0)
    _, fresh = _state(seed=1)
    C.load_pretrained_model(fresh, path)
    for (k, va), vb in zip(fresh.model.state_dict().items(), state.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert not fresh.optimizer.state and fresh.step == 0


def test_a_leftover_tmp_never_shadows_the_good_file(tmp_path):
    state = _trained_state()
    path = tmp_path / "fold_0" / "model_20260101_000000_fold_0"
    path.parent.mkdir()
    C.save_checkpoint(str(path), state, 2, 0.5, RESUME)
    good = path.read_bytes()
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(b"torn write from a killed process")
    assert C.restore_checkpoint(_state(seed=1)[1], str(path))[1] == 2
    assert _find_checkpoint(str(tmp_path), 0, str(tmp_path / "renamed")) == str(path)
    C.save_checkpoint(str(path), state, 3, 0.4, RESUME)  # the next write replaces both
    assert not tmp.exists() and path.read_bytes() != good
    assert C.restore_checkpoint(_state(seed=1)[1], str(path))[1] == 3


def test_a_shape_mismatch_raises_value_error(tmp_path):
    path = str(tmp_path / "ckpt")
    C.save_checkpoint(path, _state()[1], 0, 1.0)
    _, other = _state(widths=(4, 8, 8, 16, 24))
    with pytest.raises(ValueError, match="shape mismatch"):
        C.load_pretrained_model(other, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore_checkpoint(other, path)
    with pytest.raises(ValueError, match="No checkpoint found"):
        C.load_pretrained_model(other, str(tmp_path / "absent"))


def test_a_checkpoint_without_resume_state_restores_with_valid_zero(tmp_path):
    state = _trained_state()
    path = str(tmp_path / "legacy")
    torch.save({"epoch": 7, "model_state_dict": state.model.state_dict(),
                "optimizer_state_dict": state.optimizer.state_dict(), "val_loss": 0.3,
                "step": 1}, path)
    restored, epoch, val_loss, resume = C.restore_checkpoint(_state(seed=1)[1], path)
    assert (epoch, val_loss, resume) == (7, 0.3, C.EMPTY_RESUME_STATE)
    _assert_same_state(restored, state)
    assert C.is_torch_checkpoint(path) and not C.is_torch_checkpoint(str(tmp_path / "absent"))

