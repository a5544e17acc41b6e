"""The port's training Engine against the JAX Engine.

Same initial weights (JAX ``init`` → ``params_from_jax``), same fold, same
epoch plan: three real steps and one cross-fold padding step of
``train_and_eval_epoch`` with the flagship's objective (fused DICE with
inverse deep-supervision weights + Focal, α = 0.35, Adam(1e-4, eps 1e-4)),
MTnnUNet at narrow widths (4, 8, 8, 16, 16) on 64² images, augmentation off
(the JAX draws cannot be reproduced in torch; the augmentation paths have
their own bit-exact tests). The port runs on the CPU, where the norm takes
its plain forward and backward.

Tolerances: epoch metrics 1e-4 relative (+1e-6 absolute): f32 losses of two
frameworks whose convolutions sum in different orders. Final parameters
2e-6 absolute: three Adam steps of lr 1e-4 move a parameter by at most
≈ 3e-4, and a gradient that differs in its last digits moves the update by
far less than 1 % of that.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax
from multi_task_breast_cancer_tpu_torch.train.loop import (
    Engine,
    EngineConfig,
    plan_epoch_indices,
    step_valid_mask,
)
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

WIDTHS = (4, 8, 8, 16, 16)
SIZE = 64
B = 2


def _fold(n, seed, size=SIZE):
    """A synthetic fold as the driver would hold it: uint8-valued images with
    a bright blob on the lesion, binary masks, empty masks for 'normal' (2)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    labels = (np.arange(n) % 3).astype(np.int32)
    masks = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):
        if labels[i] != 2:
            cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
            r = rng.integers(size // 10, size // 5)
            masks[i, ..., 0] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    images = np.clip(rng.normal(90, 30, masks.shape) + 80 * masks, 0, 255).round()
    return ArrayDataset(images=images.astype(np.float32), masks=masks, labels=labels,
                        patient_ids=np.arange(n), class_names=["benign"] * n,
                        tumor_pixels=masks.sum(axis=(1, 2, 3)).astype(np.int64))


def _cfg(**kw):
    return EngineConfig(task="multitask", n_classes=3, batch_size=B, alpha=0.35,
                        inversely_weighted=True, seg_criterion="DICE",
                        cls_criterion="Focal", **kw)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX Engine's epoch: initial params, final params, metrics, plan."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.models.multitask import MTnnUNet
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState

    train, val = _fold(6, 0), _fold(4, 1)
    perm = plan_epoch_indices(len(train), B, np.random.default_rng(3), pad_to_steps=4)
    valid = step_valid_mask(len(train), B, 4)
    assert valid.tolist() == [1, 1, 1, 0]

    model = MTnnUNet(widths=WIDTHS)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))["params"]
    init = jax.tree_util.tree_map(np.asarray, params)
    tx = init_optimizer("Adam", 1e-4)
    engine = JL.Engine(model, tx, JL.EngineConfig(
        task="multitask", n_classes=3, batch_size=B, alpha=0.35, inversely_weighted=True,
        seg_criterion="DICE", cls_criterion="Focal", use_transforms=False))
    state = TrainState(params=params, batch_stats=FrozenDict(), opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    as_jax = lambda ds: JaxDataset(**vars(ds))  # noqa: E731
    state, tm, vm = engine.train_and_eval_epoch(
        state, engine.device_data(as_jax(train)),
        engine.device_data(as_jax(val), for_training=False),
        perm, jax.random.PRNGKey(1), valid)
    final = jax.tree_util.tree_map(np.asarray, state.params)
    return {"init": init, "final": final, "tm": tm, "vm": vm, "step": int(state.step),
            "train": train, "val": val, "perm": perm, "valid": valid}


def _port_engine(init_params, **cfg_kw):
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    model.load_state_dict(params_from_jax(init_params, model), strict=True)
    engine = Engine(model, _cfg(**cfg_kw), device="cpu")
    return engine, create_train_state(engine.model, "Adam", 1e-4)


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= 1e-4 * abs(want) + 1e-6


def test_engine_epoch_matches_jax_engine(jax_run):
    engine, state = _port_engine(jax_run["init"], use_transforms=False)
    train = engine.device_data(jax_run["train"])
    val = engine.device_data(jax_run["val"], for_training=False)
    assert train["images"].dtype == torch.uint8 and train["images"].shape == (6, 1, SIZE, SIZE)
    state, tm, vm = engine.train_and_eval_epoch(state, train, val, jax_run["perm"],
                                                step_valid=jax_run["valid"])
    assert state.step == jax_run["step"] == 3
    assert set(tm) == set(jax_run["tm"]) and set(vm) == set(jax_run["vm"])
    for got, want in ((tm, jax_run["tm"]), (vm, jax_run["vm"])):
        bad = {k: (got[k], want[k]) for k in want if not _close(got[k], want[k])}
        assert not bad, bad
    final = params_from_jax(jax_run["final"], state.model)
    worst = max((state.model.state_dict()[k] - v).abs().max().item()
                for k, v in final.items())
    moved = max((state.model.state_dict()[k] - v).abs().max().item()
                for k, v in params_from_jax(jax_run["init"], state.model).items())
    assert worst <= 2e-6 and moved > 1e-5, (worst, moved)


@pytest.mark.parametrize("fast", [False, True])
def test_padding_steps_are_no_ops(jax_run, fast):
    """An epoch with a padding step equals the same epoch without it, bit for
    bit: parameters, Adam moments and step count (augmentation on, so the
    draws of the real steps must not depend on the padding either)."""
    runs = []
    for perm, valid in ((jax_run["perm"], jax_run["valid"]),
                        (jax_run["perm"][:6], np.ones(3, np.float32))):
        engine, state = _port_engine(jax_run["init"], use_transforms=True,
                                     fast_augmentation=fast)
        data = engine.device_data(jax_run["train"])
        assert ("aug_packed" in data) == fast
        state, tm = engine.train_epoch(state, data, perm, torch.Generator().manual_seed(7),
                                       valid)
        assert np.isfinite(tm["loss"])
        runs.append((state, tm))
    (a, tma), (b, tmb) = runs
    assert a.step == b.step == 3 and tma == tmb
    for (k, pa), pb in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(pa, pb), k
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_fast_augmentation_epoch_and_predict(jax_run):
    """Two epochs on the fast path with the plateau scheduler, as the driver
    runs them; then the Engine's batched predict."""
    from multi_task_breast_cancer_tpu_torch.train.optim import (
        PlateauScheduler,
        set_learning_rate,
    )

    engine, state = _port_engine(jax_run["init"], fast_augmentation=True)
    train = engine.device_data(jax_run["train"], pad_to=8)
    val = engine.device_data(jax_run["val"], for_training=False)
    assert train["aug_packed"].shape == (8, 2, SIZE, SIZE)
    assert "aug_packed" not in val
    sched = PlateauScheduler(base_lr=1e-4, patience=0)
    gen = torch.Generator().manual_seed(0)
    for epoch in range(2):
        perm = plan_epoch_indices(6, B, np.random.default_rng(epoch), pad_to_steps=4)
        state, tm, vm = engine.train_and_eval_epoch(state, train, val, perm, gen,
                                                    step_valid_mask(6, B, 4))
        assert all(np.isfinite(v) for v in (*tm.values(), *vm.values()))
        set_learning_rate(state.optimizer, sched.step(vm["loss"]))
    assert state.step == 6
    (cls,), seg = engine.predict(state, jax_run["val"].images, max_batch=3, pad_to=5)
    assert cls.shape == (4, 3) and [s.shape for s in seg] == [(4, 1, SIZE, SIZE)] * 4
    (cls_full,), _ = engine.predict(state, jax_run["val"].images)
    torch.testing.assert_close(cls, cls_full, rtol=0, atol=1e-5)


def test_engine_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, _cfg())
    assert Engine(model, _cfg(), device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("kw,err", [({"seg_criterion": "NoSuchLoss"}, ValueError),
                                    ({"task": "detection"}, ValueError)])
def test_engine_rejects_what_is_not_ported(kw, err):
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    cfg = _cfg()
    for k, v in kw.items():
        setattr(cfg, k, v)
    with pytest.raises(err):
        Engine(model, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        Engine(model, _cfg(), device="cpu", mesh=object())


def test_batches_reach_the_model_nchw_contiguous(jax_run):
    """Every conv input and output on a training step has NCHW strides, on
    both augmentation paths (the fused norm refuses anything else on the
    card)."""
    for fast in (False, True):
        engine, state = _port_engine(jax_run["init"], fast_augmentation=fast)
        data = engine.device_data(jax_run["train"])
        seen = []
        hooks = [m.register_forward_hook(lambda _m, i, o: seen.append((i[0], o)))
                 for m in engine.model.modules() if isinstance(m, torch.nn.Conv2d)]
        engine.train_epoch(state, data, jax_run["perm"][:2], torch.Generator().manual_seed(1))
        for h in hooks:
            h.remove()
        assert seen and all(
            t.stride() == (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3],
                           t.shape[3], 1) for pair in seen for t in pair)


def test_fast_batch_reaches_the_model_without_a_copy(monkeypatch):
    """At 128² f32 with the fast augmentation, the image that reaches the
    model and the mask that reaches the loss share storage with the
    augmentation's output (no clone), with exact NCHW strides; and the
    epoch's draws hold the gather factors, not (steps, B, 3, S, S) index
    planes."""
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA

    size = 128
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    engine = Engine(model, _cfg(fast_augmentation=True), device="cpu")
    state = create_train_state(engine.model, "Adam", 1e-4)
    data = engine.device_data(_fold(4, 2, size))
    outs, seen = [], {}
    real_augment, real_losses = FA.fast_augment, engine._losses

    def augment(*args, **kwargs):
        outs.append(real_augment(*args, **kwargs))
        return outs[-1]

    def losses(out, masks, cls_targets):
        seen.setdefault("mask", masks)
        return real_losses(out, masks, cls_targets)

    monkeypatch.setattr(FA, "fast_augment", augment)
    monkeypatch.setattr(engine, "_losses", losses)
    engine.model.register_forward_pre_hook(lambda _m, args: seen.setdefault("image", args[0]))
    engine.train_epoch(state, data, np.array([3, 1]), torch.Generator().manual_seed(1))
    assert len(outs) == 1 and set(seen) == {"image", "mask"}
    for name, t in seen.items():
        assert t.untyped_storage().data_ptr() == outs[0].untyped_storage().data_ptr(), name
        assert t.shape == (B, 1, size, size) and t.stride() == (size * size, size * size, size, 1)

    steps = 5
    draws = engine._epoch_draws(steps, torch.Generator().manual_seed(2))
    assert set(draws) == {"factors"}
    assert [tuple(f.shape) for f in draws["factors"]] == [
        (steps, B, 3), (steps, B, 3), (steps, B, 3, size), (steps, B)]
