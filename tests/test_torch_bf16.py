"""bfloat16 compute in the port against the JAX package's bf16 paths, on the
CPU at a small size (MTnnUNet widths (4, 8, 8, 16, 16), 32², one torch
thread).

Two frameworks' bf16 answers cannot agree bit for bit: each rounds its
convolutions, its norms (JAX rounds the normalised value to bf16 before the
LeakyReLU, the port's kernel and twin after it) and its heads at other
places, and 25 normalised layers of random weights carry those roundings to
the outputs. So each side's bf16 answer is measured against its own f32
answer, and the port's distance must be at most twice JAX's, or 1e-2,
whichever is larger ("the factor-2 rule"); port and JAX are then held to
each other directly. Measured at this size:

- forward at the initial weights (max abs error over the output's largest
  f32 magnitude, the worst output): port 0.108, JAX 0.090 (the f32 answers
  agree to 1.1e-5). Port against JAX: the served outputs (the
  class logits and the final mask head) 0.035 and 0.032, held to 5e-2; the
  deep-supervision heads, which only the training loss reads, 0.040 to
  0.123, held by the factor-2 rule and through the losses;
- losses of the three steps and the validation pass: port ≤ 6.2e-3, JAX ≤
  8.0e-3 relative; port against JAX ≤ 1.4e-2, held to 5e-2;
- the first step's gradient on the f32 masters, leaf by leaf (L2 distance
  over the norm of JAX's f32 gradient of the leaf), on the 12 leaves where
  JAX's own bf16 gradient lies within 0.1 of its f32 gradient: port ≤
  0.106, port against JAX ≤ 0.161, held to 0.25. A gradient of zero reads
  1 on each. (Elsewhere bf16 noise dominates both frameworks: the encoder
  convolutions' gradients, which the instance norms nearly cancel, read 0.7
  to 1.7 on both sides);
- the first step moves the f32 masters by Adam's first step
  ``-lr·g/(|g|+eps)`` of that gradient to 5.6e-8 (held to 2e-7; lr 1e-4);
- the parameters after three Adam steps, by how much of one update the other
  carries along its direction, ``<u, v>/<v, v>`` over the whole model (1 for
  the same update, 0 for a state left unchanged): the port's bf16 update
  carries 0.725 of its f32 update, JAX's 0.667 of its own, the port's bf16
  update 0.620 of JAX's bf16 update. Held: the port's shortfall from 1 by
  the factor-2 rule, port against JAX within 0.5 of 1.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax
from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
from multi_task_breast_cancer_tpu_torch.train import loop
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, plan_epoch_indices
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from test_torch_driver import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _cfg, _fold
from test_torch_tools import setup  # noqa: F401  (a fixture)

WIDTHS = (4, 8, 8, 16, 16)
SIZE = 32
B = 2
LR = 1e-4
DTYPES = ("float32", "bfloat16")


def _outputs(out):
    (cls,), seg = out
    return [np.asarray(cls, np.float32)] + [np.asarray(s, np.float32) for s in seg]


def _nchw(arrays):
    return [a if a.ndim == 2 else a.transpose(0, 3, 1, 2) for a in arrays]


def _rel(a, b, scale_of):
    """Max abs error of each output over its scale's largest magnitude."""
    return [float(np.abs(x - y).max() / np.abs(s).max()) for x, y, s in zip(a, b, scale_of)]


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX Engine in f32 and in bf16 from one initialisation: the forward
    on the val images, the gradient of the first step's loss, then three
    Adam steps and the validation pass."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.models.multitask import MTnnUNet
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState

    train, val = _fold(6, 0, SIZE), _fold(4, 1, SIZE)
    perm = plan_epoch_indices(len(train), B, np.random.default_rng(3))
    model = MTnnUNet(widths=WIDTHS)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))["params"]
    runs = {"init": jax.tree_util.tree_map(np.asarray, params), "train": train, "val": val,
            "perm": perm}
    as_jax = lambda ds: JaxDataset(**vars(ds))  # noqa: E731
    for dtype in DTYPES:
        tx = init_optimizer("Adam", LR)
        engine = JL.Engine(model, tx, JL.EngineConfig(
            task="multitask", n_classes=3, batch_size=B, alpha=0.35, inversely_weighted=True,
            seg_criterion="DICE", cls_criterion="Focal", use_transforms=False,
            compute_dtype=dtype))
        state = TrainState(params=params, batch_stats=FrozenDict(),
                           opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        out = _nchw(_outputs(engine.predict(state, val.images)))
        data = engine.device_data(as_jax(train))
        rows = jnp.asarray(perm[:B])
        imgs, msks = engine._to_compute(jnp.take(data["images"], rows, axis=0),
                                        jnp.take(data["masks"], rows, axis=0))
        ctgt = jnp.take(data["cls_targets"], rows, axis=0)

        def loss(p, imgs=imgs, msks=msks, ctgt=ctgt, engine=engine):
            out, _ = engine._apply(p, FrozenDict(), imgs, train=True)
            return engine._losses(out, msks, ctgt)[0]

        grad = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))
        state, tm, vm = engine.train_and_eval_epoch(
            state, data, engine.device_data(as_jax(val), for_training=False), perm,
            jax.random.PRNGKey(1))
        target = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
        runs[dtype] = {"out": out, "tm": tm, "vm": vm, "grad": params_from_jax(grad, target),
                       "final": params_from_jax(jax.tree_util.tree_map(np.asarray, state.params),
                                                target)}
    return runs


def _port_run(jax_runs, dtype):
    """The port's Engine on the same weights and batches; its optimizer's
    first step records the gradient on the f32 masters and the masters
    before and after."""
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    model.load_state_dict(params_from_jax(jax_runs["init"], model), strict=True)
    engine = Engine(model, _cfg(use_transforms=False, compute_dtype=dtype), device="cpu")
    state = create_train_state(engine.model, "Adam", LR)
    out = _outputs(engine.predict(state, jax_runs["val"].images))
    named, first = dict(state.model.named_parameters()), {}
    real_step = state.optimizer.step

    def step(*args, **kwargs):
        if first:
            return real_step(*args, **kwargs)
        first["grad"] = {k: p.grad.clone() for k, p in named.items()}
        first["before"] = {k: p.detach().clone() for k, p in named.items()}
        done = real_step(*args, **kwargs)
        first["after"] = {k: p.detach().clone() for k, p in named.items()}
        return done

    state.optimizer.step = step
    state, tm, vm = engine.train_and_eval_epoch(
        state, engine.device_data(jax_runs["train"]),
        engine.device_data(jax_runs["val"], for_training=False), jax_runs["perm"])
    return {"out": out, "tm": tm, "vm": vm, "first": first,
            "eps": state.optimizer.param_groups[0]["eps"],
            "final": {k: v.clone() for k, v in state.model.state_dict().items()}}


def _dist(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> float:
    return ((a - b).double().norm() / scale.double().norm()).item()


def _along(u: torch.Tensor, v: torch.Tensor) -> float:
    """How much of update ``v`` update ``u`` carries along ``v``'s
    direction: 1 for ``v`` itself, 0 for no update."""
    u, v = u.double(), v.double()
    return (u @ v / (v @ v)).item()


def test_bf16_engine_matches_jax_bf16_engine(jax_runs):
    port = {dtype: _port_run(jax_runs, dtype) for dtype in DTYPES}
    jax_ = {dtype: jax_runs[dtype] for dtype in DTYPES}

    # the forward (the initial weights, no step yet)
    f32 = jax_["float32"]["out"]
    assert max(_rel(port["float32"]["out"], f32, f32)) <= 1e-4
    d_port = _rel(port["bfloat16"]["out"], port["float32"]["out"], f32)
    d_jax = _rel(jax_["bfloat16"]["out"], jax_["float32"]["out"], f32)
    d_cross = _rel(port["bfloat16"]["out"], jax_["bfloat16"]["out"], f32)
    assert max(d_port) <= max(2 * max(d_jax), 1e-2), (d_port, d_jax)
    served = (d_cross[0], d_cross[-1])  # the class logits and the final mask head
    assert max(served) <= 5e-2, d_cross

    # losses and metrics of the three steps and the validation pass
    for split in ("tm", "vm"):
        for k in ("loss", "seg_loss", "cls_loss"):
            ref = abs(jax_["float32"][split][k])
            lp = abs(port["bfloat16"][split][k] - port["float32"][split][k]) / ref
            lj = abs(jax_["bfloat16"][split][k] - jax_["float32"][split][k]) / ref
            lx = abs(port["bfloat16"][split][k] - jax_["bfloat16"][split][k]) / ref
            assert lp <= max(2 * lj, 1e-2) and lx <= 5e-2, (split, k, lp, lj, lx)

    # the first step's gradient on the f32 masters, leaf by leaf, where
    # JAX's own bf16 gradient is within 0.1 of its f32 gradient
    gp32, gp16 = (port[d]["first"]["grad"] for d in DTYPES)
    gj32, gj16 = (jax_[d]["grad"] for d in DTYPES)
    assert set(gp16) == set(gj16)
    live = [k for k in gj32 if gj32[k].norm() > 0]
    assert max(_dist(gp32[k], gj32[k], gj32[k]) for k in live) <= 1e-3
    leaves = [k for k in live if _dist(gj16[k], gj32[k], gj32[k]) <= 0.1]
    assert len(leaves) >= 10, leaves

    def gradient_faults(g16):
        faults = []
        for k in leaves:
            dp = _dist(g16[k], gp32[k], gj32[k])
            dj = _dist(gj16[k], gj32[k], gj32[k])
            dx = _dist(g16[k], gj16[k], gj32[k])
            if not (dp <= max(2 * dj, 1e-2) and dx <= 0.25):
                faults.append((k, dp, dj, dx))
        return faults

    assert not gradient_faults(gp16)
    assert len(gradient_faults({k: torch.zeros_like(g) for k, g in gp16.items()})) == len(leaves)

    # the first step moves the f32 masters by Adam's first step of that gradient
    for dtype in DTYPES:
        first, eps = port[dtype]["first"], port[dtype]["eps"]
        for k, g in first["grad"].items():
            want = -LR * g / (g.abs() + eps)
            moved = first["after"][k] - first["before"][k]
            assert first["after"][k].dtype == torch.float32
            assert (moved - want).abs().max() <= 2e-7, (dtype, k)
    steps = torch.cat([(-LR * g / (g.abs() + port["bfloat16"]["eps"])).flatten()
                       for g in gp16.values()])
    assert steps.abs().max() > 2e-7  # a master left unchanged would fail the check above

    # the parameters after three Adam steps, by their update's direction
    init = params_from_jax(jax_runs["init"],
                           registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS))

    def update(final):
        return torch.cat([(final[k] - init[k]).flatten() for k in init])

    up32, up16 = (update(port[d]["final"]) for d in DTYPES)
    uj32, uj16 = (update(jax_[d]["final"]) for d in DTYPES)
    assert abs(1 - _along(up32, uj32)) <= 1e-3

    def update_holds(u16):
        return (abs(1 - _along(u16, up32)) <= max(2 * abs(1 - _along(uj16, uj32)), 1e-2)
                and abs(1 - _along(u16, uj16)) <= 0.5)

    assert update_holds(up16), (_along(up16, up32), _along(uj16, uj32), _along(up16, uj16))
    assert not update_holds(torch.zeros_like(up16))
    assert all(v.dtype == torch.float32 for v in port["bfloat16"]["final"].values())


def test_bf16_fast_augmentation_equals_jax():
    """The bf16 Engine's packed fold and its augmented batch (rows, flips
    and the 3-shear rotation on channel pairs, unpacked to NCHW) equal JAX's
    ``pack_channels`` and ``fast_joint_transform`` (its plain
    ``reference_pipeline``) on the same draws, bit for bit; the batch's
    channels keep exact NCHW strides."""
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import fast_augment as JFA
    from test_torch_fast_augment import _jax_draws

    ds = _fold(5, 4, SIZE)
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    cfg = _cfg(fast_augmentation=True, compute_dtype="bfloat16")
    cfg.batch_size = 4
    engine = Engine(model, cfg, device="cpu")
    data = engine.device_data(ds)
    stack = np.concatenate([ds.masks, ds.images], axis=-1)
    jplanes, jfmt = JFA.pack_channels(jnp.asarray(stack, jnp.float32), "bfloat16")
    assert jfmt.n_planes == 1 and tuple(engine._aug_fmt[0]) == tuple(jfmt)
    np.testing.assert_array_equal(data["aug_packed"].numpy(), np.asarray(jplanes))

    rows = np.array([4, 0, 2, 2], np.int32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JFA.fast_joint_transform(jplanes, jnp.asarray(rows), key,
                                               use_pallas=False, fmt=jfmt))
    fh, fv, angle = (torch.from_numpy(d)[None] for d in _jax_draws(key, len(rows)))
    factors = FA.pipeline_factors_from_draws(fh[0], fv[0], angle[0], jfmt.canvas)
    draws = {"factors": FA.PipelineFactors(*(f[None] for f in factors))}
    imgs, msks = engine._augmented_batch(data, torch.from_numpy(rows), draws, 0)
    assert imgs.dtype == msks.dtype == torch.bfloat16
    for got, ch in ((msks, 0), (imgs, 1)):
        assert got.stride() == (SIZE * SIZE, SIZE * SIZE, SIZE, 1)
        np.testing.assert_array_equal(got[:, 0].view(torch.int16).numpy(),
                                      want[..., ch].view(np.int16))


def test_exact_path_casts_before_the_augmentation(monkeypatch):
    """As the JAX Engine (``_to_compute`` before ``joint_transform_stack_batch``):
    the exact augmentation receives the gathered rows already in bf16, and
    the batch equals the f32 batch cast to bf16 (uint8 data: exact)."""
    seen = []
    real = loop.joint_transform_stack_batch

    def spy(stack, *args):
        seen.append(stack.dtype)
        return real(stack, *args)

    monkeypatch.setattr(loop, "joint_transform_stack_batch", spy)
    ds = _fold(4, 5, SIZE)
    rows = torch.tensor([3, 1], dtype=torch.int32)
    batches = {}
    for dtype in DTYPES:
        engine = Engine(registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS),
                        _cfg(compute_dtype=dtype), device="cpu")
        draws = engine._epoch_draws(1, torch.Generator().manual_seed(7))
        batches[dtype] = engine._augmented_batch(engine.device_data(ds), rows, draws, 0)
    assert seen == [torch.float32, torch.bfloat16]
    for got, want in zip(batches["bfloat16"], batches["float32"]):
        assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("fast", [False, True])
def test_losses_and_metrics_never_receive_bf16(monkeypatch, fast):
    """Every tensor that reaches a loss or a device metric during a bf16
    epoch, its validation pass and ``predict`` is f32 (JAX's ``_as_f32``)."""
    seen = []

    def spy(fn):
        def wrapped(*args, **kwargs):
            leaves = list(args) + list(kwargs.values())
            while leaves:
                a = leaves.pop()
                if isinstance(a, (tuple, list)):
                    leaves.extend(a)
                elif torch.is_tensor(a) and a.is_floating_point():
                    seen.append((fn.__name__, a.dtype))
            return fn(*args, **kwargs)
        return wrapped

    for mod, names in ((loop.L, ("apply_criterion_multitask",)),
                       (loop.M, ("dice_counts", "predicted_labels_from_logits"))):
        for name in names:
            monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    monkeypatch.setattr(loop, "fused_dice_criterion", spy(loop.fused_dice_criterion))
    engine = Engine(registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS),
                    _cfg(compute_dtype="bfloat16", fast_augmentation=fast), device="cpu")
    state = create_train_state(engine.model, "Adam", 1e-4)
    train, val = _fold(4, 6, SIZE), _fold(2, 7, SIZE)
    engine.train_and_eval_epoch(state, engine.device_data(train),
                                engine.device_data(val, for_training=False),
                                np.array([0, 1, 2, 3]), torch.Generator().manual_seed(1))
    (cls,), seg = engine.predict(state, val.images)
    assert {name for name, _ in seen} == {"apply_criterion_multitask", "fused_dice_criterion",
                                          "dice_counts",
                                          "predicted_labels_from_logits"}
    assert {dtype for _, dtype in seen} == {torch.float32}
    assert cls.dtype == torch.float32 and all(s.dtype == torch.float32 for s in seg)


# The tools in bf16 against the JAX tools in bf16, on one checkpoint. Masks:
# the pixels at the threshold that flip, as a share of an image (f32 allows
# 1 %, tests/test_torch_tools.py; measured in bf16: 12 of 1,024 pixels, 1.2 %).
# Probabilities: two bf16 forwards, each some 2 % of the logits' scale from
# its own f32 forward (test_bf16_engine_matches_jax_bf16_engine); measured
# 5.0e-3 (predict) and 2.7e-2 (evaluate's test set) apart.
BF16_MASK_SHARE = 0.02
BF16_PROBS_ATOL = 5e-2


def _pixels_apart(a, b) -> int:
    import cv2
    pa, pb = cv2.imread(str(a), 0) > 0, cv2.imread(str(b), 0) > 0
    k = int((pa != pb).sum())
    assert k <= BF16_MASK_SHARE * pa.size, (a.name, k)
    return k


def _check_seg_dice(tree, fj, fp, sj, sp) -> int:
    """``tests/test_torch_driver.py::_check_seg_dice`` at the bf16 share:
    each image's Dice moves by no more than its differing pixels allow."""
    import cv2
    import pandas as pd

    masks = pd.read_csv(tree / "mapping.csv").set_index(["class", "id"])["mask_path"]
    total = 0
    for i, (pid, cls) in enumerate(zip(sp["patient_id"], sp["class"])):
        name = f"segs/{cls}_{pid}_seg.png"
        k = _pixels_apart(fj / name, fp / name)
        pp = cv2.imread(str(fp / name), 0) > 0
        s = int((cv2.imread(masks[(cls, pid)], 0) > 0).sum() + pp.sum())
        tol = 3 * k / (s - k) if k else 0.0
        assert abs(sj["DICE"][i] - sp["DICE"][i]) <= tol, (name, k, sj["DICE"][i], sp["DICE"][i])
        total += k
    return total


@pytest.fixture(scope="module")
def bf16_tools(setup, tmp_path_factory):
    """The tools' fixture (``tests/test_torch_tools.py``) with its config
    switched to ``training.compute_dtype: bfloat16``."""
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml, load_config

    cfg = load_config(str(setup["cfg"]))
    cfg.training.compute_dtype = "bfloat16"
    path = tmp_path_factory.mktemp("bf16_tools") / "config.yaml"
    path.write_text(config_to_yaml(cfg))
    return {**setup, "cfg": path}


def test_predict_bf16_matches_the_jax_cli(bf16_tools, tmp_path, monkeypatch):
    """``predict`` in bf16 against the JAX ``predict`` in bf16 on one
    JAX-written checkpoint: probabilities within ``BF16_PROBS_ATOL``, classes
    equal, masks by the rule of ``tests/test_torch_tools.py`` at
    ``BF16_MASK_SHARE``."""
    import json
    import sys
    from pathlib import Path

    from multi_task_breast_cancer_tpu import predict as jax_predict
    from multi_task_breast_cancer_tpu.train import driver as jax_driver
    from multi_task_breast_cancer_tpu_torch import predict
    from test_torch_tools import SIZE as TOOLS_SIZE
    from test_torch_tools import _jax_state

    setup = bf16_tools
    args = ["--config", str(setup["cfg"]), "--task", "multitask", "--checkpoint",
            str(setup["ckpt"]), "--images", str(setup["images"]), "--size", str(TOOLS_SIZE)]
    monkeypatch.setattr(jax_driver, "create_train_state", _jax_state(setup))
    monkeypatch.setattr(sys, "argv", ["predict"] + args + ["--output", str(tmp_path / "jax")])
    jax_predict.main()
    predict.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])

    want = json.loads((tmp_path / "jax" / "predictions.json").read_text())
    got = json.loads((tmp_path / "port" / "predictions.json").read_text())
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["image"] == w["image"] and g["predicted_class"] == w["predicted_class"]
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=BF16_PROBS_ATOL)
        seg = f"segs/{Path(g['image']).stem}_seg.png"
        k = _pixels_apart(tmp_path / "jax" / seg, tmp_path / "port" / seg)
        assert abs(g["tumor_pixels"] - w["tumor_pixels"]) <= k


def test_evaluate_bf16_matches_the_jax_test_phase(bf16_tools, tmp_path, monkeypatch):
    """``evaluate`` in bf16 against the JAX ``evaluate`` with its Engine in
    bf16 (the JAX tool builds its Engine without ``compute_dtype``, so it is
    given one here): ids, classes and predicted labels equal, Dice by the
    mask rule of ``tests/test_torch_driver.py`` at ``BF16_MASK_SHARE``,
    probabilities within ``BF16_PROBS_ATOL``."""
    import functools
    import sys

    import pandas as pd

    from multi_task_breast_cancer_tpu import evaluate as jax_evaluate
    from multi_task_breast_cancer_tpu_torch import evaluate
    from test_torch_tools import _jax_state

    setup = bf16_tools
    args = ["--config", str(setup["cfg"]), "--task", "multitask", "--checkpoint",
            str(setup["ckpt"]), "--data", str(setup["uclm"])]
    monkeypatch.setattr(jax_evaluate, "create_train_state", _jax_state(setup))
    monkeypatch.setattr(jax_evaluate, "EngineConfig", functools.partial(
        jax_evaluate.EngineConfig, compute_dtype="bfloat16"))
    monkeypatch.setattr(sys, "argv", ["evaluate"] + args + ["--output", str(tmp_path / "jax")])
    jax_evaluate.main()
    evaluate.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])

    fj, fp = tmp_path / "jax", tmp_path / "port"
    sj = pd.read_csv(fj / "results_segmentation.csv")
    sp = pd.read_csv(fp / "results_segmentation.csv")
    assert list(sj.columns) == list(sp.columns) and len(sp) == 9
    pd.testing.assert_series_equal(sj["patient_id"], sp["patient_id"])
    pd.testing.assert_series_equal(sj["class"], sp["class"])
    _check_seg_dice(setup["uclm"], fj, fp, sj, sp)
    cj = pd.read_csv(fj / "results_classification.csv")
    cp = pd.read_csv(fp / "results_classification.csv")
    assert list(cj.columns) == list(cp.columns)
    probs = [c for c in cj.columns if c.startswith("prob")]
    assert probs
    for col in ("patient_id", "ground_truth", "predicted_label"):
        pd.testing.assert_series_equal(cj[col], cp[col])
    np.testing.assert_allclose(cp[probs].to_numpy(), cj[probs].to_numpy(), rtol=0,
                               atol=BF16_PROBS_ATOL)


def test_bf16_driver_run_keeps_f32_checkpoints(tmp_path):
    """``run_experiment`` with ``training.compute_dtype: bfloat16`` (fast
    augmentation on, as the config defaults) runs end to end on the CPU; the
    checkpoints hold the f32 masters and Adam's f32 moments, as the JAX
    driver's do, and the run's losses are finite."""
    import math
    from pathlib import Path

    from multi_task_breast_cancer_tpu_torch.config import (
        Config,
        DataConfig,
        ModelConfig,
        TrainingConfig,
    )
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi
    from multi_task_breast_cancer_tpu_torch.train.driver import run_experiment

    root = make_preprocessed_busi(tmp_path / "busi", n_per_class=8, size=SIZE, seed=2)
    cfg = Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=list(WIDTHS)),
                 training=TrainingConfig(epochs=1, CV=2, compute_dtype="bfloat16"),
                 data=DataConfig(input_img=str(root)))
    run = Path(run_experiment(cfg, "multitask", "CV", run_root=str(tmp_path / "runs"),
                              device="cpu"))
    for fold in (0, 1):
        d = run / f"fold_{fold}"
        rows = (d / "metrics.csv").read_text().strip().splitlines()
        assert len(rows) == 2 and all(math.isfinite(float(v)) for v in rows[1].split(","))
        (ckpt,) = [p for p in d.iterdir() if p.name.startswith("model_")]
        payload = torch.load(ckpt, map_location="cpu", weights_only=False)
        assert payload["model_state_dict"] and all(
            v.dtype == torch.float32 for v in payload["model_state_dict"].values())
        moments = [t for s in payload["optimizer_state_dict"]["state"].values()
                   for k, t in s.items() if k in ("exp_avg", "exp_avg_sq")]
        assert moments and all(t.dtype == torch.float32 for t in moments)


@pytest.mark.parametrize("arch", ["ResidualUNet", "SwinUNETR"])
def test_seg_zoo_bf16_each_side_to_its_own_f32(arch, monkeypatch):
    """ResidualUNet (batch statistics) and SwinUNETR (attention logits in
    f32) at ``tests/test_torch_seg_zoo.py``'s sizes: the ``predict`` answer
    in bf16 against each side's own f32 answer by the factor-2 rule, port
    against JAX within 5e-2 of the f32 scale. ResidualUNet's bf16 step
    (dropout off on both sides): the loss by the factor-2 rule, the batch
    statistics stay f32 in the model's own buffers and move as f32's do
    (within the factor-2 rule of JAX's bf16 move)."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState
    from multi_task_breast_cancer_tpu_torch.models.blocks import Dropout
    from multi_task_breast_cancer_tpu_torch.train.loop import EngineConfig
    import test_torch_seg_zoo as Z

    monkeypatch.setattr(Z.jax_residual_unet, "nn", Z._NoDropout())
    variables = Z._init(arch)
    fold = _fold(4, 2, Z.SIZE)
    perm = np.array([0, 1], np.int32)
    cfg = dict(task="segmentation", batch_size=B, seg_criterion="DICE", use_transforms=False)
    out, loss, stats = {}, {}, {}
    for dtype in DTYPES:
        tx = init_optimizer("Adam", LR)
        jengine = JL.Engine(Z.MODELS[arch]()[0], tx, JL.EngineConfig(**cfg, compute_dtype=dtype))
        jstate = TrainState(params=variables["params"],
                            batch_stats=variables.get("batch_stats", FrozenDict()),
                            opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
        model = Z._port(arch)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        engine = Engine(model, EngineConfig(**cfg, compute_dtype=dtype), device="cpu")
        state = create_train_state(engine.model, "Adam", LR)
        out["jax", dtype] = np.asarray(jengine.predict(jstate, fold.images))
        out["port", dtype] = engine.predict(state, fold.images).numpy().transpose(0, 2, 3, 1)
        if arch == "ResidualUNet":
            jstate, jm = jengine.train_epoch(jstate, jengine.device_data(JaxDataset(**vars(fold))),
                                             perm, jax.random.PRNGKey(1))
            state, m = engine.train_epoch(state, engine.device_data(fold), perm)
            loss["jax", dtype], loss["port", dtype] = jm["loss"], m["loss"]
            stats["jax", dtype] = params_from_jax(
                {"batch_stats": jax.tree_util.tree_map(np.asarray, jstate.batch_stats)}, model)
            bufs = dict(state.model.named_buffers())
            assert all(b.dtype == torch.float32 for b in bufs.values())
            stats["port", dtype] = {k: b.clone() for k, b in bufs.items()}

    scale = np.abs(out["jax", "float32"]).max()
    assert np.abs(out["port", "float32"] - out["jax", "float32"]).max() <= 1e-4 * scale
    d_port = np.abs(out["port", "bfloat16"] - out["port", "float32"]).max() / scale
    d_jax = np.abs(out["jax", "bfloat16"] - out["jax", "float32"]).max() / scale
    assert d_port <= max(2 * d_jax, 1e-2), (d_port, d_jax)
    assert np.abs(out["port", "bfloat16"] - out["jax", "bfloat16"]).max() <= 5e-2 * scale
    if arch != "ResidualUNet":
        return
    rel = {s: abs(loss[s, "bfloat16"] - loss[s, "float32"]) / loss[s, "float32"]
           for s in ("port", "jax")}
    assert rel["port"] <= max(2 * rel["jax"], 1e-2), rel
    for k, f32 in stats["port", "float32"].items():
        d_port = ((stats["port", "bfloat16"][k] - f32).abs().max() / f32.abs().max()).item()
        jf32 = stats["jax", "float32"][k]
        d_jax = ((stats["jax", "bfloat16"][k] - jf32).abs().max() / jf32.abs().max()).item()
        assert d_port <= max(2 * d_jax, 1e-2), (k, d_port, d_jax)
        assert not torch.equal(f32, dict(Z._port(arch).named_buffers())[k]), k
