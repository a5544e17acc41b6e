"""The PyTorch port's ResidualUNet, MONAI twins (UNet, AttentionUNet,
SegResNet) and SwinUNETR against the JAX package's models.

Same weights (the port's seeded init, carried to JAX by
``variables_to_jax``, whose tree is held equal to ``jax.eval_shape`` of the
JAX ``init``), same numpy inputs (raw 0-255 intensities, 32²), both on the
CPU in f32. Narrow sizes: ResidualUNet, UNet and AttentionUNet at width 4
(channels 4-32), SegResNet at its 8 initial filters, SwinUNETR at feature
size 12 with heads (3, 6, 12, 24). Tolerances: forwards 1e-4 of each
output's scale (the larger of 1 and its largest magnitude); one batch-2
Engine step (fused DICE, augmentation off) against the JAX Engine: metrics
1e-4 relative (+1e-6), the gradient tensor by tensor to ``jax.grad`` of the
JAX Engine's loss at 1e-4 of the tensor's scale (see ``EXACT_ZERO`` for the
gradients that are zero or nearly cancel), Adam's move as
``tests/test_torch_zoo.py`` holds it, ResidualUNet's running ``mean``/``var``
to 1e-5 of their scale (where JAX's own f32 sums put it further than that
from the float64 statistics, as for the norms of raw 0-255 intensities,
E[x²] − E[x]² losing digits: to f64 at 1e-5 and no further from it than
JAX). ResidualUNet's step is held with dropout off on both
sides (the JAX model's ``nn.Dropout`` is swapped for rate 0 in the test
only); dropout is held by itself.

JAX's ``_shift_attention_mask`` calls ``np.asarray`` on a ``jnp`` result, so
it fails under ``jit``/``eval_shape`` unless an eager call cached it first,
as ``create_train_state``'s eager ``init`` does in the JAX driver:
:func:`_warm_swin_masks` makes those eager calls.
"""

from __future__ import annotations

import copy
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.core import FrozenDict

import chip_smoke
from multi_task_breast_cancer_tpu.models import registry as jax_registry
from multi_task_breast_cancer_tpu.models import residual_unet as jax_residual_unet
from multi_task_breast_cancer_tpu.models import swin_unetr as jax_swin
from multi_task_breast_cancer_tpu.models.monai_zoo import (
    AttentionUNet as JAttentionUNet,
    SegResNet as JSegResNet,
    UNet as JUNet,
)
from multi_task_breast_cancer_tpu.models.residual_unet import ResidualUNet as JResidualUNet
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.blocks import (
    BatchNorm,
    Dropout,
    SameConv2d,
    SameConvTranspose2d,
    dropout_draws,
    init_weights,
)
from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
    params_from_jax,
    size_knobs_from_params,
    variables_to_jax,
)
from multi_task_breast_cancer_tpu_torch.models.monai_zoo import AttentionUNet, SegResNet, UNet
from multi_task_breast_cancer_tpu_torch.models.residual_unet import ResidualUNet
from multi_task_breast_cancer_tpu_torch.models.swin_unetr import SwinUNETR
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from test_torch_driver import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _fold
from test_torch_zoo import (
    ADAM_TOL,
    UPDATE_TOL,
    _adam_faults,
    _gradient_faults,
    _max_scaled_err,
    _port_grad64,
    _record_first_step,
)

SIZE = 32
WIDTH = 4
CHANNELS = (WIDTH, 2 * WIDTH, 4 * WIDTH, 8 * WIDTH)
SWIN_FEATURES = 12
TOL = 1e-4
STATS_TOL = 1e-5
B = 2
# Some gradients are zero in exact arithmetic: a conv bias right before a
# norm that takes its mean out (ResidualUNet's training-mode BatchNorms, the
# MONAI twins' instance norms and SegResNet's one-channel groups), and, at
# 32², SwinUNETR's deepest block, whose 1×1 planes an instance norm maps to
# 0. In f64 they are below EXACT_ZERO of the model's largest gradient; in f32
# both frameworks leave rounding (measured up to 1.3e-6 of the largest),
# which Adam's first step (lr·g/(|g| + eps)) turns into moves of either sign.
# Such a tensor has no gradient to compare: each side's must be within
# F32_ZERO of the largest (2^-24·sqrt(B·H·W) ≈ 2.7e-6 of a term per sum,
# terms up to a few times the largest gradient), and the port's move is held
# to Adam's step of its own gradient only. Gradients that nearly cancel
# (SegResNet's deepest biases, ~1e-6 of the largest) are held as
# ``tests/test_torch_zoo.py`` holds UNet++'s: where more than 1e-4 of their
# scale from JAX's, no further from the f64 gradient than 1e-4 or twice JAX
# is (the port measured 10× closer to f64 than JAX there).
EXACT_ZERO = 1e-9
F32_ZERO = 1e-5

# architecture → (JAX model, port model) at narrow width
MODELS = {
    "ResidualUNet": lambda: (JResidualUNet(width=WIDTH), ResidualUNet(1, 1, WIDTH)),
    "UNet": lambda: (JUNet(channels=CHANNELS), UNet(1, 1, CHANNELS)),
    "AttentionUNet": lambda: (JAttentionUNet(channels=CHANNELS),
                              AttentionUNet(1, 1, CHANNELS)),
    "SegResNet": lambda: (JSegResNet(), SegResNet(1, 1)),
    "SwinUNETR": lambda: (jax_swin.SwinUNETR(feature_size=SWIN_FEATURES),
                          SwinUNETR(1, 1, SWIN_FEATURES, size=SIZE)),
}


def _warm_swin_masks(size: int) -> None:
    """Eager calls of JAX's mask for every shifted stage at ``size``²."""
    grid = size // 2
    while grid > jax_swin.WINDOW:
        jax_swin._shift_attention_mask(grid, grid, jax_swin.WINDOW, jax_swin.WINDOW // 2)
        grid //= 2


def _images(n: int = B, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, SIZE, SIZE, 1)) * 255).astype(np.float32)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _paths(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_shapes(model, size: int = SIZE) -> dict:
    _warm_swin_masks(size)
    return dict(jax.eval_shape(model.init, jax.random.PRNGKey(0),
                               jax.ShapeDtypeStruct((1, size, size, 1), jnp.float32)))


@functools.lru_cache(maxsize=None)
def _init(arch: str):
    """Seeded port weights with moved batch statistics (mean ~U[0,1), var
    ~U[0.5,1.5)), as the JAX variables (held equal, path for path, to the
    JAX model's own tree)."""
    model, port = MODELS[arch]()
    init_weights(port, torch.Generator().manual_seed(len(arch)))
    gen = torch.Generator().manual_seed(7)
    for name, buf in port.named_buffers():
        buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if name.endswith("var") else 0.0))
    variables = variables_to_jax(port.state_dict(), port)
    assert _paths(variables) == _paths(_jax_shapes(model))
    return variables


def _port(arch: str) -> torch.nn.Module:
    _, model = MODELS[arch]()
    model.load_state_dict(params_from_jax(_init(arch), model), strict=True)
    return model


@pytest.mark.parametrize("arch", list(MODELS))
def test_forward_matches_jax(arch):
    """Eval forwards (ResidualUNet on its running statistics) agree; the
    weights survive the bridge both ways bit for bit."""
    jmodel, _ = MODELS[arch]()
    variables = _init(arch)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, train=False))(
        variables, jnp.asarray(_images())))
    model = _port(arch).eval()
    with torch.inference_mode():
        got = model(_nchw(_images())).numpy().transpose(0, 2, 3, 1)
    assert _max_scaled_err(got, want) <= TOL
    back = variables_to_jax(model.state_dict(), model)
    for (p, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(back),
                              jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("arch", list(MODELS))
def test_full_width_parameters_match_jax(arch):
    """The registry's model at full width (width 24; SegResNet and SwinUNETR
    fixed; 128²) holds the JAX variables name for name and shape for shape,
    and the parameter and batch-statistic counts ``chip_smoke.py`` checks on
    the card."""
    shapes = _jax_shapes(jax_registry.init_segmentation_model(arch, width=24), 128)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = registry.init_segmentation_model(arch, width=24)
    n_stats = sum(a.size for a in jax.tree_util.tree_leaves(zeros.get("batch_stats", {})))
    assert registry.count_parameters(model) == chip_smoke.SEG_ZOO_PARAMETERS[arch] == sum(
        a.size for a in jax.tree_util.tree_leaves(zeros["params"]))
    assert sum(b.numel() for b in model.buffers()) == n_stats == \
        chip_smoke.SEG_ZOO_BATCH_STATS.get(arch, 0)
    assert {k: tuple(v.shape) for k, v in params_from_jax(zeros, model).items()} == \
           {k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_registry_builds_every_architecture_and_rejects_sizes_as_jax():
    """All nine segmentation architectures build; SwinUNETR refuses a side it
    cannot window with JAX's own message, at build and at the forward."""
    for arch in registry.SEGMENTATION_ARCHS:
        registry.init_segmentation_model(arch, width=WIDTH, size=SIZE)
    with pytest.raises(ValueError) as jerr:
        jax.eval_shape(jax_swin.SwinUNETR(feature_size=SWIN_FEATURES).init,
                       jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 96, 96, 1), jnp.float32))
    with pytest.raises(ValueError) as perr:
        registry.init_segmentation_model("SwinUNETR", size=96)
    assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="SwinUNETR input 48x48"):
        _port("SwinUNETR")(torch.zeros(1, 1, 48, 48))


@pytest.mark.parametrize("arch", list(MODELS))
def test_size_knobs_read_from_weights(arch):
    """A JAX artifact's ``weights.npz`` tells the width that rebuilds
    ResidualUNet, UNet and AttentionUNet; SegResNet and SwinUNETR have fixed
    widths. The rebuilt model loads the weights strictly."""
    variables = _init(arch)
    knobs = size_knobs_from_params(variables)
    assert knobs == ({} if arch in ("SegResNet", "SwinUNETR") else {"width": WIDTH})
    if arch == "SwinUNETR":
        return  # the registry's feature size is fixed at 24
    model = registry.init_segmentation_model(arch, **knobs)
    model.load_state_dict(params_from_jax(variables, model), strict=True)


def test_flax_same_padding_conventions():
    """A stride-2 3×3 ``SAME`` conv pads (0, 1), which ``Conv2d(padding=1)``
    does not; the 3×3 stride-2 ``SAME`` transposed conv is the unpadded one
    cropped at the high end, which ``padding=1, output_padding=1`` is not."""
    x = np.random.default_rng(3).standard_normal((1, 8, 8, 2)).astype(np.float32)
    conv = SameConv2d(2, 3, 3, 2)
    tconv = SameConvTranspose2d(2, 3, 3, 2)
    for layer, jlayer in ((conv, flax.linen.Conv(3, (3, 3), strides=(2, 2), padding="SAME")),
                          (tconv, flax.linen.ConvTranspose(3, (3, 3), strides=(2, 2),
                                                           padding="SAME"))):
        init_weights(layer, torch.Generator().manual_seed(1))
        sd = {f"layer.{k}": v for k, v in layer.state_dict().items()}
        holder = torch.nn.Module()
        holder.layer = layer
        params = variables_to_jax(sd, holder)["params"]["layer"]
        want = np.asarray(jlayer.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = layer(_nchw(x)).numpy().transpose(0, 2, 3, 1)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-5)
            if layer is conv:
                torch_pad = F.conv2d(_nchw(x), layer.weight, layer.bias, stride=2, padding=1)
            else:
                torch_pad = F.conv_transpose2d(_nchw(x), layer.weight, layer.bias, stride=2,
                                               padding=1, output_padding=1)
        assert np.abs(torch_pad.numpy().transpose(0, 2, 3, 1) - want).max() > 1e-2


def test_dropout_draws():
    """Rate 0.2: about 0.8 of the elements kept (within 5σ of a binomial
    over 100,000), each scaled by 1/0.8, the rest zero; the same generator
    seed draws the same mask; identity in eval; no generator, no draw."""
    drop = Dropout(0.2)
    x = torch.rand(100_000) + 1.0
    with dropout_draws(drop, torch.Generator().manual_seed(3)):
        y = drop(x)
    kept = y != 0
    sigma = (0.8 * 0.2 / x.numel()) ** 0.5
    assert abs(kept.float().mean().item() - 0.8) <= 5 * sigma
    torch.testing.assert_close(y[kept], x[kept] / 0.8, rtol=0, atol=0)
    with dropout_draws(drop, torch.Generator().manual_seed(3)):
        assert torch.equal(drop(x), y)
    with dropout_draws(drop, torch.Generator().manual_seed(4)):
        assert not torch.equal(drop(x), y)
    with pytest.raises(RuntimeError, match="explicit generator"):
        drop(x)
    assert drop.eval()(x) is x


def test_batch_norm_follows_flax():
    """Training normalises with the batch's biased statistics and moves the
    running ones by 0.1 of the biased batch variance (not ``BatchNorm2d``'s
    unbiased one); eval normalises with the running ones and leaves them."""
    x = np.random.default_rng(4).standard_normal((3, 5, 5, 4)).astype(np.float32) * 2 + 1
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.scale.copy_(torch.tensor([1.0, 2.0, 0.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.0, 0.1, -0.2, 0.3]))
    jbn = flax.linen.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": bn.scale.detach().numpy(), "bias": bn.bias.detach().numpy()},
                 "batch_stats": {"mean": np.zeros(4, np.float32), "var": np.ones(4, np.float32)}}
    want, upd = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    got = bn.train()(_nchw(x)).detach().numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-7)
    unbiased = torch.nn.BatchNorm2d(4, momentum=0.1).train()
    unbiased(_nchw(x))
    assert (unbiased.running_var - bn.var).abs().max() > 1e-3  # 0.1·var/(n − 1) apart
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    jeval = flax.linen.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want = jeval.apply({**variables, "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    with torch.no_grad():
        got = bn.eval()(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert all(torch.equal(v, bn.state_dict()[k]) for k, v in before.items())


class _NoDropout:
    """``flax.linen`` as ``residual_unet`` looks it up, its ``Dropout`` at
    rate 0: the JAX ResidualUNet without dropout, in this test only."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def Dropout(rate, deterministic=None):  # noqa: N802  (flax's name)
        return flax.linen.Dropout(0.0, deterministic=deterministic)


def _engine_cfg() -> dict:
    return dict(task="segmentation", n_classes=3, batch_size=B, inversely_weighted=True,
                seg_criterion="DICE", use_transforms=False)


def _jax_step(arch: str, fold, perm):
    """The JAX Engine's step on ``perm`` and ``jax.grad`` of its loss there."""
    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState

    model, _ = MODELS[arch]()
    variables = _init(arch)
    tx = init_optimizer("Adam", 1e-4)
    engine = JL.Engine(model, tx, JL.EngineConfig(**_engine_cfg()))
    # a plain dict, as the JAX driver's eager ``init`` gives it
    stats = variables.get("batch_stats", FrozenDict())
    state = TrainState(params=variables["params"], batch_stats=stats,
                       opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    data = engine.device_data(JaxDataset(**vars(fold)))
    imgs, msks = engine._to_compute(*(jnp.take(data[k], jnp.asarray(perm), axis=0)
                                      for k in ("images", "masks")))

    def loss(p):
        out, _ = engine._apply(p, stats, imgs, train=True)
        return engine._losses(out, msks, None)[0]

    grads = jax.jit(jax.grad(loss))(state.params)
    state, metrics = engine.train_epoch(state, data, perm, jax.random.PRNGKey(1))
    return state, metrics, grads


@pytest.mark.parametrize("arch", list(MODELS))
def test_engine_step_matches_jax_engine(arch, monkeypatch):
    """One batch-2 training step: metrics, the gradient tensor by tensor,
    Adam's move, the parameters and (ResidualUNet) the running statistics
    after it, against the JAX Engine."""
    monkeypatch.setattr(jax_residual_unet, "nn", _NoDropout())
    fold = _fold(4, 0, size=SIZE)
    perm = np.array([0, 1], np.int32)  # a lesion in both images
    jstate, jm, jgrads = _jax_step(arch, fold, perm)
    model = _port(arch)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    engine = Engine(model, EngineConfig(**_engine_cfg()), device="cpu")
    g64 = _port_grad64(engine.model.train(), engine, fold, perm)
    stats64 = copy.deepcopy(engine.model).double().train()
    with torch.no_grad():
        stats64(torch.from_numpy(fold.images[perm].transpose(0, 3, 1, 2)).double())
    stats64 = dict(stats64.named_buffers())
    state = create_train_state(engine.model, "Adam", 1e-4)
    first = _record_first_step(state)
    state, m = engine.train_epoch(state, engine.device_data(fold), perm)
    assert state.step == int(jstate.step) == 1
    bad = {k: (m[k], jm[k]) for k in jm if abs(m[k] - jm[k]) > 1e-4 * abs(jm[k]) + 1e-6}
    assert not bad, bad

    jgrads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), model)
    grads = first["grad"]
    assert set(grads) == set(jgrads) and all(g is not None for g in grads.values())
    largest = max(g.abs().max().item() for g in g64.values())
    zero = {k for k, g in g64.items() if g.abs().max().item() <= EXACT_ZERO * largest}
    for k in zero:
        assert max(grads[k].abs().max(), jgrads[k].abs().max()).item() <= F32_ZERO * largest, k
    live = {k: g for k, g in jgrads.items() if k not in zero}
    assert not _gradient_faults(grads, live, g64)
    eps = state.optimizer.param_groups[0]["eps"]
    moved = {k: first["after"][k] - first["before"][k] for k in grads}
    assert not _adam_faults(moved, grads, eps, ADAM_TOL)
    assert not _adam_faults(moved, live, eps, UPDATE_TOL)

    final = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                             "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                   jstate.batch_stats)}, model)
    sd = state.model.state_dict()
    buffers = {k for k, _ in model.named_buffers()}
    assert set(final) == set(sd)
    assert max((sd[k] - v).abs().max().item() for k, v in final.items()
               if k not in buffers | zero) <= UPDATE_TOL
    for k in buffers:  # the running statistics moved, as JAX moved them
        init = params_from_jax(_init(arch), model)[k]
        assert not torch.equal(sd[k], init), k
        scale = max(1.0, stats64[k].abs().max().item())
        ok = (sd[k] - final[k]).abs().max().item() <= STATS_TOL * scale
        if not ok:
            port64 = (sd[k].double() - stats64[k]).abs().max().item()
            ok = port64 <= min(STATS_TOL * scale, (final[k].double() - stats64[k]).abs().max())
        assert ok, k
    assert bool(buffers) == (arch == "ResidualUNet")


def test_residual_unet_epochs_with_dropout():
    """With dropout on: the Engine refuses to train without a dropout
    generator; a padding step leaves parameters, moments, step and buffers
    bit-identical; two runs from equal generators end bit-identical, another
    generator ends elsewhere; validation and ``predict`` leave the buffers
    as they are."""
    fold = _fold(4, 1, size=SIZE)
    perm = np.array([0, 1, 2, 3], np.int32)

    def run(seed):
        engine = Engine(_port("ResidualUNet"), EngineConfig(**_engine_cfg()), device="cpu")
        state = create_train_state(engine.model, "Adam", 1e-4)
        data = engine.device_data(fold)
        state, _ = engine.train_epoch(state, data, perm,
                                      dropout_generator=torch.Generator().manual_seed(seed))
        return engine, state, data

    engine, state, data = run(5)
    with pytest.raises(ValueError, match="dropout_generator"):
        engine.train_epoch(state, data, perm[:2])
    snap = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {k: {n: v.clone() if torch.is_tensor(v) else v for n, v in s.items()}
               for k, s in state.optimizer.state.items()}
    engine.train_epoch(state, data, perm[:2], step_valid=np.zeros(1, np.float32),
                       dropout_generator=torch.Generator().manual_seed(6))
    assert state.step == 2
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in snap.items())
    assert all(torch.equal(v, state.optimizer.state[k][n]) if torch.is_tensor(v) else
               v == state.optimizer.state[k][n] for k, s in moments.items() for n, v in s.items())
    engine.eval_epoch(state, data)
    engine.predict(state, fold.images)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in snap.items())
    again = run(5)[1].model.state_dict()
    other = run(6)[1].model.state_dict()
    assert all(torch.equal(v, again[k]) for k, v in snap.items())
    assert any(not torch.equal(v, other[k]) for k, v in snap.items())
