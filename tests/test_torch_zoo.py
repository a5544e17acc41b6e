"""The PyTorch port's BTS family, UNet++ family and Adityan network against
the JAX package's models.

Same weights (the port's seeded init, carried to JAX by ``params_to_jax``,
whose tree is held equal to ``jax.eval_shape`` of the JAX ``init``: a JAX
``init`` compiles for ~11 s a model on one CPU, its ``apply`` for ~1 s),
same numpy inputs (raw 0-255 intensities, 32²), both forwards on the CPU in f32;
the port's fused norm takes its plain path on a CPU tensor. Narrow widths:
BTS ``width=4``, UNet++ ``features=(4, 4, 8, 8, 16, 4)``, Adityan
``width=4``. Tolerance: 1e-4 of each output's scale (the larger of 1 and its
largest magnitude): f32 convolutions of two frameworks summed in different
orders. Full width is checked by shapes only (``jax.eval_shape``), against
the parameter counts ``chip_smoke.py`` holds on the card.

The Engine steps are one batch-2 step of ``Engine.train_epoch`` with the
flagship's objective (fused DICE with inverse deep-supervision weights +
Focal, α = 0.35, Adam 1e-4), augmentation off, on both sides: epoch metrics
to 1e-4 relative (+1e-6), as ``tests/test_torch_engine.py`` holds MTnnUNet;
the step's gradient tensor by tensor to ``jax.grad`` of the JAX Engine's
loss at 1e-4 of the tensor's scale; the parameters' move to Adam's first
step of that gradient at that test's 2e-6 (MTUNetPlusPlus: see
``UNETPP_UPDATE_TOL``).
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from multi_task_breast_cancer_tpu.models import registry as jax_registry
from multi_task_breast_cancer_tpu.models.bts_unet import BTSUNet as JBTSUNet
from multi_task_breast_cancer_tpu.models.classifiers import (
    BTSUNetClassifier as JBTSUNetClassifier,
)
from multi_task_breast_cancer_tpu.models.fsb_bts_unet import FSBBTSUNet as JFSBBTSUNet
from multi_task_breast_cancer_tpu.models.multitask import (
    Adityan as JAdityan,
    MultiBTSUNet as JMultiBTSUNet,
    MultiFSBBTSUNet as JMultiFSBBTSUNet,
)
from multi_task_breast_cancer_tpu.models.unetpp import (
    BasicUNetPlusPlus as JBasicUNetPlusPlus,
    MTUNetPlusPlus as JMTUNetPlusPlus,
    UNetPlusPlusClassifier as JUNetPlusPlusClassifier,
)
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.blocks import ConvInNormLeReLU, init_weights
from multi_task_breast_cancer_tpu_torch.models.bts_unet import BTSUNet
from multi_task_breast_cancer_tpu_torch.models.classifiers import BTSUNetClassifier
from multi_task_breast_cancer_tpu_torch.models.fsb_bts_unet import FSBBTSUNet
from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
    params_from_jax,
    params_to_jax,
    size_knobs_from_params,
)
from multi_task_breast_cancer_tpu_torch.models.multitask import (
    Adityan,
    MultiBTSUNet,
    MultiFSBBTSUNet,
)
from multi_task_breast_cancer_tpu_torch.models.unetpp import (
    BasicUNetPlusPlus,
    MTUNetPlusPlus,
    UNetPlusPlusClassifier,
)
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from test_torch_driver import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _fold

SIZE = 32
WIDTH = 4
FEATURES = (4, 4, 8, 8, 16, 4)
TOL = 1e-4
B = 2

# architecture → (JAX model, port model) at narrow width, given deep supervision
MODELS = {
    "BTSUNet": lambda ds: (JBTSUNet(width=WIDTH, deep_supervision=ds),
                           BTSUNet(1, 1, WIDTH, ds)),
    "FSBBTSUNet": lambda ds: (JFSBBTSUNet(width=WIDTH, deep_supervision=ds),
                              FSBBTSUNet(1, 1, WIDTH, ds)),
    "UnetPlusPlus": lambda ds: (JBasicUNetPlusPlus(features=FEATURES, deep_supervision=ds),
                                BasicUNetPlusPlus(1, 1, FEATURES, ds)),
    "BTSUNetClassifier": lambda ds: (JBTSUNetClassifier(width=WIDTH),
                                     BTSUNetClassifier(1, 3, WIDTH, SIZE)),
    "UNetPlusPlusClassifier": lambda ds: (JUNetPlusPlusClassifier(features=FEATURES),
                                          UNetPlusPlusClassifier(1, 3, FEATURES)),
    "Multi_BTSUNet": lambda ds: (JMultiBTSUNet(width=WIDTH, deep_supervision=ds),
                                 MultiBTSUNet(1, 1, 3, WIDTH, ds, SIZE)),
    "Multi_FSB_BTSUNet": lambda ds: (JMultiFSBBTSUNet(width=WIDTH, deep_supervision=ds),
                                     MultiFSBBTSUNet(1, 1, WIDTH, ds, SIZE)),
    "MTUNetPlusPlus": lambda ds: (JMTUNetPlusPlus(features=FEATURES, deep_supervision=ds),
                                  MTUNetPlusPlus(1, 1, 3, FEATURES, ds)),
    "Adityan": lambda ds: (JAdityan(width=WIDTH), Adityan(1, 1, WIDTH)),
}
NO_DS = ("BTSUNetClassifier", "UNetPlusPlusClassifier", "Adityan")
CASES = [(a, ds) for a in MODELS for ds in ((False,) if a in NO_DS else (False, True))]
TASKS = {a: t for t, archs in (("segmentation", registry.SEGMENTATION_ARCHS),
                               ("classification", registry.CLASSIFICATION_ARCHS),
                               ("multitask", registry.MULTITASK_ARCHS)) for a in archs}


def _images(n: int = B, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).random((n, SIZE, SIZE, 1)) * 255).astype(np.float32)


def _jax_shapes(model, size: int = SIZE):
    """The JAX model's parameter tree, as shapes (nothing compiles)."""
    return jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, size, size, 1), jnp.float32))["params"]


def _paths(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str, ds: bool):
    """Seeded weights as the JAX tree (numpy; the JAX model's own tree, path
    for path and shape for shape) and the JAX forward on ``_images()``."""
    model, port = MODELS[arch](ds)
    init_weights(port, torch.Generator().manual_seed(len(arch)))
    params = params_to_jax(port.state_dict(), port)
    assert _paths(params) == _paths(_jax_shapes(model))
    out = jax.jit(model.apply)({"params": params}, jnp.asarray(_images()))
    return params, jax.tree_util.tree_map(np.asarray, out)


def _port(arch: str, ds: bool, params) -> torch.nn.Module:
    _, model = MODELS[arch](ds)
    model.load_state_dict(params_from_jax(params, model), strict=True)
    return model.eval()


def _nhwc(out):
    """The port's output tree as the JAX model's: NHWC numpy, same nesting."""
    return jax.tree_util.tree_map(
        lambda t: t.detach().numpy().transpose(0, 2, 3, 1) if t.dim() == 4 else t.detach().numpy(),
        out, is_leaf=torch.is_tensor)


def _max_scaled_err(got, want) -> float:
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    worst = 0.0
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and np.isfinite(g).all()
        worst = max(worst, float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max())))
    return worst


@pytest.mark.parametrize("arch,ds", CASES)
def test_forward_matches_jax(arch, ds):
    params, want = _jax_init(arch, ds)
    with torch.inference_mode():
        got = _nhwc(_port(arch, ds, params)(torch.from_numpy(_images().transpose(0, 3, 1, 2))))
    assert _max_scaled_err(got, want) <= TOL


def test_flatten_order_matters():
    """BTSUNetClassifier's dense layer reads a 2×2×32 map at 32²: loading its
    weight in the reference's (c, h, w) order instead of JAX's (h, w, c)
    must move the output by far more than the tolerance."""
    params, want = _jax_init("BTSUNetClassifier", False)
    model = _port("BTSUNetClassifier", False, params)
    fc1 = model.classifier.fc1.weight
    c = 8 * WIDTH
    side = int(np.sqrt(fc1.shape[1] // c))
    assert side == SIZE // 16 == 2
    with torch.no_grad():
        fc1.copy_(fc1.reshape(-1, side, side, c).permute(0, 3, 1, 2).reshape(fc1.shape))
        got = model(torch.from_numpy(_images().transpose(0, 3, 1, 2))).numpy()
    assert np.abs(got - want).max() / max(1.0, np.abs(want).max()) > 100 * TOL


@pytest.mark.parametrize("arch", list(MODELS))
def test_full_width_parameters_match_jax(arch):
    """The registry's model at full width (width 24 from the config, deep
    supervision on where the architecture has it, 128²) holds exactly the JAX
    parameter tree, name for name and shape for shape, and the count
    ``chip_smoke.py`` checks on the card; its fused-norm sites per forward are
    the smoke's count too."""
    task = TASKS[arch]
    kw = {} if task == "classification" or arch in ("Adityan",) else {"deep_supervision": True}
    jax_factory = getattr(jax_registry, f"init_{task}_model")
    shapes = jax.eval_shape(jax_factory(arch, width=24, **kw).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 128, 128, 1), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes["params"])
    model = getattr(registry, f"init_{task}_model")(arch, width=24, **kw)
    assert registry.count_parameters(model) == chip_smoke.ZOO_PARAMETERS[arch] == sum(
        a.size for a in jax.tree_util.tree_leaves(zeros))
    assert {k: tuple(v.shape) for k, v in params_from_jax(zeros, model).items()} == \
           {k: tuple(v.shape) for k, v in model.state_dict().items()}
    sites = []
    hooks = [m.register_forward_hook(lambda *_: sites.append(1))
             for m in model.modules() if isinstance(m, ConvInNormLeReLU)]
    with torch.inference_mode():
        model(torch.zeros(1, 1, 128, 128))
    for h in hooks:
        h.remove()
    assert len(sites) == chip_smoke.ZOO_NORMS[arch]


@pytest.mark.parametrize("arch", list(MODELS))
def test_params_to_jax_inverts_params_from_jax(arch):
    """Leaf for leaf, path for path, on the JAX ``init``'s own tree filled
    with seeded values; the affine norms' ``scale``/``bias`` and the UpCat /
    Adityan ``upsample`` deconvs included."""
    model, port = MODELS[arch](arch not in NO_DS)
    rng = np.random.default_rng(len(arch))
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), _jax_shapes(model))
    back = params_to_jax(params_from_jax(params, port), port)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


@pytest.mark.parametrize("arch,ds", CASES)
def test_size_knobs_read_from_weights(arch, ds):
    """A JAX artifact's ``weights.npz`` tells the width and deep supervision
    that rebuild its model: the rebuilt model loads the weights strictly."""
    params, _ = _jax_init(arch, ds)
    knobs = size_knobs_from_params(params)
    want = {}
    if arch.startswith(("BTS", "FSB", "Multi", "Adityan")):
        want["width"] = WIDTH
    if TASKS[arch] != "classification" and arch != "Adityan":
        want["deep_supervision"] = ds or arch == "MTUNetPlusPlus"  # all 4 heads always
    assert knobs == want
    task = TASKS[arch]
    factory = getattr(registry, f"init_{task}_model")
    size = {} if task == "segmentation" else {"size": SIZE}
    model = factory(arch, **knobs, **size)
    if "UNet" in arch or "Unet" in arch:
        return  # fixed full-width features: nothing narrower to rebuild
    model.load_state_dict(params_from_jax(params, model), strict=True)


def test_registry_knobs(caplog):
    """JAX's factory rules: 48 without a width, nnU-Net widths refused
    elsewhere, ignored knobs warned about."""
    assert registry.init_segmentation_model("BTSUNet").encoder1.block2.conv.out_channels == 48
    with pytest.raises(ValueError, match="only valid for the nnU-Net family"):
        registry.init_multitask_model("Multi_BTSUNet", nnunet_widths=[4, 8, 8, 16, 16])
    with caplog.at_level(logging.WARNING):
        registry.init_segmentation_model("UnetPlusPlus", width=8)
        registry.init_multitask_model("Adityan", width=4, deep_supervision=True)
    assert "model.width=8 is ignored by UnetPlusPlus" in caplog.text
    assert "model.deep_supervision=True is ignored by Adityan" in caplog.text


def _engine_cfg(n_classes: int = 3) -> dict:
    return dict(task="multitask", n_classes=n_classes, batch_size=B, alpha=0.35,
                inversely_weighted=True, seg_criterion="DICE", cls_criterion="Focal",
                use_transforms=False)


def _jax_engine(arch: str, ds: bool, n_classes: int = 3):
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState

    model, _ = MODELS[arch](ds)
    params, _ = _jax_init(arch, ds)
    tx = init_optimizer("Adam", 1e-4)
    engine = JL.Engine(model, tx, JL.EngineConfig(**_engine_cfg(n_classes)))
    state = TrainState(params=params, batch_stats=FrozenDict(), opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    return engine, state


def _as_jax(ds):
    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    return JaxDataset(**vars(ds))


def _jax_grad(engine, state, fold, rows, target):
    """``jax.grad`` of the JAX Engine's own forward and losses on the batch
    ``rows`` of ``fold``: the gradient its first step applies, as the port
    model ``target``'s tensors."""
    from flax.core import FrozenDict

    data = engine.device_data(_as_jax(fold))
    take = lambda k: jnp.take(data[k], jnp.asarray(rows), axis=0)  # noqa: E731
    imgs, msks = engine._to_compute(take("images"), take("masks"))
    ctgt = take("cls_targets")

    def loss(p):
        out, _ = engine._apply(p, FrozenDict(), imgs, train=True)
        return engine._losses(out, msks, ctgt)[0]

    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(
        state.params)), target)


def _record_first_step(state) -> dict:
    """Wrap the optimizer's ``step`` so that its first call records each
    parameter's gradient (None where it has none) and the parameters before
    and after it."""
    named, first = dict(state.model.named_parameters()), {}
    real_step = state.optimizer.step

    def step(*args, **kwargs):
        if first:
            return real_step(*args, **kwargs)
        first["grad"] = {k: None if p.grad is None else p.grad.clone() for k, p in named.items()}
        first["before"] = {k: p.detach().clone() for k, p in named.items()}
        done = real_step(*args, **kwargs)
        first["after"] = {k: p.detach().clone() for k, p in named.items()}
        return done

    state.optimizer.step = step
    return first


GRAD_TOL = 1e-4      # of each tensor's gradient scale, port vs JAX
ZERO_GRAD = 1e-6     # of the model's largest gradient: zero but for rounding
UPDATE_TOL = 2e-6    # tests/test_torch_engine.py's bound on the parameters
ADAM_TOL = 2e-7      # the port's move against Adam's first step of its own gradient
# MTUNetPlusPlus at 32²: its deepest planes are 2×2 and an instance norm over
# four values amplifies f32 rounding, so on the CPU JAX's own gradient is up
# to 6.7e-4 of a tensor's scale from the f64 gradient (the port's 3.7e-4); a
# tensor more than GRAD_TOL from JAX's is held instead to be no further from
# f64 than twice JAX is, and the update to lr/10 of Adam's step of JAX's
# gradient (measured 2.8e-6; a zeroed update is lr away, a flipped one 2·lr)
UNETPP_UPDATE_TOL = 1e-5


def _port_grad64(model: torch.nn.Module, engine: Engine, fold, rows) -> dict:
    """The port's gradient of the same step in float64 on the CPU."""
    import copy

    model = copy.deepcopy(model).double()
    data = engine.device_data(fold)
    x, m, t = (data[k].index_select(0, torch.as_tensor(rows)).double()
               for k in ("images", "masks", "cls_targets"))
    loss, _ = engine._losses(model(engine._nchw(x)), m, t)
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


def _gradient_faults(grads: dict, jgrads: dict, g64=None) -> list:
    """The tensors whose port gradient is more than ``GRAD_TOL`` of their
    scale (the JAX gradient's largest magnitude) from JAX's; given the f64
    gradient ``g64``, only those also further from it than ``GRAD_TOL`` of
    the scale and twice JAX's distance. A tensor whose JAX
    gradient is zero but for rounding (at most ``ZERO_GRAD`` of the model's
    largest: a conv bias before an affine instance norm, Adityan's
    reconstruction head, which no loss reads) has no scale: its port
    gradient must be as small, or absent."""
    largest = max(g.abs().max().item() for g in jgrads.values())
    faults = []
    for k, gj in jgrads.items():
        scale, g = gj.abs().max().item(), grads[k]
        if scale <= ZERO_GRAD * largest:
            ok = g is None or g.abs().max().item() <= ZERO_GRAD * largest
        elif g is None:
            ok = False
        else:
            ok = (g - gj).abs().max().item() <= GRAD_TOL * scale
            if not ok and g64 is not None:
                ok = ((g.double() - g64[k]).abs().max().item() <= max(
                    GRAD_TOL * scale, 2 * (gj.double() - g64[k]).abs().max().item()))
        if not ok:
            faults.append(k)
    return faults


def _adam_faults(moved: dict, grads: dict, eps: float, tol: float, lr: float = 1e-4) -> list:
    """The tensors that a first step moved by more than ``tol`` away from
    Adam's first step of ``grads``, ``-lr·g/(|g| + eps)``."""
    return [k for k, g in grads.items()
            if (moved[k] + lr * g / (g.abs() + eps)).abs().max().item() > tol]


@pytest.mark.parametrize("arch,ds", [("Multi_BTSUNet", True), ("MTUNetPlusPlus", True),
                                     ("Adityan", False)])
def test_engine_step_matches_jax_engine(arch, ds):
    """One training step: Multi_BTSUNet with its 3 deep-supervision heads
    weighted inversely, MTUNetPlusPlus with 4, and Adityan, whose
    reconstruction head is left out of the loss on both sides. The step's
    gradient is held tensor by tensor to ``jax.grad`` of the JAX Engine's
    loss, the port's move to Adam's first step of its own gradient and of
    JAX's, and the state after it to the JAX Engine's; a zeroed gradient, a
    zeroed update and a sign-flipped update on one tensor are shown to fail
    these checks."""
    fold = _fold(4, 0, size=SIZE)
    perm = np.array([2, 0], np.int32)
    jengine, jstate = _jax_engine(arch, ds)
    jgrads = _jax_grad(jengine, jstate, fold, perm, MODELS[arch](ds)[1])
    jstate, jm = jengine.train_epoch(jstate, jengine.device_data(_as_jax(fold)), perm,
                                     jax.random.PRNGKey(1))
    params, _ = _jax_init(arch, ds)
    engine = Engine(_port(arch, ds, params), EngineConfig(**_engine_cfg()), device="cpu")
    unetpp = arch == "MTUNetPlusPlus"
    update_tol = UNETPP_UPDATE_TOL if unetpp else UPDATE_TOL
    g64 = _port_grad64(engine.model, engine, fold, perm) if unetpp else None
    state = create_train_state(engine.model, "Adam", 1e-4)
    first = _record_first_step(state)
    state, m = engine.train_epoch(state, engine.device_data(fold), perm)
    assert state.step == int(jstate.step) == 1
    assert set(m) == set(jm)
    bad = {k: (m[k], jm[k]) for k in jm if abs(m[k] - jm[k]) > 1e-4 * abs(jm[k]) + 1e-6}
    assert not bad, bad

    grads = first["grad"]
    assert set(grads) == set(jgrads)
    # Adityan's reconstruction head is in no loss: no gradient, no move
    absent = sorted(k for k, g in grads.items() if g is None)
    assert bool(absent) == (arch == "Adityan")
    assert all(k.startswith("rec") and not jgrads[k].any() for k in absent), absent
    assert not _gradient_faults(grads, jgrads, g64)
    live = max(jgrads, key=lambda k: jgrads[k].abs().max().item())
    assert _gradient_faults({**grads, live: torch.zeros_like(jgrads[live])}, jgrads,
                            g64) == [live]

    eps = state.optimizer.param_groups[0]["eps"]
    moved = {k: first["after"][k] - first["before"][k] for k in grads}
    assert all(not moved[k].any() for k in absent)
    assert not _adam_faults(moved, {k: g for k, g in grads.items() if g is not None}, eps,
                            ADAM_TOL)
    assert not _adam_faults(moved, jgrads, eps, update_tol)
    for wrong in (torch.zeros_like(moved[live]), -moved[live]):
        assert _adam_faults({**moved, live: wrong}, jgrads, eps, update_tol) == [live]
    final = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), state.model)
    sd = state.model.state_dict()
    assert max((sd[k] - v).abs().max().item() for k, v in final.items()) <= update_tol


@pytest.mark.parametrize("arch,n_classes", [("Multi_FSB_BTSUNet", 3), ("Adityan", 2)])
def test_hard_coded_heads_raise_as_in_jax(arch, n_classes):
    """Multi_FSB_BTSUNet emits 1 logit and Adityan 3 whatever the config
    says: a mismatching class count fails on both sides, naming them."""
    fold = _fold(2, 1, size=SIZE)
    labels = fold.labels % max(n_classes, 2)
    fold = type(fold)(**{**vars(fold), "labels": labels})
    perm = np.array([0, 1], np.int32)
    jengine, jstate = _jax_engine(arch, False, n_classes)
    with pytest.raises(ValueError, match=f"{arch}: \\d"):
        jengine.train_epoch(jstate, jengine.device_data(_as_jax(fold)), perm,
                            jax.random.PRNGKey(0))
    model = registry.init_multitask_model(arch, n_classes=n_classes, width=WIDTH, size=SIZE)
    engine = Engine(model, EngineConfig(**_engine_cfg(n_classes)), device="cpu")
    state = create_train_state(engine.model, "Adam", 1e-4)
    with pytest.raises(ValueError, match=f"{arch}: \\d"):
        engine.train_epoch(state, engine.device_data(fold), perm)


def test_init_draws_the_affine_norm_as_jax():
    """An affine norm starts at scale 1, bias 0; the drawing is seeded."""
    a = init_weights(MTUNetPlusPlus(1, 1, 3, FEATURES), torch.Generator().manual_seed(5))
    b = init_weights(MTUNetPlusPlus(1, 1, 3, FEATURES), torch.Generator().manual_seed(5))
    norm = a.nest.upcat_0_1.convs.conv_0.norm
    assert torch.equal(norm.scale, torch.ones(FEATURES[0]))
    assert torch.equal(norm.bias, torch.zeros(FEATURES[0]))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
