"""Spatial partitioning for the rest of the zoo and every segmentation
criterion (``parallel/spatial.py``'s row rules in ``models/``, the Engine's
criteria on whole planes) on the CPU, over Gloo.

Ranks run as processes (``test_torch_parallel.run_ranks``), one torch
thread each, every rank from rank 0's weights, as a ``(1 data × n space)``
mesh. A run on the mesh must compute what one process computes on the same
global batch, up to the order of its sums: losses, metrics and states at
2e-4 relative (JAX's own bound, ``tests/test_spatial.py:81, 235``), the
first step's all-reduced gradient tensor by tensor at 2e-4 of its scale,
parameters and ``BatchNorm`` buffers bit for bit across the ranks. A
gradient that is zero in exact arithmetic (a bias right before a norm that
takes its mean out) has no scale of its own: it must stay within
``ZERO_GRAD`` of the model's largest gradient on both sides.

- every architecture outside the nnU-Net and BTS families, on 2 space ranks, one
  epoch of two steps with the exact augmentation and an evaluation
  (ResidualUNet with dropout on);
- one architecture per new row rule against the JAX model on one device,
  from the same weights (``params_to_jax``): the training-mode forward's
  outputs, the batch's loss and the moved batch statistics at 2e-4 (JAX's
  spatial path is GSPMD over the single-device math, so this holds the
  split run to JAX);
- the new collectives alone (the cyclic row shift, ``halo_conv`` at each
  padding it takes, the ``SAME`` transposed convolution) on 2 and 4 ranks
  in f64, forward and backward, against the whole-plane op and its
  autograd, every row (so every shard edge) compared;
- the seven criteria other than DICE on BTSUNet (deep supervision on);
- bf16 on a narrow MTnnUNet;
- a structural guard: no convolution whose kernel spans rows, in any of the
  17 architectures, is left without a row rule.

Worker processes import this module without JAX and run its ``case_*``
functions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.blocks import (
    Conv3x3,
    Dropout,
    SameConv2d,
    SameConvTranspose2d,
    global_batch,
    init_weights,
)
from multi_task_breast_cancer_tpu_torch.models.monai_zoo import AttentionUNet, SegResNet, UNet
from multi_task_breast_cancer_tpu_torch.models.multitask import Adityan
from multi_task_breast_cancer_tpu_torch.models.residual_unet import ResidualUNet
from multi_task_breast_cancer_tpu_torch.models.swin_unetr import SwinUNETR
from multi_task_breast_cancer_tpu_torch.models.unetpp import (
    BasicUNetPlusPlus,
    MTUNetPlusPlus,
    UNetPlusPlusClassifier,
)
from multi_task_breast_cancer_tpu_torch.ops.losses import SEG_CRITERIA
from multi_task_breast_cancer_tpu_torch.parallel import spatial
from multi_task_breast_cancer_tpu_torch.train.loop import (
    Engine,
    EngineConfig,
    make_cls_targets,
    plan_epoch_indices,
)
from test_torch_parallel import (
    RTOL,
    _close,
    _engine_run,
    _outputs_close,
    _perturbed_unless_rank0,
    _same_state,
    run_ranks,
)
from test_torch_spatial import KEYS, _join

WIDTH = 4
CHANNELS = (WIDTH, 2 * WIDTH, 4 * WIDTH, 8 * WIDTH)
UNETPP_FEATURES = (4, 4, 8, 8, 16, 4)
SWIN_FEATURES = 6          # heads (3, 6, 12, 24): two channels a head
NNUNET_WIDTHS = [4, 8, 8, 16, 16]
B = 2
# f32 rounding of a gradient that is zero in exact arithmetic: each sum of
# B·H·W terms leaves ~2^-24·sqrt(B·H·W) of a term, terms up to a few times
# the model's largest gradient (``tests/test_torch_seg_zoo.py``'s F32_ZERO)
ZERO_GRAD = 1e-5

# architecture → (task, side, model factory, dropout seed)
ZOO = {
    "UNet": ("segmentation", 32, lambda: UNet(1, 1, CHANNELS), None),
    "AttentionUNet": ("segmentation", 32, lambda: AttentionUNet(1, 1, CHANNELS), None),
    "SegResNet": ("segmentation", 32, lambda: SegResNet(1, 1), None),
    "ResidualUNet": ("segmentation", 32, lambda: ResidualUNet(1, 1, WIDTH), 5),
    "SwinUNETR": ("segmentation", 64, lambda: SwinUNETR(1, 1, SWIN_FEATURES, size=64), None),
    "UnetPlusPlus": ("segmentation", 32, lambda: BasicUNetPlusPlus(
        1, 1, UNETPP_FEATURES, deep_supervision=True), None),
    "UNetPlusPlusClassifier": ("classification", 32, lambda: UNetPlusPlusClassifier(
        1, 3, UNETPP_FEATURES), None),
    "MTUNetPlusPlus": ("multitask", 32, lambda: MTUNetPlusPlus(
        1, 1, 3, UNETPP_FEATURES, deep_supervision=True), None),
    "Adityan": ("multitask", 32, lambda: Adityan(1, 1, WIDTH), None),
}


# ---------------------------------------------------------------------------
# cases (run on every rank)
# ---------------------------------------------------------------------------

def case_runs(rank, world, port, runs):
    """Each run of ``runs`` (``_engine_run``'s arguments and a dropout
    seed) as this rank of a ``(1 data × world space)`` mesh, with the
    collectives it counted."""
    mesh = _join(rank, world, port, world)
    out = []
    for run in runs:
        spatial.reset_counts()
        res = _engine_run(_perturbed_unless_rank0(run["model"], rank), run["cfg"], mesh,
                          run["train"], run["perm"], run.get("val"), run.get("predict"),
                          dropout_seed=run.get("dropout_seed"))
        res["counts"] = dict(spatial.counts)
        out.append(res)
    return out


def case_forwards(rank, world, port, models, images, masks, targets, tasks):
    """Each model's training-mode forward of the whole batch as this rank
    (its rows), its outputs' rows gathered, the Engine's loss of the batch
    (alike on every rank of the group) and its buffers after the step."""
    mesh = _join(rank, world, port, world)
    space = mesh.space
    rows = space.rows(images.shape[2])
    out = []
    for model, task in zip(models, tasks):
        engine = Engine(model, EngineConfig(task=task, n_classes=3, batch_size=B,
                                            use_transforms=False), device="cpu", mesh=mesh)
        model.train()
        with torch.no_grad(), global_batch(model, mesh, B), spatial.partitioned(space):
            y = model(images[:, :, rows].contiguous())
            loss, _ = engine._losses(y, masks[:, :, rows].contiguous(), targets)
            y = _tree(lambda t: spatial.gather_rows(t, space) if t.dim() == 4 else t, y)
        out.append({"out": y, "loss": loss.item(),
                    "buffers": {k: v.clone() for k, v in model.named_buffers()}})
    return out


SHIFTS = (-3, -1, 2, 4)
# name → (global row padding, stride): halo_conv's three uses
HALO_CONVS = {"pad11_s1": ((1, 1), 1), "pad11_s2": ((1, 1), 2), "same_s2": ((0, 1), 2)}


def case_collectives(rank, world, port, x, grads, weight, bias, deconv):
    """The new collectives on this rank's rows of ``x`` (f64): each op's
    output rows and the gradients of ⟨op(x), g⟩ for this rank's rows of
    ``grads[op]``; with the counts of each."""
    mesh = _join(rank, world, port, world)
    space = mesh.space
    rows = space.rows(x.shape[2])
    out = {}

    def run(name, fn, *params):
        xl = x[:, :, rows].clone().requires_grad_()
        ps = [p.clone().requires_grad_() for p in params]
        spatial.reset_counts()
        y = fn(xl, *ps)
        g = grads[name]
        y.backward(g[:, :, space.rows(g.shape[2])])
        out[name] = {"y": y.detach(), "dx": xl.grad, "dp": [p.grad for p in ps],
                     "counts": dict(spatial.counts)}

    for s in SHIFTS:
        run(f"shift{s}", lambda t, s=s: spatial.cyclic_row_shift(t, space, s))
    for name, (pads, stride) in HALO_CONVS.items():
        cols = pads if stride == 2 and pads == (0, 1) else (1, 1)
        run(name, lambda t, w, b, p=pads, st=stride, c=cols: spatial.halo_conv(
            t, space, w, b, p, st, c), weight, bias)

    def transposed(t, w, b):
        with spatial.partitioned(space):
            return torch.func.functional_call(deconv, {"weight": w, "bias": b}, (t,))

    run("same_transposed", transposed, deconv.weight.detach(), deconv.bias.detach())
    return out


def _tree(fn, out):
    if isinstance(out, (tuple, list)):
        return type(out)(_tree(fn, o) for o in out)
    return fn(out)
# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this process's runs, as
    ``tests/test_torch_driver.py``'s fixture (which this module does not
    import: its rank processes must not load JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fold(n, seed, size):
    from test_torch_engine import _fold as fold
    return fold(n, seed, size=size)


def _zoo_model(arch: str) -> torch.nn.Module:
    return init_weights(ZOO[arch][2](), torch.Generator().manual_seed(len(arch)))


def _zoo_run(arch: str, model=None) -> dict:
    """One epoch of two batch-2 steps with the exact augmentation, an
    evaluation of 2 images and a prediction of 2."""
    task, size, _, dropout_seed = ZOO[arch]
    train, val = _fold(4, 5, size), _fold(2, 6, size)
    return dict(model=model if model is not None else _zoo_model(arch),
                cfg=EngineConfig(task=task, n_classes=3, batch_size=B, max_angle=180.0),
                train=train, perm=plan_epoch_indices(4, B, np.random.default_rng(3)),
                val=val, predict=val.images, dropout_seed=dropout_seed)


def _single(run: dict) -> dict:
    """``_engine_run`` in one process, with the first step's gradient in f64
    (``grads64``: the model's forward and loss in float64 on the step's
    augmented batch, before any step)."""
    import copy

    model64 = copy.deepcopy(run["model"]).double().train()
    batches, augmented = [], Engine._augmented_batch

    def record(self, *args, **kwargs):
        out = augmented(self, *args, **kwargs)
        batches.append(out)
        return out

    Engine._augmented_batch = record
    try:
        res = _engine_run(run["model"], run["cfg"], None, run["train"], run["perm"],
                          run.get("val"), run.get("predict"),
                          dropout_seed=run.get("dropout_seed"))
    finally:
        Engine._augmented_batch = augmented
    if run.get("dropout_seed") is None:  # a dropout mask in f64 is another draw
        imgs, msks = (t.double() for t in batches[0])
        cfg = run["cfg"]
        targets = torch.from_numpy(make_cls_targets(
            run["train"].labels[run["perm"][:B]], cfg.n_classes, cfg.task)).double()
        loss, _ = Engine(model64, cfg, device="cpu")._losses(model64(imgs), msks, targets)
        loss.backward()
        res["grads64"] = {k: p.grad for k, p in model64.named_parameters()
                          if p.grad is not None}
    return res


def _grads_close(got: dict, want: dict, want64=None) -> None:
    """The first step's all-reduced gradient, tensor by tensor, within 2e-4
    of the largest element of one process's; a tensor whose gradient is
    below ``ZERO_GRAD`` of the model's largest (zero in exact arithmetic:
    rounding only) within that of it on both sides. Given the f64 gradient
    ``want64``, a tensor further than that from one process's passes if it
    is no further from f64 than 2e-4 of its scale or twice one process's
    distance: gradients that nearly cancel (UNet++'s, as
    ``tests/test_torch_zoo.py`` holds them against JAX) differ by more than
    2e-4 of their scale between any two f32 sum orders."""
    assert got.keys() == want.keys() and want
    largest = max(w.abs().max().item() for w in want.values())
    for k, w in want.items():
        scale = w.abs().max().item()
        if scale <= ZERO_GRAD * largest:
            assert got[k].abs().max().item() <= ZERO_GRAD * largest, k
            continue
        err = (got[k] - w).abs().max().item()
        if err > RTOL * scale and want64 is not None:
            err64 = (got[k].double() - want64[k]).abs().max().item()
            assert err64 <= max(RTOL * scale, 2 * (w.double() - want64[k]).abs().max().item()), \
                (k, err, err64, scale)
            continue
        assert err <= RTOL * scale, (k, err, scale)


def _check_against_single(ranks: list, single: dict, collectives=("halo_exchanges",)) -> None:
    """The ranks' runs (one each) against one process's: parameters and
    buffers bit-identical across the ranks; metrics, state, predictions and
    the first step's gradient as the module docstring says; each of
    ``collectives`` counted."""
    _same_state(ranks)
    for res in ranks:
        assert not _close(res["train"], single["train"], RTOL, keys=KEYS)
        assert not _close(res["val"], single["val"], RTOL, keys=KEYS)
        if "predict" in single:  # from the states, which may differ by the rule's 2e-4
            _outputs_close(res["predict"], single["predict"], RTOL)
        for c in collectives:
            assert res["counts"][c] > 0, (c, res["counts"])
    for k, v in single["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][k].numpy(), v.numpy(), rtol=RTOL,
                                   atol=RTOL * max(1.0, v.abs().max().item()), err_msg=k)
    _grads_close(ranks[0]["grads"], single["grads"], single.get("grads64"))


# the collectives each architecture must have used, beside its halo rows
ZOO_COLLECTIVES = {"SwinUNETR": ("halo_exchanges", "cyclic_shifts", "row_gathers"),
                   "Adityan": ("halo_exchanges", "row_gathers"),
                   "UNetPlusPlusClassifier": ("halo_exchanges", "collectives")}


@pytest.fixture(scope="module")
def zoo_ranks(tmp_path_factory):
    """Every architecture of :data:`ZOO` on 2 space ranks, in one pair of
    rank processes."""
    runs = [_zoo_run(arch) for arch in ZOO]
    ranks = run_ranks(2, "test_torch_spatial_zoo", "case_runs",
                      tmp_path_factory.mktemp("zoo"), dict(runs=runs), init=False)
    return {arch: [r[i] for r in ranks] for i, arch in enumerate(ZOO)}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ZOO))
def test_architecture_on_two_space_ranks_matches_one_process(zoo_ranks, arch):
    """UNet and AttentionUNet at channels (4, 8, 16, 32), SegResNet at its 8
    filters, ResidualUNet at width 4 with dropout 0.2, SwinUNETR at feature
    size 6 (64²: the cyclic shift at stages 0-1, stages 2-3 gathered), the
    UNet++ family at features (4, 4, 8, 8, 16, 4) with deep supervision where
    it has it, Adityan at width 4: one epoch with the exact augmentation, an
    evaluation and a prediction on 2 space ranks match one process."""
    _check_against_single(zoo_ranks[arch], _single(_zoo_run(arch)),
                          ZOO_COLLECTIVES.get(arch, ("halo_exchanges", "collectives")))


CRITERIA = [c for c in SEG_CRITERIA if c != "DICE"]


def _criterion_run(criterion: str) -> dict:
    """BTSUNet at width 4 with deep supervision (each head's loss on its
    gathered planes, inversely weighted), 32², under ``criterion``."""
    model = registry.init_segmentation_model("BTSUNet", width=WIDTH, deep_supervision=True,
                                             size=32,
                                             generator=torch.Generator().manual_seed(9))
    train, val = _fold(4, 7, 32), _fold(2, 8, 32)
    return dict(model=model, cfg=EngineConfig(task="segmentation", n_classes=3, batch_size=B,
                                              max_angle=180.0, seg_criterion=criterion),
                train=train, perm=plan_epoch_indices(4, B, np.random.default_rng(4)),
                val=val)


@pytest.fixture(scope="module")
def criteria_ranks(tmp_path_factory):
    runs = [_criterion_run(c) for c in CRITERIA]
    ranks = run_ranks(2, "test_torch_spatial_zoo", "case_runs",
                      tmp_path_factory.mktemp("criteria"), dict(runs=runs), init=False)
    return {c: [r[i] for r in ranks] for i, c in enumerate(CRITERIA)}


@pytest.mark.parametrize("criterion", CRITERIA)
def test_criterion_on_two_space_ranks_matches_one_process(criteria_ranks, criterion):
    """Every segmentation criterion but DICE (whose fused loss sums its
    plane sums over the group) on 2 space ranks: the heads' rows and the masks are
    gathered and the criterion runs on whole planes, alike on each rank;
    the epoch, the evaluation and the first step's gradient match one
    process, so the 1/n_space weight of the replicated loss (the Jaccard
    criterion's batch sum included) holds. Hausdorff's distance fields see
    the whole planes."""
    ranks = criteria_ranks[criterion]
    _check_against_single(ranks, _single(_criterion_run(criterion)),
                          ("halo_exchanges", "row_gathers"))
    # four heads and their masks, in the step's forward and the evaluation's
    assert all(r["counts"]["row_gathers"] >= 16 for r in ranks)


def _bf16_run() -> dict:
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=NNUNET_WIDTHS,
                                          generator=torch.Generator().manual_seed(11))
    train, val = _fold(4, 9, 64), _fold(2, 10, 64)
    return dict(model=model, cfg=EngineConfig(task="multitask", n_classes=3, batch_size=B,
                                              max_angle=180.0, compute_dtype="bfloat16"),
                train=train, perm=plan_epoch_indices(4, B, np.random.default_rng(5)),
                val=val)


# bf16 on 2 space ranks against one process in bf16: each convolution's
# output is rounded to bf16 (8 bits) from f32 sums that the two runs add in
# other orders at other shapes, so an element may round one bf16 ulp (2^-8
# relative) apart and carry on through the net. The losses and states are
# held at 1e-2 relative, two such ulps. The first step's gradient is held
# per tensor as ``chip_smoke.py`` phase 7d holds f32 ones on the card: its
# least-squares scale against one process's within BF16_GRAD_SCALE of 1 and
# its distance within BF16_GRAD_DIST of the norm (measured on this CPU: at
# most 2.4e-2 and 9.4e-2, the small deconv biases); a loss term the ranks
# lost or counted twice moves the scale by tens of percent.
BF16_RTOL = 1e-2
BF16_GRAD_SCALE, BF16_GRAD_DIST = 5e-2, 0.2


def test_bf16_on_two_space_ranks_matches_one_process(tmp_path):
    """MTnnUNet at widths (4, 8, 8, 16, 16), 64², bf16 compute (the split
    norm statistics in f32): one epoch with the exact augmentation and an
    evaluation on 2 space ranks against one process in bf16, parameters
    bit-identical across the ranks."""
    ranks = [r[0] for r in run_ranks(2, "test_torch_spatial_zoo", "case_runs", tmp_path,
                                     dict(runs=[_bf16_run()]), init=False)]
    single = _engine_run(**{k: v for k, v in _bf16_run().items()}, mesh=None)
    _same_state(ranks)
    for res in ranks:
        assert not _close(res["train"], single["train"], BF16_RTOL,
                          keys=("loss", "seg_loss", "cls_loss"))
        assert not _close(res["val"], single["val"], BF16_RTOL,
                          keys=("loss", "seg_loss", "cls_loss"))
        assert res["counts"]["halo_exchanges"] > 0
    for k, v in single["state"].items():
        np.testing.assert_allclose(ranks[0]["state"][k].numpy(), v.numpy(), rtol=BF16_RTOL,
                                   atol=BF16_RTOL * max(1.0, v.abs().max().item()), err_msg=k)
    got, want = ranks[0]["grads"], single["grads"]
    assert got.keys() == want.keys() and want
    for k, w in want.items():
        a, b = got[k].double().flatten(), w.double().flatten()
        fit, dist = float(a @ b / (b @ b)), float((a - b).norm() / b.norm())
        assert abs(fit - 1) <= BF16_GRAD_SCALE and dist <= BF16_GRAD_DIST, (k, fit, dist)


def _whole_ops(x, weight, bias, deconv) -> dict:
    """The whole-plane twins of ``case_collectives``' ops, by name."""
    ops = {f"shift{s}": (lambda t, s=s: torch.roll(t, s, 2), ()) for s in SHIFTS}
    for name, (pads, stride) in HALO_CONVS.items():
        cols = pads if stride == 2 and pads == (0, 1) else (1, 1)
        ops[name] = (lambda t, w, b, p=pads, st=stride, c=cols: F.conv2d(
            F.pad(t, (c[0], c[1], p[0], p[1])), w, b, stride=st), (weight, bias))
    ops["same_transposed"] = (lambda t, w, b: torch.func.functional_call(
        deconv, {"weight": w, "bias": b}, (t,)), (deconv.weight.detach(), deconv.bias.detach()))
    return ops


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_whole_plane_ops(tmp_path, n):
    """On ``n`` space ranks, in f64 (16 rows: 8 or 4 a rank): the cyclic row
    shift by −3, −1, 2 and 4 rows, ``halo_conv`` with row padding (1, 1) at
    stride 1 and 2 and flax ``SAME``'s (0, 1) at stride 2, and the ``SAME``
    transposed convolution (3×3, stride 2) against ``torch.roll``, the
    padded ``F.conv2d`` and the layer on whole planes: every rank's output
    rows, the input gradient's rows (a halo's gradient sent back to its
    owner, a shift's undone) and the parameters' gradients summed over the
    ranks, to f64 rounding; one exchange each way per call."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 6)))
    weight = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)))
    bias = torch.from_numpy(rng.standard_normal(4))
    deconv = init_weights(SameConvTranspose2d(3, 4, 3, 2), torch.Generator().manual_seed(n))
    deconv = deconv.double()
    ops = _whole_ops(x, weight, bias, deconv)
    want, grads = {}, {}
    for name, (fn, params) in ops.items():
        xw = x.clone().requires_grad_()
        ps = [p.clone().requires_grad_() for p in params]
        y = fn(xw, *ps)
        grads[name] = torch.from_numpy(rng.standard_normal(tuple(y.shape)))
        y.backward(grads[name])
        want[name] = (y.detach(), xw.grad, [p.grad for p in ps])
    ranks = run_ranks(n, "test_torch_spatial_zoo", "case_collectives", tmp_path,
                      dict(x=x, grads=grads, weight=weight, bias=bias, deconv=deconv),
                      init=False)
    for name, (y, dx, dps) in want.items():
        got_y = torch.cat([r[name]["y"] for r in ranks], dim=2)
        got_dx = torch.cat([r[name]["dx"] for r in ranks], dim=2)
        assert got_y.shape == y.shape, name
        torch.testing.assert_close(got_y, y, rtol=1e-12, atol=1e-12, msg=name)
        torch.testing.assert_close(got_dx, dx, rtol=1e-12, atol=1e-12, msg=name)
        for i, dp in enumerate(dps):
            torch.testing.assert_close(sum(r[name]["dp"][i] for r in ranks), dp,
                                       rtol=1e-12, atol=1e-12, msg=name)
        counts = ranks[0][name]["counts"]
        if name.startswith("shift"):
            assert (counts["cyclic_shifts"], counts["cyclic_shifts_backward"]) == (1, 1)
        else:
            assert (counts["halo_exchanges"], counts["halo_exchanges_backward"]) == (1, 1)


# rule → (architecture, task, side): one architecture per new row rule
JAX_RULES = {
    "same_conv_plain_norm_prelu": ("UNet", "segmentation", 32),
    "group_norm": ("SegResNet", "segmentation", 32),
    "batch_norm": ("ResidualUNet", "segmentation", 32),
    "cyclic_shift_gathered_stage": ("SwinUNETR", "segmentation", 128),
    "gathered_pool": ("Adityan", "multitask", 32),
}


def _jax_twin(arch: str):
    """The JAX model of :data:`ZOO`'s ``arch`` at the same sizes."""
    from multi_task_breast_cancer_tpu.models import monai_zoo as J
    from multi_task_breast_cancer_tpu.models import swin_unetr as jax_swin
    from multi_task_breast_cancer_tpu.models.multitask import Adityan as JAdityan
    from multi_task_breast_cancer_tpu.models.residual_unet import ResidualUNet as JResidualUNet

    return {"UNet": lambda: J.UNet(channels=CHANNELS), "SegResNet": lambda: J.SegResNet(),
            "ResidualUNet": lambda: JResidualUNet(width=WIDTH),
            "SwinUNETR": lambda: jax_swin.SwinUNETR(feature_size=SWIN_FEATURES),
            "Adityan": lambda: JAdityan(width=WIDTH)}[arch]()


def _jax_rule_model(arch: str, size: int) -> torch.nn.Module:
    model = (SwinUNETR(1, 1, SWIN_FEATURES, size=size) if arch == "SwinUNETR"
             else ZOO[arch][2]())
    init_weights(model, torch.Generator().manual_seed(len(arch) + 1))
    for m in model.modules():  # the two frameworks draw other masks
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def _rule_batch(size: int):
    fold = _fold(B, 12, size)
    return (torch.from_numpy(fold.images.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(fold.masks.transpose(0, 3, 1, 2).copy()),
            torch.from_numpy(make_cls_targets(fold.labels, 3, "multitask")))


@pytest.fixture(scope="module")
def rule_ranks(tmp_path_factory):
    """Every model of :data:`JAX_RULES` on 2 space ranks, one pair of rank
    processes per side: rule → (the model's initial weights, rank 0's
    result); the ranks' buffers after the step bit-identical."""
    out = {}
    for size in sorted({size for _, _, size in JAX_RULES.values()}):
        rules = [r for r, (_, _, sz) in JAX_RULES.items() if sz == size]
        models = [_jax_rule_model(JAX_RULES[r][0], size) for r in rules]
        images, masks, targets = _rule_batch(size)
        ranks = run_ranks(2, "test_torch_spatial_zoo", "case_forwards",
                          tmp_path_factory.mktemp(f"rules{size}"),
                          dict(models=models, images=images, masks=masks, targets=targets,
                               tasks=[JAX_RULES[r][1] for r in rules]), init=False)
        for j, rule in enumerate(rules):
            _same_state([{"state": r[j]["buffers"]} for r in ranks])
            out[rule] = (models[j].state_dict(), ranks[0][j])
    return out


@pytest.mark.parametrize("rule", list(JAX_RULES))
def test_row_rule_matches_jax_on_one_device(rule_ranks, rule, monkeypatch):
    """One architecture per new row rule on 2 space ranks against the JAX
    model on one device from the same weights (``variables_to_jax``): UNet
    (the ``SAME`` stride-2 and transposed convolutions at the global height,
    the plain InstanceNorm's two passes, PReLU), SegResNet (GroupNorm's
    sums), ResidualUNet with dropout 0 (BatchNorm over every rank's rows,
    its running statistics), SwinUNETR at 128² (the cyclic row shift of
    stages 0-2, stage 3's gathered rows) and Adityan (the pool of the
    gathered 1/8 map). The training-mode forward of one batch of 2: every
    output within 2e-4 of its scale, the Engine's loss (fused DICE; focal
    classification) within 2e-4 relative, the moved batch statistics
    within 2e-4 of their scale. JAX's spatial path is GSPMD over this
    single-device math."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.models import residual_unet as jax_residual_unet
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import (
        params_from_jax,
        variables_to_jax,
    )
    from test_torch_seg_zoo import _NoDropout, _warm_swin_masks

    monkeypatch.setattr(jax_residual_unet, "nn", _NoDropout())
    arch, task, size = JAX_RULES[rule]
    state, res = rule_ranks[rule]
    model = _jax_rule_model(arch, size)
    model.load_state_dict(state)
    images, masks, targets = _rule_batch(size)
    if arch == "SwinUNETR":
        _warm_swin_masks(size)
    variables = jax.tree_util.tree_map(jnp.asarray, variables_to_jax(state, model))
    engine = JL.Engine(_jax_twin(arch), init_optimizer("Adam", 1e-3), JL.EngineConfig(
        task=task, n_classes=3, batch_size=B, use_transforms=False))
    # jitted: SwinUNETR's forward at 128² takes ~19 s op by op, ~2 s so
    out, stats = jax.jit(lambda p, bs, x: engine._apply(p, bs, x, train=True))(
        variables["params"], variables.get("batch_stats", FrozenDict()),
        jnp.asarray(images.numpy().transpose(0, 2, 3, 1)))
    loss, _ = engine._losses(out, jnp.asarray(masks.numpy().transpose(0, 2, 3, 1)),
                             jnp.asarray(targets.numpy()))
    want = jax.tree_util.tree_leaves(out)
    have = jax.tree_util.tree_leaves(res["out"])
    assert len(want) == len(have)
    for w, h in zip(want, have):
        w = np.asarray(w)
        h = h.numpy().transpose(0, 2, 3, 1) if h.dim() == 4 else h.numpy()
        assert h.shape == w.shape
        err = np.abs(h - w).max()
        assert err <= RTOL * max(1.0, np.abs(w).max()), err
    assert abs(res["loss"] - float(loss)) <= RTOL * abs(float(loss)), (res["loss"], float(loss))
    assert bool(res["buffers"]) == (arch == "ResidualUNet")
    if res["buffers"]:
        moved = params_from_jax({"params": variables["params"],
                                 "batch_stats": jax.tree_util.tree_map(np.asarray, stats)},
                                model)
        for k, v in res["buffers"].items():
            scale = max(1.0, moved[k].abs().max().item())
            assert (v - moved[k]).abs().max().item() <= RTOL * scale, k
            assert not torch.equal(v, state[k]), k  # the step moved them


# the classes whose instances keep a convolution's rows right under a
# ``space`` group: each takes its halo rows (or one above, the transposed)
HALO_AWARE = (Conv3x3, SameConv2d, SameConvTranspose2d)
ALL_ARCHS = (registry.SEGMENTATION_ARCHS + registry.CLASSIFICATION_ARCHS
             + registry.MULTITASK_ARCHS)


def _narrow(arch: str) -> torch.nn.Module:
    kw = ({"nnunet_widths": NNUNET_WIDTHS} if "nnUNet" in arch
          else {} if arch in ("UnetPlusPlus", "SegResNet", "SwinUNETR",
                              "UNetPlusPlusClassifier", "MTUNetPlusPlus")
          else {"width": WIDTH})
    if arch in registry.SEGMENTATION_ARCHS:
        return registry.init_segmentation_model(arch, size=32, **kw)
    if arch in registry.CLASSIFICATION_ARCHS:
        return registry.init_classification_model(arch, size=32, **kw)
    return registry.init_multitask_model(arch, size=32, **kw)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_row_spanning_convolution_is_halo_aware(arch):
    """Each of the 17 architectures: every ``nn.Conv2d`` or
    ``nn.ConvTranspose2d`` whose kernel spans rows (height above 1) at a
    stride below its height reads rows of its neighbours' shards, so it
    must be one of the halo-aware classes (a plain ``Conv2d(padding=1)``
    would zero-pad each shard's edge under a ``space`` group). Its class
    has a row multiple too."""
    model = _narrow(arch)
    assert spatial.row_multiple(type(model)) >= 8
    spanning = [(name, type(m).__name__) for name, m in model.named_modules()
                if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
                and m.kernel_size[0] > 1 and m.stride[0] < m.kernel_size[0]]
    assert spanning, arch
    assert [(n, c) for n, c in spanning if c not in {k.__name__ for k in HALO_AWARE}] == []
    assert all(isinstance(m, HALO_AWARE) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))
               and m.kernel_size[0] > 1 and m.stride[0] < m.kernel_size[0])
