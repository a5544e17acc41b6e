"""The port's spatial partitioning (``parallel/spatial.py``, the Engine and
the driver over a ``(data × space)`` mesh) on the CPU: the twins of JAX's
``tests/test_spatial.py``.

Ranks run as processes over Gloo (``test_torch_parallel.run_ranks``), one
torch thread each, every rank from rank 0's weights. Each holds its rows of
every image; the halo exchanges, the norm's split statistics and the Dice,
pooling and flatten collectives are the port's own, so a run on the mesh
must compute what one process computes on the same global batch, up to the
order of its sums: 2e-4 relative, JAX's own bound
(``tests/test_spatial.py:81, 235``), against the port in one process and,
with the augmentation off, against the JAX Engine on one device (the JAX
draws cannot be reproduced in torch; with them on, the port in one process
is the reference, and ``tests/test_torch_engine.py`` holds it to JAX).
Parameters across ranks: bit for bit.

The split-statistics twins are held against the fused twin on one plane cut
at every row, in f32 and bf16, and on a plane whose mean is 1e4 times its
spread, where only a two-pass variance survives f32.

Worker processes import this module without JAX and run its ``case_*``
functions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.blocks import Conv3x3, InstanceNorm
from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
from multi_task_breast_cancer_tpu_torch.parallel import multihost, spatial
from multi_task_breast_cancer_tpu_torch.parallel.mesh import DataMesh, data_space_mesh
from multi_task_breast_cancer_tpu_torch.parallel.spatial import Space
from multi_task_breast_cancer_tpu_torch.train.loop import (
    Engine,
    EngineConfig,
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

SIZE = 64
WIDTHS = [4, 8, 8, 16, 16]
KEYS = ("loss", "seg_loss", "cls_loss", "dice", "acc", "f1")


# ---------------------------------------------------------------------------
# cases (run on every rank)
# ---------------------------------------------------------------------------

def _join(rank: int, world: int, port: int, n_space: int):
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
    return data_space_mesh(n_space, device="cpu")


def case_runs(rank, world, port, n_space, runs, hooks=False):
    """Each run of ``runs`` (``_engine_run``'s arguments) as this rank of a
    ``(world/n_space data × n_space space)`` mesh; the halo and collective
    counts of each, and (``hooks``) the rows every 3×3 convolution saw."""
    mesh = _join(rank, world, port, n_space)
    out = []
    for run in runs:
        spatial.reset_counts()
        rows = _hooked(run["model"]) if hooks else None
        res = _engine_run(_perturbed_unless_rank0(run["model"], rank), run["cfg"], mesh,
                          run["train"], run["perm"], run.get("val"), run.get("predict"))
        res["counts"] = dict(spatial.counts)
        res["rows"] = rows
        out.append(res)
    try:
        data_space_mesh(3, device="cpu")
        indivisible = None
    except ValueError as e:
        indivisible = str(e)
    return {"runs": out, "shape": mesh.shape, "data": mesh.data.rank,
            "space": mesh.space.index, "indivisible": indivisible}


def _hooked(model: torch.nn.Module, halos: bool = True) -> dict:
    """Records, per 3×3 convolution call, the rows of its input and the
    rows of the tensor the convolution read (its input with the halos under
    a ``space`` group, read from ``spatial.halo_exchange``, which ``halos``
    wraps for the rest of the process; else as padded by ``padding=1``),
    and its output's."""
    rec = {"inputs": [], "read": [], "outputs": []}
    if halos:
        halo = spatial.halo_exchange

        def recording_halo(x, space, k=1):
            out = halo(x, space, k)
            rec["read"].append(out.shape[2])
            return out

        spatial.halo_exchange = recording_halo

    def hook(mod, inp, out):
        rec["inputs"].append(inp[0].shape[2])
        rec["outputs"].append(out.shape[2])
        if spatial.current() is None:
            rec["read"].append(inp[0].shape[2] + 2)

    for m in model.modules():
        if isinstance(m, Conv3x3):
            m.register_forward_hook(hook)
    return rec


def case_driver(rank, world, port, cfg, run_root):
    """``run_experiment`` as this rank (rank 0 writes under ``run_root``)."""
    from multi_task_breast_cancer_tpu_torch.train.driver import run_experiment

    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
    return run_experiment(cfg, "multitask", "CV",
                          run_root=multihost.coordinator_run_root(run_root), device="cpu")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _fold(n, seed):
    from test_torch_engine import _fold as fold
    return fold(n, seed, size=SIZE)


def _multi_btsunet(seed: int = 1):
    return registry.init_multitask_model("Multi_BTSUNet", width=4, size=SIZE,
                                         generator=torch.Generator().manual_seed(seed))


def _runs(make_model, cfgs, train, perm, val=None, predict=None) -> list:
    return [dict(model=make_model(), cfg=cfg, train=train, perm=perm, val=val,
                 predict=predict) for cfg in cfgs]


def _single(run: dict) -> dict:
    return _engine_run(run["model"], run["cfg"], None, run["train"], run["perm"],
                       run.get("val"), run.get("predict"))


def _check_against_single(ranks: list, runs: list, singles: list) -> None:
    for i, single in enumerate(singles):
        per_run = [r["runs"][i] for r in ranks]
        _same_state(per_run)
        for res in per_run:
            assert not _close(res["train"], single["train"], RTOL, keys=KEYS)
            if "val" in single:
                assert not _close(res["val"], single["val"], RTOL, keys=KEYS)
            if "predict" in single:
                _outputs_close(res["predict"], single["predict"], 1e-5)
            assert res["counts"]["halo_exchanges"] > 0
        for k, v in single["state"].items():
            np.testing.assert_allclose(per_run[0]["state"][k].numpy(), v.numpy(),
                                       rtol=RTOL, atol=RTOL * max(1.0, v.abs().max().item()))
        _grads_close(per_run[0]["grads"], single["grads"])


def _grads_close(got: dict, want: dict) -> None:
    """The first step's gradient after the all-reduce, tensor by tensor,
    within 2e-4 of each tensor's largest element of one process's: Adam's
    state after a step hardly moves when a gradient is scaled, so a term
    the ranks lose or count twice shows here and not in the states."""
    assert got.keys() == want.keys() and want
    for k, w in want.items():
        err = (got[k] - w).abs().max().item()
        assert err <= RTOL * w.abs().max().item(), (k, err, w.abs().max().item())


def _jax_epoch(model: torch.nn.Module, train, perm, val) -> tuple:
    """The JAX Engine on one device from ``model``'s weights: one epoch
    without augmentation and the evaluation of ``val``."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.models.multitask import MultiBTSUNet as JMultiBTSUNet
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_to_jax

    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict(), model))
    tx = init_optimizer("Adam", 1e-3)
    engine = JL.Engine(JMultiBTSUNet(width=4), tx,
                       JL.EngineConfig(task="multitask", n_classes=3, batch_size=4,
                                       use_transforms=False))
    state = TrainState(params=params, batch_stats=FrozenDict(), opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    state, tm = engine.train_epoch(state, engine.device_data(JaxDataset(**vars(train))), perm,
                                   jax.random.PRNGKey(1))
    return tm, engine.eval_epoch(state, engine.device_data(JaxDataset(**vars(val))))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_space", [4, 2], ids=["1x4", "2x2"])
def test_multi_btsunet_on_a_space_mesh_matches_one_process_and_jax(tmp_path, n_space):
    """``test_spatial_training_matches_single_device`` in the port:
    Multi_BTSUNet at width 4, batch 4 of 64² images, one epoch with the
    exact augmentation on and one with it off, each then evaluated on 6
    images and predicting 3, on 4 ranks as 1 data × 4 space and as 2 × 2.
    Both match one process; the run without augmentation matches the JAX
    Engine on one device too (its losses at 2e-4, its thresholded Dice to
    two pixels). Mesh coordinates are JAX's row-major ones, and
    3 space ranks do not divide 4 (``ValueError``)."""
    train, val = _fold(8, 0), _fold(6, 1)
    perm = plan_epoch_indices(len(train), 4, np.random.default_rng(42))
    cfgs = [EngineConfig(task="multitask", n_classes=3, batch_size=4, max_angle=180.0),
            EngineConfig(task="multitask", n_classes=3, batch_size=4, use_transforms=False)]
    runs = _runs(_multi_btsunet, cfgs, train, perm, val, val.images[:3])
    ranks = run_ranks(4, "test_torch_spatial", "case_runs", tmp_path,
                      dict(n_space=n_space, runs=runs), init=False)
    for rank, res in enumerate(ranks):
        assert res["shape"] == (4 // n_space, n_space)
        assert (res["data"], res["space"]) == divmod(rank, n_space)
        assert "must divide the device count" in res["indivisible"]
    singles = [_single(run) for run in _runs(_multi_btsunet, cfgs, train, perm, val,
                                             val.images[:3])]
    _check_against_single(ranks, runs, singles)

    # across frameworks the thresholded Dice moves by single pixels (ROADMAP.md
    # Queue 3, "to watch"): held to two pixels' worth, 3/P each for a batch
    # of P lesion pixels (2·tp + fp + fn ≥ P)
    jtm, jvm = _jax_epoch(_multi_btsunet(), train, perm, val)
    steps = perm.reshape(-1, 4)
    pixel_train = 3.0 / min(train.masks[rows].sum() for rows in steps)
    pixel_val = 3.0 / val.masks.sum()
    for res in ranks:
        got_t, got_v = res["runs"][1]["train"], res["runs"][1]["val"]
        assert not _close(got_t, jtm, RTOL, keys=("loss", "seg_loss", "cls_loss"))
        assert not _close(got_v, jvm, RTOL, keys=("loss", "seg_loss", "cls_loss", "acc"))
        assert abs(got_t["dice"] - jtm["dice"]) <= 2 * pixel_train
        assert abs(got_v["dice"] - jvm["dice"]) <= 2 * pixel_val


@pytest.mark.parametrize("n_space", [4, 2], ids=["1x4", "2x2"])
def test_spatial_composes_with_fast_augmentation(tmp_path, n_space):
    """``test_spatial_composes_with_fast_augmentation`` in the port: the same
    epoch with the fast augmentation (its plain twin here), which every rank
    of a ``space`` group runs on its data shard's whole planes before
    keeping its rows; the rows each rank trains on are its rows of the
    single-process batch, bit for bit, and ``fast_joint_transform`` under
    the mesh gives its data shard's whole planes of the single-device
    call."""
    from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
    from test_torch_parallel import _augmented_rows

    train, val = _fold(8, 0), _fold(6, 1)
    perm = plan_epoch_indices(len(train), 4, np.random.default_rng(42))
    cfg = EngineConfig(task="multitask", n_classes=3, batch_size=4, max_angle=180.0,
                       fast_augmentation=True)
    runs = _runs(_multi_btsunet, [cfg], train, perm, val)
    ranks = run_ranks(4, "test_torch_spatial", "case_runs", tmp_path,
                      dict(n_space=n_space, runs=runs), init=False)
    _check_against_single(ranks, runs, [_single(runs[0] | {"model": _multi_btsunet()})])

    whole = _augmented_rows(_multi_btsunet(), cfg, None, train, perm)["rows"]
    for rank in range(4):
        d, s = divmod(rank, n_space)
        space = Space(n_space, s, tuple(range(d * n_space, (d + 1) * n_space)))
        mesh = DataMesh(4, rank, torch.device("cpu"), space=space,
                        data_axis=DataMesh(4 // n_space, d, torch.device("cpu")))
        engine = Engine(_multi_btsunet(), cfg, device="cpu", mesh=mesh)
        data = engine.device_data(train)
        draws = engine._epoch_draws(2, torch.Generator().manual_seed(4))  # _augmented_rows' seed
        rows = torch.as_tensor(perm, dtype=torch.int32).reshape(2, 4)
        rs = space.rows(SIZE)
        for k, (imgs, msks) in enumerate(whole):
            got = engine._space_rows(*engine._augmented_batch(
                data, rows[k, mesh.shard(4)], draws, k, mesh.shard(4)))
            assert torch.equal(got[0], imgs[mesh.shard(4), :, rs])
            assert torch.equal(got[1], msks[mesh.shard(4), :, rs])
        stack = np.concatenate([train.masks, train.images], axis=-1)
        planes, fmt = FA.pack_channels(torch.from_numpy(stack), "float32")
        draws = FA.draw_flips_and_angles(torch.Generator().manual_seed(0), (4,), p_hflip=0.5,
                                         p_vflip=0.5, max_angle=360.0)
        bidx = torch.tensor([5, 0, 7, 2], dtype=torch.int32)
        whole_batch = FA.fast_joint_transform(planes, bidx, draws, fmt)
        got = FA.fast_joint_transform(planes, bidx, draws, fmt, mesh=mesh)
        assert torch.equal(got, whole_batch[mesh.shard(4)])


@pytest.mark.parametrize("arch", ["BTSUNet", "MTnnUNet"])
def test_convolutions_read_halo_rows_and_norms_split(tmp_path, arch):
    """BTSUNet (segmentation, exact augmentation) and MTnnUNet at widths
    (4, 8, 8, 16, 16) on 2 space ranks: every 3×3 convolution's input has
    H/2 rows at its level and the convolution reads H/2 + 2 (one halo row
    each side), its output H/2; the epoch and the evaluation match one
    process. The halo counter counts one exchange per 3×3 convolution
    forward (and one backward for each but the first) under ``space`` and
    none in one process."""
    if arch == "BTSUNet":
        def make():
            return registry.init_segmentation_model("BTSUNet", width=4, size=SIZE,
                                                    generator=torch.Generator().manual_seed(3))
        cfg = EngineConfig(task="segmentation", n_classes=3, batch_size=4)
    else:
        def make():
            return registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                                 generator=torch.Generator().manual_seed(3))
        cfg = EngineConfig(task="multitask", n_classes=3, batch_size=4, use_transforms=False)
    train, val = _fold(4, 2), _fold(2, 3)
    perm = plan_epoch_indices(len(train), 4, np.random.default_rng(7))
    runs = _runs(make, [cfg], train, perm, val)
    ranks = run_ranks(2, "test_torch_spatial", "case_runs", tmp_path,
                      dict(n_space=2, runs=runs, hooks=True), init=False)

    spatial.reset_counts()
    model = make()
    single_rows = _hooked(model, halos=False)
    singles = [_single(runs[0] | {"model": model})]
    assert set(spatial.counts.values()) == {0}
    _check_against_single(ranks, runs, singles)
    n_convs = sum(isinstance(m, Conv3x3) for m in model.modules())
    for res in ranks:
        got = res["runs"][0]
        rows, counts = got["rows"], got["counts"]
        assert len(rows["inputs"]) == len(single_rows["inputs"]) == 2 * n_convs
        assert rows["inputs"] == [h // 2 for h in single_rows["inputs"]]
        assert rows["read"] == [h + 2 for h in rows["inputs"]]
        assert rows["outputs"] == rows["inputs"]
        # one training step and one evaluation forward; the backward has no
        # exchange for the first convolution, whose input (the image) needs
        # no gradient
        assert counts["halo_exchanges"] == 2 * n_convs
        assert counts["halo_exchanges_backward"] == n_convs - 1
        assert counts["collectives"] > 0


# the rest of the slice: architecture → (task, n_classes)
SLICE = {
    "nnUNet": ("segmentation", 3),
    "FSBBTSUNet": ("segmentation", 3),
    "nnUNetClassifier": ("classification", 3),
    "BTSUNetClassifier": ("classification", 3),
    "Multi_FSB_BTSUNet": ("multitask", 2),
}


def _slice_model(arch: str):
    task, n_classes = SLICE[arch]
    gen = torch.Generator().manual_seed(4)
    if task == "segmentation":
        kw = {"nnunet_widths": WIDTHS} if arch == "nnUNet" else {"width": 4,
                                                                 "deep_supervision": True}
        return registry.init_segmentation_model(arch, size=SIZE, generator=gen, **kw)
    if task == "classification":
        kw = {"nnunet_widths": WIDTHS} if arch == "nnUNetClassifier" else {"width": 4}
        return registry.init_classification_model(arch, n_classes=n_classes, size=SIZE,
                                                  generator=gen, **kw)
    return registry.init_multitask_model(arch, n_classes=n_classes, width=4,
                                         deep_supervision=True, size=SIZE, generator=gen)


@pytest.mark.parametrize("arch", sorted(SLICE))
def test_the_rest_of_the_slice_on_two_space_ranks(tmp_path, arch):
    """The slice's other architectures (nnUNet and nnUNetClassifier at
    widths (4, 8, 8, 16, 16), the BTS ones at width 4 with deep supervision
    where they have it; BTSUNetClassifier's flatten at 1/16, Multi_FSB's one
    logit) on 2 space ranks: one epoch with the exact augmentation and an
    evaluation match one process, parameters bit-identical."""
    task, n_classes = SLICE[arch]
    train, val = _fold(4, 5), _fold(2, 6)
    if n_classes == 2:
        train.labels, val.labels = train.labels % 2, val.labels % 2
    perm = plan_epoch_indices(len(train), 2, np.random.default_rng(3))
    cfg = EngineConfig(task=task, n_classes=n_classes, batch_size=2)
    runs = _runs(lambda: _slice_model(arch), [cfg], train, perm, val)
    ranks = run_ranks(2, "test_torch_spatial", "case_runs", tmp_path,
                      dict(n_space=2, runs=runs), init=False)
    _check_against_single(ranks, runs, [_single(runs[0] | {"model": _slice_model(arch)})])


def test_driver_trains_spatially_partitioned(tmp_path):
    """``test_driver_trains_spatially_partitioned`` in the port: the driver
    with ``spatial_partitions: 2`` on 2 ranks (1 data × 2 space), two epochs
    and 2-fold CV of Multi_BTSUNet at width 4 on a 64² tree. ``metrics.csv``
    has no NaN and equals the 2-rank data-parallel run's at 2e-4, and the
    log names the mesh's axes and shape."""
    import pandas as pd

    from multi_task_breast_cancer_tpu_torch.config import (
        Config,
        DataConfig,
        LossConfig,
        ModelConfig,
        OptimizerConfig,
        TrainingConfig,
    )
    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_preprocessed_busi

    root = make_preprocessed_busi(tmp_path / "busi", n_per_class=8, size=SIZE)
    metrics = {}
    for n_space in (2, 1):
        cfg = Config(
            model=ModelConfig(architecture="Multi_BTSUNet", width=4, deep_supervision=False),
            optimizer=OptimizerConfig(opt="Adam", lr=1e-3, scheduler="plateau"),
            loss=LossConfig(function="DICE", inversely_weighted=True,
                            classification_criterion="Focal"),
            training=TrainingConfig(seed=1993, epochs=2, CV=2, max_patience=50,
                                    spatial_partitions=n_space),
            data=DataConfig(input_img=str(root), batch_size=4, oversampling=True))
        out = tmp_path / f"runs{n_space}"
        run = run_ranks(2, "test_torch_spatial", "case_driver", tmp_path / f"d{n_space}",
                        dict(cfg=cfg, run_root=str(out)), init=False)[0]
        metrics[n_space] = [pd.read_csv(f"{run}/fold_{n}/metrics.csv") for n in (0, 1)]
        log = (out / run.rsplit("/", 1)[-1] / "execution.log").read_text()
        if n_space == 2:
            assert "mesh axes ('data', 'space'), shape (1, 2)" in log
    for got, want in zip(metrics[2], metrics[1]):
        assert len(got) == 2 and got.notna().all().all()
        assert list(got.columns) == list(want.columns)
        np.testing.assert_allclose(got.to_numpy(float), want.to_numpy(float), rtol=RTOL,
                                   atol=1e-7)


def _fake_mesh(n_space: int = 2) -> DataMesh:
    """A ``(1 × n_space)`` mesh object for checks made before any collective."""
    cpu = torch.device("cpu")
    return DataMesh(n_space, 0, cpu, space=Space(n_space, 0, tuple(range(n_space))),
                    data_axis=DataMesh(1, 0, cpu))


def test_what_spatial_partitioning_refuses():
    """What still raises under a ``space`` group: an image height that is
    not a multiple of n_space · 2^halvings, for each architecture's row
    multiple (the Engine's ``ValueError`` names the rule); an average pool
    whose window crosses a shard's edge; ``torch.export`` of the norm under
    the group; and a model class without a row multiple (a model whose row
    rules were never written). Every one of the 17 architectures has its
    multiple, every segmentation criterion builds an Engine on the mesh,
    and the layers that raised before (the plain norms, the ``SAME``
    convolutions, ``LayerNorm``) run there. A mesh size that does not divide
    the ranks is ``test_multi_btsunet_on_a_space_mesh_...``'s."""
    from multi_task_breast_cancer_tpu_torch.models import (
        classifiers,
        monai_zoo,
        multitask,
        nnunet,
        residual_unet,
        swin_unetr,
        unetpp,
    )
    from multi_task_breast_cancer_tpu_torch.models.blocks import (
        GroupNorm,
        LayerNorm,
        SameConv2d,
        avg_pool,
    )
    from multi_task_breast_cancer_tpu_torch.models.bts_unet import BTSUNet
    from multi_task_breast_cancer_tpu_torch.models.fsb_bts_unet import FSBBTSUNet
    from multi_task_breast_cancer_tpu_torch.ops.losses import SEG_CRITERIA

    cfg = EngineConfig(task="segmentation", n_classes=3, batch_size=2, use_transforms=False)
    bts = registry.init_segmentation_model("BTSUNet", width=4, size=SIZE)
    engine = Engine(bts, cfg, device="cpu", mesh=_fake_mesh())
    for h, ok in ((48, True), (40, False), (64, True), (56, False)):
        ds = _fold(2, 0)
        ds.images, ds.masks = ds.images[:, :h], ds.masks[:, :h]
        if ok:
            engine.device_data(ds)
        else:
            with pytest.raises(ValueError, match=r"H % \(n_space · 2\^pools\) == 0"):
                engine.device_data(ds)
    nn_cfg = EngineConfig(task="multitask", n_classes=3, batch_size=2, use_transforms=False)
    mt = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    with pytest.raises(ValueError, match="2 · 32 = 64"):
        Engine(mt, nn_cfg, device="cpu", mesh=_fake_mesh()).predict(
            None, np.zeros((1, 32, 32, 1), np.float32))
    # the rest of the zoo: a height of n_space · multiple passes, half of it raises
    for arch, multiple in (("UNet", 8), ("AttentionUNet", 8), ("SegResNet", 8),
                           ("ResidualUNet", 8), ("UnetPlusPlus", 16), ("SwinUNETR", 32)):
        model = registry.init_segmentation_model(arch, width=4, size=64)
        eng = Engine(model, cfg, device="cpu", mesh=_fake_mesh())
        eng._check_rows(2 * multiple)
        with pytest.raises(ValueError, match=f"2 · {multiple} = {2 * multiple}"):
            eng._check_rows(multiple)
    for crit in SEG_CRITERIA:
        Engine(bts, EngineConfig(task="segmentation", seg_criterion=crit), device="cpu",
               mesh=_fake_mesh())
    x = torch.zeros(1, 4, 8, 8)
    with spatial.partitioned(_fake_mesh().space):
        with pytest.raises(NotImplementedError, match="crosses the edge"):
            avg_pool(x, 3)
        assert avg_pool(x, 4).shape == (1, 4, 2, 2)  # windows inside the shard
        assert LayerNorm(8)(x).shape == x.shape
    for layer in (InstanceNorm(), GroupNorm(2, 4), SameConv2d(4, 4, 3, 2)):
        layer(x)  # outside a group, as before

    class Norm(torch.nn.Module):
        def forward(self, t):
            return hk.instance_norm_leaky_relu(t, space=_fake_mesh().space)

    with pytest.raises(NotImplementedError, match="exported program has no space group"):
        torch.export.export(Norm(), (x,))

    class NoRules(torch.nn.Module):
        pass

    with pytest.raises(NotImplementedError, match="NoRules has no space_row_multiple"):
        spatial.row_multiple(NoRules)
    with pytest.raises(NotImplementedError, match="NoRules has no space_row_multiple"):
        Engine(NoRules(), cfg, device="cpu", mesh=_fake_mesh())
    multiples = {
        nnunet.NNUNet2021: 32, multitask.MTnnUNet: 32, classifiers.NNUNetClassifier: 32,
        BTSUNet: 8, FSBBTSUNet: 8, classifiers.BTSUNetClassifier: 16,
        multitask.MultiBTSUNet: 8, multitask.MultiFSBBTSUNet: 8,
        monai_zoo.UNet: 8, monai_zoo.AttentionUNet: 8, monai_zoo.SegResNet: 8,
        residual_unet.ResidualUNet: 8, swin_unetr.SwinUNETR: 32,
        unetpp.BasicUNetPlusPlus: 16, unetpp.UNetPlusPlusClassifier: 16,
        unetpp.MTUNetPlusPlus: 16, multitask.Adityan: 16}
    assert len(multiples) == 17
    assert {c: spatial.row_multiple(c) for c in multiples} == multiples


def _parts(x: torch.Tensor, cut: int) -> list:
    return [x[:, :, :cut], x[:, :, cut:]]


def _split_twins(x: torch.Tensor, g: torch.Tensor, cut: int):
    """The split twins on the rows above and below ``cut``, the parts'
    sums added in order as a ``space`` group adds them: (y, dx)."""
    total = x.shape[2] * x.shape[3]
    xs, gs = _parts(x, cut), _parts(g, cut)
    sums = sum(hk.instance_norm_split_sums(p, total) for p in xs)
    sq = sum(hk.instance_norm_split_sums(p, total, sums) for p in xs)
    y = torch.cat([hk.instance_norm_leaky_relu_split_apply(p, sums, sq, total) for p in xs], 2)
    gsum = sum(hk.instance_norm_leaky_relu_split_backward_sums(p, q, sums, sq, total)
               for p, q in zip(xs, gs))
    dx = torch.cat([hk.instance_norm_leaky_relu_split_backward_apply(p, q, sums, sq, gsum, total)
                    for p, q in zip(xs, gs)], 2)
    return y, dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_statistics_twins_match_the_fused_twin_at_every_cut(dtype):
    """The four split twins, a plane cut after every row, against the fused
    twin on the whole plane, forward and backward: f32 within 2e-6 of the
    output's scale (the two add in other orders); bf16 within one bf16 ulp
    (each rounds its f32 result once). The statistics are f32 for bf16 input
    too."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 9, 6)).astype(np.float32) * 3 + 1)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    x, g = x.to(dtype), g.to(dtype)
    y0 = hk.instance_norm_leaky_relu_reference(x)
    dx0 = hk.instance_norm_leaky_relu_backward_reference(x, g)
    assert hk.instance_norm_split_sums(x, 54).dtype == torch.float32
    for cut in range(1, x.shape[2]):
        y, dx = _split_twins(x, g, cut)
        assert y.dtype == dx.dtype == dtype
        for got, want in ((y, y0), (dx, dx0)):
            got, want = got.float(), want.float()
            if dtype == torch.float32:
                tol = 2e-6 * want.abs().max()
            else:
                tol = 2.0 ** -7 * want.abs()
            assert ((got - want).abs() <= tol).all(), cut


def test_split_statistics_stay_two_pass_on_a_far_off_mean():
    """A plane whose mean is 1e4 times its spread: each part's Σ(x − mean)²
    of the combined mean keeps the variance, where E[x²] − mean² in f32
    would lose it (it is shown to here). The split result and the fused twin
    both stay within the input's own resolution (a few f32 ulps of 1e4 over
    the spread of 1) of the f64 answer, at every cut."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((1e4 + rng.standard_normal((1, 2, 8, 8))).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    y64 = hk.instance_norm_leaky_relu_reference(x.double())
    dx64 = hk.instance_norm_leaky_relu_backward_reference(x.double(), g.double())
    resolution = 8 * float(np.spacing(np.float32(1e4)))  # of x̂ at spread 1
    fused = hk.instance_norm_leaky_relu_reference(x).double()
    assert (fused - y64).abs().max() <= resolution
    for cut in range(1, 8):
        y, dx = _split_twins(x, g, cut)
        assert (y.double() - y64).abs().max() <= resolution, cut
        assert (dx.double() - dx64).abs().max() <= 2 * resolution, cut
    xf = x.float()
    one_pass = (xf * xf).mean(dim=(2, 3)) - xf.mean(dim=(2, 3)) ** 2
    true_var = x.double().var(dim=(2, 3), unbiased=False)
    assert ((one_pass.double() - true_var).abs() > 0.1 * true_var).any()
