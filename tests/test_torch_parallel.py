"""The port's data parallelism (``parallel/``, the Engine over a data mesh)
on the CPU: ranks run as processes over Gloo on free local ports, one torch
thread each, and are held to the single-process port and to the JAX Engine
on a JAX data mesh (the JAX side runs on the conftest's 8 CPU devices).

Every rank starts from rank 0's weights (``replicate_to_mesh``): ranks
other than 0 perturb theirs first. Tolerances: a run over ranks against the
single-process run, 2e-4 relative (``tests/test_parallel.py``'s bound for
JAX's own mesh; the two sum their losses and gradients in other orders);
against the JAX Engine, ``tests/test_torch_engine.py``'s 1e-4 relative +
1e-6 absolute; ResidualUNet's running statistics 1e-5 of their scale (the rule of
``tests/test_torch_seg_zoo.py``). Parameters across ranks, the
augmented rows and the dropout masks: exactly. ``predict`` over ranks
against one process from the same state, 1e-5 of each output's scale (the
CPU's convolutions sum in other orders at other batch sizes).

Worker processes import this module (without JAX, which the tests import
inside their bodies) and run one of its ``case_*`` functions on their rank
(:func:`run_ranks`).
"""

from __future__ import annotations

import importlib
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.blocks import Dropout
from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
from multi_task_breast_cancer_tpu_torch.parallel import multihost
from multi_task_breast_cancer_tpu_torch.parallel.mesh import (
    DataMesh,
    data_mesh,
    data_space_mesh,
    replicate_to_mesh,
)
from multi_task_breast_cancer_tpu_torch.train.loop import (
    Engine,
    EngineConfig,
    plan_epoch_indices,
)
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

ROOT = Path(__file__).resolve().parent.parent
TESTS = Path(__file__).resolve().parent
RTOL = 2e-4
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6
STATS_TOL = 1e-5
METRICS = ("loss", "seg_loss", "cls_loss", "dice", "acc", "f1")


# ---------------------------------------------------------------------------
# ranks as processes
# ---------------------------------------------------------------------------

def run_ranks(n: int, module: str, case: str, tmp_path: Path, args: dict,
              init: bool = True, timeout: float = 300.0) -> list:
    """Run ``module.case(mesh, **args)`` on ``n`` ranks, each a process
    joined over Gloo on a free port of this host (``init=False``: the case
    gets ``rank, world, port`` and joins itself); returns each rank's
    result (``torch.save``-able), rank by rank."""
    out = tmp_path / case
    out.mkdir(parents=True, exist_ok=True)
    torch.save(args, out / "args.pt")
    port = multihost.free_port()
    code = (f"import sys; sys.path[:0] = [{str(TESTS)!r}, {str(ROOT)!r}]; "
            "import test_torch_parallel as t; t._rank_main()")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, module, case, str(r), str(n),
                               str(port), str(out), str(int(init))], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case} failed:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


def _rank_main() -> None:
    module, case, rank, world, port, out, init = sys.argv[1:8]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    args = torch.load(Path(out) / "args.pt", weights_only=False)
    fn = getattr(importlib.import_module(module), case)
    if init == "1":
        multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                             timeout_s=120)
        result = fn(data_mesh(device="cpu"), **args)
    else:
        result = fn(rank, world, int(port), **args)
    torch.save(result, Path(out) / f"rank{rank}.pt")
    if torch.distributed.is_initialized():
        # leave together and shut Gloo's threads down before the interpreter
        # exits: otherwise a rank can abort at exit ("terminate called without
        # an active exception") once the others have gone
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()


def _perturbed_unless_rank0(model: torch.nn.Module, rank: int) -> torch.nn.Module:
    """Weights of another seed on ranks other than 0, which
    ``replicate_to_mesh`` must overwrite with rank 0's."""
    if rank:
        with torch.no_grad():
            gen = torch.Generator().manual_seed(100 + rank)
            for p in model.parameters():
                p.add_(torch.randn(p.shape, generator=gen))
    return model


def _engine_run(model, cfg: EngineConfig, mesh, train, perm, val=None, predict=None,
                seed: int = 2, dropout_seed=None) -> dict:
    """One epoch of ``train`` on ``perm``, validation on ``val`` and a
    prediction of ``predict``, on one process (``mesh=None``) or as this
    rank; the metrics, the first step's gradient as the optimizer gets it
    (after the all-reduce), the final state and the outputs."""
    engine = Engine(model, cfg, device="cpu", mesh=mesh)
    state = replicate_to_mesh(mesh, create_train_state(engine.model, "Adam", 1e-3))
    grads, named, opt_step = {}, dict(engine.model.named_parameters()), state.optimizer.step

    def record_grads(*args, **kwargs):
        if not grads:
            grads.update({n: p.grad.clone() for n, p in named.items() if p.grad is not None})
        return opt_step(*args, **kwargs)

    state.optimizer.step = record_grads
    data = engine.device_data(train)
    drop = None if dropout_seed is None else torch.Generator().manual_seed(dropout_seed)
    state, tm = engine.train_epoch(state, data, perm, torch.Generator().manual_seed(seed),
                                   dropout_generator=drop)
    out = {"train": tm, "grads": grads,
           "state": {k: v.clone() for k, v in state.model.state_dict().items()}}
    if val is not None:
        out["val"] = engine.eval_epoch(state, engine.device_data(val, for_training=False))
    if predict is not None:
        out["predict"] = engine.predict(state, predict)
    return out


def _dataset(n: int = 16, size: int = 32, seed: int = 0) -> ArrayDataset:
    """``tests/test_parallel.py``'s dataset."""
    rng = np.random.default_rng(seed)
    return ArrayDataset(
        images=(rng.random((n, size, size, 1)) * 255).astype(np.float32),
        masks=(rng.random((n, size, size, 1)) > 0.7).astype(np.float32),
        labels=rng.integers(0, 3, n).astype(np.int32), patient_ids=np.arange(n),
        class_names=["benign"] * n, tumor_pixels=np.zeros(n, np.int64))


def _single_predict(model: torch.nn.Module, cfg: EngineConfig, state: dict, images):
    """``predict`` on one process from a rank's final state."""
    model.load_state_dict(state)
    engine = Engine(model, cfg, device="cpu")
    return engine.predict(create_train_state(engine.model, "Adam", 1e-3), images)


def _outputs_close(got, want, tol: float = 1e-5) -> None:
    """Each output within ``tol`` of its scale (the CPU's convolutions sum in
    other orders at other batch sizes)."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _outputs_close(g, w, tol)
        return
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


def _close(got: dict, want: dict, rtol: float, atol: float = 0.0, keys=METRICS) -> dict:
    return {k: (got[k], want[k]) for k in keys if k in want
            and abs(got[k] - want[k]) > rtol * abs(want[k]) + atol}


def _same_state(results: list) -> None:
    first = results[0]["state"]
    for r, res in enumerate(results[1:], 1):
        assert all(torch.equal(v, res["state"][k]) for k, v in first.items()), \
            f"rank {r}'s parameters differ from rank 0's"


# ---------------------------------------------------------------------------
# cases (run on every rank)
# ---------------------------------------------------------------------------

def case_epoch(mesh, model, cfg, train, perm, val=None, predict=None, dropout_seed=None):
    return _engine_run(_perturbed_unless_rank0(model, mesh.rank), cfg, mesh, train, perm,
                       val, predict, dropout_seed=dropout_seed)


def case_residual_unet(mesh, model, cfg, train, perm):
    return _residual_runs(_perturbed_unless_rank0(model, mesh.rank), cfg, mesh, train, perm)


def _residual_runs(model, cfg, mesh, train, perm) -> dict:
    """ResidualUNet with dropout off (the JAX comparison's) and on,
    recording each dropout layer's masks (the zeroed outputs of non-zero
    inputs) in the run with dropout on."""
    import copy
    off = copy.deepcopy(model)
    for m in off.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    masks = []
    for m in model.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(
                lambda mod, inp, outp: masks.append(((outp == 0) & (inp[0] != 0)).clone())
                if mod.training else None)
    return {"off": _engine_run(off, cfg, mesh, train, perm),
            "on": _engine_run(model, cfg, mesh, train, perm, dropout_seed=9),
            "masks": masks}


def case_fast_augmentation(mesh, model, cfg, train, perm):
    """The Engine's augmented batch of every step, as this rank sees it."""
    return _augmented_rows(model, cfg, mesh, train, perm)


def _augmented_rows(model, cfg, mesh, train, perm) -> dict:
    engine = Engine(model, cfg, device="cpu", mesh=mesh)
    rows = []
    real = engine._augmented_batch

    def record(*args, **kwargs):
        imgs, msks = real(*args, **kwargs)
        rows.append((imgs.clone(), msks.clone()))
        return imgs, msks

    engine._augmented_batch = record
    state = replicate_to_mesh(mesh, create_train_state(engine.model, "Adam", 1e-3))
    state, tm = engine.train_epoch(state, engine.device_data(train), perm,
                                   torch.Generator().manual_seed(4))
    return {"rows": rows, "train": tm, "state": state.model.state_dict()}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_btsunet_epoch_on_two_ranks_matches_one_process_and_jax_mesh(tmp_path):
    """``tests/test_parallel.py::test_sharded_training_matches_single_device``
    in the port: BTSUNet at width 4, batch 8 of 32² images, one epoch on two
    ranks against one process (and against the JAX Engine on a 2-device
    mesh from the same weights); ``predict`` of 5 images in order. The
    images are ``tests/test_torch_engine.py``'s lesion blobs: on pure noise
    the batch Dice counts pixels whose probability sits at 0.5 within
    rounding, which the two frameworks put on either side of it."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState
    from test_torch_engine import _fold
    from test_torch_zoo import MODELS, _jax_init, _port

    ds = _fold(16, 3, size=32)
    perm = plan_epoch_indices(len(ds), 8, np.random.default_rng(42))
    cfg = EngineConfig(task="segmentation", n_classes=3, batch_size=8, use_transforms=False)
    params, _ = _jax_init("BTSUNet", False)
    images = ds.images[:5]
    args = dict(model=_port("BTSUNet", False, params).train(), cfg=cfg, train=ds, perm=perm,
                val=ds, predict=images)
    ranks = run_ranks(2, "test_torch_parallel", "case_epoch", tmp_path, args)
    single = _engine_run(_port("BTSUNet", False, params).train(), cfg, None, ds, perm, ds,
                         images)

    jmodel, _ = MODELS["BTSUNet"](False)
    tx = init_optimizer("Adam", 1e-3)
    jengine = JL.Engine(jmodel, tx, JL.EngineConfig(task="segmentation", n_classes=3,
                                                    batch_size=8, use_transforms=False),
                        mesh=jax_data_mesh(2))
    jstate = TrainState(params=params, batch_stats=FrozenDict(), opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    jdata = jengine.device_data(JaxDataset(**vars(ds)))
    jstate, jtm = jengine.train_epoch(jstate, jdata, perm, jax.random.PRNGKey(1))
    jvm = jengine.eval_epoch(jstate, jdata)

    _same_state(ranks)
    for res in ranks:
        assert not _close(res["train"], single["train"], RTOL)
        assert not _close(res["val"], single["val"], RTOL)
        assert not _close(res["train"], jtm, JAX_RTOL, JAX_ATOL, ("loss", "dice"))
        assert not _close(res["val"], jvm, JAX_RTOL, JAX_ATOL, ("loss", "dice"))
    want = _single_predict(_port("BTSUNet", False, params), cfg, ranks[0]["state"], images)
    for res in ranks:
        _outputs_close(res["predict"], want)


def test_uneven_batch_over_three_ranks_with_an_empty_shard(tmp_path):
    """``test_dp_batch_smaller_than_mesh`` in the port: Multi_BTSUNet at
    width 4, batch 2 over 3 ranks (rows 1, 1, 0), the exact augmentation on;
    validation of 4 images (shards 2, 2, 0) and ``predict`` of 2 (1, 1, 0).
    The rank with no rows joins every collective; the gradient stays the
    global batch's."""
    from test_torch_engine import _fold

    train, val = _fold(12, 0, size=32), _fold(4, 1, size=32)
    perm = plan_epoch_indices(len(train), 2, np.random.default_rng(1))
    cfg = EngineConfig(task="multitask", n_classes=3, batch_size=2, alpha=0.35,
                       seg_criterion="DICE", cls_criterion="Focal", use_transforms=True)

    def model():
        return registry.init_multitask_model("Multi_BTSUNet", width=4, size=32,
                                             generator=torch.Generator().manual_seed(3))

    assert [DataMesh(3, r, "cpu").shard(2) for r in range(3)] == [
        slice(0, 1), slice(1, 2), slice(2, 2)]
    args = dict(model=model(), cfg=cfg, train=train, perm=perm, val=val,
                predict=val.images[:2])
    ranks = run_ranks(3, "test_torch_parallel", "case_epoch", tmp_path, args)
    single = _engine_run(model(), cfg, None, train, perm, val, val.images[:2])
    _same_state(ranks)
    for res in ranks:
        assert not _close(res["train"], single["train"], RTOL)
        assert not _close(res["val"], single["val"], RTOL)
    want = _single_predict(model(), cfg, ranks[0]["state"], val.images[:2])
    for res in ranks:
        _outputs_close(res["predict"], want)


def test_residual_unet_statistics_and_dropout_on_two_ranks(tmp_path, monkeypatch):
    """ResidualUNet at width 4, batch 2 over 2 ranks (one row each): with
    dropout off, the running statistics after two steps match one process
    and the JAX Engine on a 2-device mesh; with dropout on, every rank's
    masks are its rows of the single-process masks, exactly, and the
    statistics match one process."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.models import residual_unet as jax_residual_unet
    from multi_task_breast_cancer_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax
    from test_torch_engine import _fold
    from test_torch_seg_zoo import MODELS, _engine_cfg, _init, _NoDropout, _port

    fold = _fold(4, 0, size=32)
    perm = np.array([0, 1, 2, 3], np.int32)
    cfg = EngineConfig(**_engine_cfg())
    ranks = run_ranks(2, "test_torch_parallel", "case_residual_unet", tmp_path,
                      dict(model=_port("ResidualUNet"), cfg=cfg, train=fold, perm=perm))
    single = _residual_runs(_port("ResidualUNet"), cfg, None, fold, perm)
    model = _port("ResidualUNet")

    monkeypatch.setattr(jax_residual_unet, "nn", _NoDropout())
    jmodel, _ = MODELS["ResidualUNet"]()
    variables = _init("ResidualUNet")
    tx = init_optimizer("Adam", 1e-3)
    jengine = JL.Engine(jmodel, tx, JL.EngineConfig(**_engine_cfg()), mesh=jax_data_mesh(2))
    jstate = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                        opt_state=tx.init(variables["params"]), step=jnp.zeros((), jnp.int32))
    jstate, jtm = jengine.train_epoch(jstate, jengine.device_data(JaxDataset(**vars(fold))),
                                      perm, jax.random.PRNGKey(1))
    jax_stats = params_from_jax({"params": jax.tree_util.tree_map(np.asarray, jstate.params),
                                 "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                                       jstate.batch_stats)},
                                model)
    buffers = [k for k, _ in model.named_buffers()]
    assert buffers
    _same_state([r["off"] for r in ranks])
    _same_state([r["on"] for r in ranks])
    for rank, res in enumerate(ranks):
        for run in ("off", "on"):
            assert not _close(res[run]["train"], single[run]["train"], RTOL)
            for k in buffers:
                got, want = res[run]["state"][k], single[run]["state"][k]
                scale = max(1.0, want.abs().max().item())
                assert (got - want).abs().max().item() <= STATS_TOL * scale, (run, k)
        assert not _close(res["off"]["train"], jtm, JAX_RTOL, JAX_ATOL, ("loss", "dice"))
        for k in buffers:
            got, want = res["off"]["state"][k], jax_stats[k]
            assert (got - want).abs().max().item() <= STATS_TOL * max(
                1.0, want.abs().max().item()), k
        # two steps of one row each on this rank; the masks are the global ones
        assert len(res["masks"]) == len(single["masks"]) and single["masks"]
        shard = DataMesh(2, rank, "cpu").shard(2)
        for got, want in zip(res["masks"], single["masks"]):
            assert torch.equal(got, want[shard])


def test_fast_augmentation_on_two_ranks_gives_the_single_device_rows(tmp_path, caplog):
    """The fast augmentation (its plain twin here) on 2 ranks, batch 4: every
    step's augmented rows are this rank's rows of the single-process batch,
    bit for bit, and the epoch matches; ``fast_joint_transform`` under a mesh
    is the shard of the single-device call; a batch that does not divide
    over the ranks raises in the Engine, and the driver falls back to the
    exact augmentation with a warning."""
    from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig
    from multi_task_breast_cancer_tpu_torch.train import driver
    from test_torch_engine import _fold

    train = _fold(8, 2, size=32)
    perm = plan_epoch_indices(len(train), 4, np.random.default_rng(5))
    cfg = EngineConfig(task="segmentation", n_classes=3, batch_size=4,
                       fast_augmentation=True)

    def model():
        return registry.init_segmentation_model("BTSUNet", width=4, size=32,
                                                generator=torch.Generator().manual_seed(1))

    ranks = run_ranks(2, "test_torch_parallel", "case_fast_augmentation", tmp_path,
                      dict(model=model(), cfg=cfg, train=train, perm=perm))
    single = _augmented_rows(model(), cfg, None, train, perm)
    _same_state(ranks)
    for rank, res in enumerate(ranks):
        shard = DataMesh(2, rank, "cpu").shard(4)
        assert len(res["rows"]) == len(single["rows"]) == 2
        for (imgs, msks), (want_i, want_m) in zip(res["rows"], single["rows"]):
            assert torch.equal(imgs, want_i[shard]) and torch.equal(msks, want_m[shard])
        assert not _close(res["train"], single["train"], RTOL)

    stack = np.concatenate([train.masks, train.images], axis=-1)
    planes, fmt = FA.pack_channels(torch.from_numpy(stack), "float32")
    draws = FA.draw_flips_and_angles(torch.Generator().manual_seed(0), (4,), p_hflip=0.5,
                                     p_vflip=0.5, max_angle=360.0)
    bidx = torch.tensor([5, 0, 7, 2], dtype=torch.int32)
    whole = FA.fast_joint_transform(planes, bidx, draws, fmt)
    for rank in range(2):
        mesh = DataMesh(2, rank, torch.device("cpu"))
        got = FA.fast_joint_transform(planes, bidx, draws, fmt, mesh=mesh)
        assert torch.equal(got, whole[mesh.shard(4)])
    with pytest.raises(ValueError, match="divisible"):
        FA.fast_joint_transform(planes, bidx[:3], tuple(d[:3] for d in draws), fmt,
                                mesh=DataMesh(2, 0, torch.device("cpu")))

    three = DataMesh(3, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="divide evenly over the 3 ranks"):
        Engine(model(), cfg, device="cpu", mesh=three)
    run_cfg = Config(data=DataConfig(batch_size=4))
    with caplog.at_level(logging.WARNING):
        assert driver._fast_augmentation(run_cfg, three) is False
    assert "fast_augmentation disabled for this run" in caplog.text
    assert driver._fast_augmentation(run_cfg, DataMesh(2, 0, torch.device("cpu"))) is True


def test_one_rank_has_no_mesh_and_spatial_partitions_raise(tmp_path):
    """As JAX returns no mesh for one device, one rank gets ``None``; a
    ``space`` axis of 2 does not divide one rank and raises ``ValueError``,
    as JAX's ``data_space_mesh`` does, in the driver too (which runs
    ``data_parallel`` over one rank as one process), for the flagship and
    for SwinUNETR alike (every architecture has row rules); neither writes
    anything. The mesh spans every rank."""
    from multi_task_breast_cancer_tpu_torch.config import Config, ModelConfig, TrainingConfig
    from multi_task_breast_cancer_tpu_torch.train import driver

    assert data_mesh() is None and data_mesh(1) is None
    assert data_space_mesh(1) is None
    with pytest.raises(ValueError, match="spatial_partitions=2 must divide the device count"):
        data_space_mesh(2)
    cfg = Config(training=TrainingConfig(spatial_partitions=2))
    with pytest.raises(ValueError, match="spatial_partitions=2"):
        driver.run_experiment(cfg, "multitask", run_root=str(tmp_path), device="cpu")
    cfg = Config(model=ModelConfig(architecture="SwinUNETR"),
                 training=TrainingConfig(spatial_partitions=2))
    with pytest.raises(ValueError, match="spatial_partitions=2"):
        driver.run_experiment(cfg, "segmentation", run_root=str(tmp_path), device="cpu")
    assert not any(tmp_path.iterdir())
    with pytest.raises(NotImplementedError, match="not a data mesh"):
        Engine(registry.init_segmentation_model("BTSUNet", width=4, size=32),
               EngineConfig(task="segmentation"), device="cpu", mesh=object())
    shards = [DataMesh(4, r, "cpu").shard(10) for r in range(4)]
    assert shards == [slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10)]
