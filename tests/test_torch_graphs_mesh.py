"""The data-parallel training step graphed: under a data mesh the Engine
captures its step as two programs around the gradient all-reduce
(``train/loop.py``; ``graphs.enabled``, the one rule).

On the CPU the ranks run as processes over Gloo
(``test_torch_parallel.run_ranks``, one torch thread each). In the graphed
runs the rule is asked for ``cuda`` (:func:`graphed_on_cpu`), so that a CPU
mesh takes the graphed path, and ``test_torch_graphs._StandIn`` stands in
for ``graphs.Program``: a replay reruns its part of the step on the static
buffers and overwrites the first replay's outputs, and the all-reduce runs
eagerly between the two parts' replays. The kernels' plain twins count a
launch where the kernel would launch (:func:`counting_twins`: a non-empty
batch). Every rank runs an eager and a graphed Engine from the same seeded
state. Held:

- graphed == eager bit for bit on every rank: each step's loss shares and
  Dice counts, each step's all-reduced gradient as the optimizer reads it,
  the epoch metrics, the parameters, Adam's moments and step, the launches;
  two programs a rank, replayed at every real step after the first (the
  warm-up), never at a padding step; a rank with an empty shard replays
  them on zero rows and launches nothing; a new optimizer captures anew;
- the graphed ranks against one process (``test_torch_parallel``'s 2e-4)
  and the BTSUNet epoch against the JAX Engine on a 2-device data mesh
  (1e-4 relative + 1e-6, as there); parameters bit-identical across ranks;
- the rule's cases; and a ``cuda`` test of the split step on one card (a
  one-rank NCCL ``DataMesh``: graphed == eager == no mesh, bit for bit),
  skipped here (on the card: ``-m cuda --noconftest``; this module imports
  nothing of the JAX package at its top).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch import graphs
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
from multi_task_breast_cancer_tpu_torch.parallel import multihost
from multi_task_breast_cancer_tpu_torch.parallel.mesh import DataMesh, replicate_to_mesh
from multi_task_breast_cancer_tpu_torch.parallel.spatial import Space
from multi_task_breast_cancer_tpu_torch.train import loop
from multi_task_breast_cancer_tpu_torch.train import optim as O
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig, plan_epoch_indices
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from test_torch_graphs import WIDTHS, _fold, _NoStream, _StandIn
from test_torch_parallel import JAX_ATOL, JAX_RTOL, RTOL, _close, _same_state, run_ranks

SIZE = 32
# fused-norm sites: #1 and #2 launch this many times per real step on a rank
# with rows, #3 once with the fast augmentation
NORM_SITES = {"MTnnUNet": 25, "BTSUNet": 17, "Multi_BTSUNet": 19}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as ``tests/test_torch_graphs.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the graphed path on the CPU
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def graphed_on_cpu():
    """The rule asked for ``cuda`` (so a CPU data mesh is graphed by its
    mesh and model cases), ``_StandIn`` for ``graphs.Program``, and the
    streams of the warm-up and the capture as no-ops."""
    rule = graphs.enabled
    saved = [(graphs, "Program"), (graphs, "new_pool"), (graphs, "enabled"),
             (torch.cuda, "stream"), (torch.cuda, "current_stream"), (torch.cuda, "Stream")]
    saved = [(owner, name, getattr(owner, name)) for owner, name in saved]
    graphs.Program, graphs.new_pool = _StandIn, object
    graphs.enabled = lambda device, mesh=None, model=None: rule("cuda", mesh, model)
    torch.cuda.stream = lambda stream: contextlib.nullcontext()
    torch.cuda.current_stream = lambda device=None: _NoStream()
    torch.cuda.Stream = lambda device=None: _NoStream()
    _StandIn.made.clear()
    try:
        yield
    finally:
        for owner, name, value in saved:
            setattr(owner, name, value)


@contextlib.contextmanager
def counting_twins():
    """Each plain twin counts one launch of its kernel where the kernel
    would launch: on a non-empty batch."""
    twins = [(hk, "instance_norm_leaky_relu_reference", hk.instance_norm_leaky_relu),
             (hk, "instance_norm_leaky_relu_backward_reference",
              hk.instance_norm_leaky_relu_backward),
             (FA, "fast_augment_reference", FA.fast_augment)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in twins]

    def counting(twin, counter):
        def call(x, *args, **kwargs):
            if (args[0] if counter is FA.fast_augment else x).numel():
                counter.launches += 1
            return twin(x, *args, **kwargs)
        return call

    for (module, name, counter), (_, _, twin) in zip(twins, saved):
        setattr(module, name, counting(twin, counter))
    try:
        yield
    finally:
        for module, name, twin in saved:
            setattr(module, name, twin)


def _counts() -> tuple:
    return (hk.instance_norm_leaky_relu.launches, hk.instance_norm_leaky_relu_backward.launches,
            FA.fast_augment.launches)


def _run(model, cfg: EngineConfig, mesh, train, epochs, graphed: bool,
         new_fold: bool = False) -> dict:
    """``epochs`` (each ``(perm, step_valid)``; the learning rate halved
    after each) of an eager or a graphed Engine from ``model``'s weights, as
    this rank of ``mesh`` or one process; then an epoch of padding steps and,
    with ``new_fold``, an epoch of a fresh optimizer. Per step: the loss
    shares, Dice counts and the gradient the optimizer reads; the metrics,
    state, moments, launches and, graphed, the programs' replays."""
    with graphed_on_cpu() if graphed else contextlib.nullcontext():
        engine = Engine(copy.deepcopy(model), cfg, device="cpu", mesh=mesh)
        assert engine.graphed is graphed
        state = replicate_to_mesh(mesh, create_train_state(engine.model, "Adam", 1e-3))
        params = list(engine.model.parameters())
        _StandIn.params = params
        per_step, grads, epoch_sums = [], [], engine._epoch_sums

        def record_sums(sums, shares, counts):
            per_step.append(([s.clone() for s in shares], [c.clone() for c in counts]))
            return epoch_sums(sums, shares, counts)

        def record_grads(step):
            def recorded(*args, **kwargs):
                grads.append([None if p.grad is None else p.grad.clone() for p in params])
                return step(*args, **kwargs)
            return recorded

        engine._epoch_sums = record_sums
        state.optimizer.step = record_grads(state.optimizer.step)
        data = engine.device_data(train)
        before, metrics = _counts(), []
        for e, (perm, valid) in enumerate(epochs):
            metrics.append(engine.train_epoch(state, data, perm, torch.Generator().manual_seed(e),
                                              step_valid=valid)[1])
            O.set_learning_rate(state.optimizer, 1e-3 / 2 ** (e + 1))
        launches = tuple(a - b for a, b in zip(_counts(), before))
        made = _StandIn.made if graphed else []
        replays = [p.replays for p in made]
        weights = {k: v.clone() for k, v in state.model.state_dict().items()}
        moments = [{k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in state.optimizer.state[p].items()} for p in params]
        b = cfg.batch_size
        engine.train_epoch(state, data, epochs[0][0][:2 * b], torch.Generator().manual_seed(9),
                           step_valid=np.zeros(2, np.float32))
        padding_noop = (all(torch.equal(v, state.model.state_dict()[k]) for k, v in weights.items())
                        and [p.replays for p in made] == replays
                        and tuple(a - b for a, b in zip(_counts(), before)) == launches)
        out = {"metrics": metrics, "per_step": per_step[:len(epochs)], "grads": list(grads),
               "state": weights,
               "moments": moments, "launches": launches, "replays": replays,
               "padding_noop": padding_noop, "step": state.step}
        if new_fold:
            made = list(_StandIn.made)
            fresh = create_train_state(engine.model, "Adam", 1e-3)
            engine.train_epoch(fresh, data, epochs[0][0][:2 * b],
                               torch.Generator().manual_seed(8))
            out["new_fold"] = {"closed": [p.closed for p in made],
                               "replays": [p.replays for p in _StandIn.made[len(made):]]}
        return out


def case_graphed_and_eager(mesh, runs: dict) -> dict:
    """On this rank: each run of ``runs`` (name -> ``_run``'s arguments)
    eager, then graphed, from rank 0's weights (other ranks perturb theirs
    first, which ``replicate_to_mesh`` undoes)."""
    out = {}
    with counting_twins():
        for name, spec in runs.items():
            model = spec["model"]
            if mesh.rank:
                with torch.no_grad():
                    gen = torch.Generator().manual_seed(100 + mesh.rank)
                    for p in model.parameters():
                        p.add_(torch.randn(p.shape, generator=gen))
            for graphed in (False, True):
                out[name, graphed] = _run(model, spec["cfg"], mesh, spec["train"], spec["epochs"],
                                          graphed, spec.get("new_fold", False) and graphed)
    return out


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


def _mtnnunet():
    return registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                         generator=torch.Generator().manual_seed(3))


def _btsunet():
    return registry.init_segmentation_model("BTSUNet", width=4, size=SIZE,
                                            generator=torch.Generator().manual_seed(7))


def _epochs(n: int, b: int, seed: int) -> list:
    """Two epochs over a fold of ``n``: 4 steps with the second a padding
    step, then 3 real steps (5 replays after the warm-up)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, n, 4 * b), np.array([1, 0, 1, 1], np.float32)),
            (rng.integers(0, n, 3 * b), None)]


def _btsunet_run() -> dict:
    """``test_torch_parallel``'s BTSUNet epoch against JAX (lesion blobs at
    32², no augmentation) at batch 4: 4 steps, 3 replays."""
    from test_torch_engine import _fold as lesion_fold
    train = lesion_fold(16, 3, size=SIZE)
    perm = plan_epoch_indices(len(train), 4, np.random.default_rng(42))
    return {"model": _btsunet(), "train": train, "epochs": [(perm, None)],
            "cfg": EngineConfig(task="segmentation", n_classes=3, batch_size=4,
                                use_transforms=False)}


def _specs(world: int) -> dict:
    if world == 2:
        return {"MTnnUNet": {"model": _mtnnunet(), "train": _fold(8, 5, SIZE), "new_fold": True,
                             "epochs": _epochs(8, 4, 1),
                             "cfg": EngineConfig(task="multitask", batch_size=4,
                                                 fast_augmentation=True)},
                "BTSUNet": _btsunet_run()}
    # test_torch_parallel's uneven batch: Multi_BTSUNet, batch 2 over 3 ranks
    # (rows 1, 1, 0), the exact augmentation, one epoch of 6 steps
    from test_torch_engine import _fold as lesion_fold
    model = registry.init_multitask_model("Multi_BTSUNet", width=4, size=SIZE,
                                          generator=torch.Generator().manual_seed(3))
    return {"Multi_BTSUNet": {
        "model": model, "train": lesion_fold(12, 0, size=SIZE),
        "epochs": [(plan_epoch_indices(12, 2, np.random.default_rng(1)), None)],
        "cfg": EngineConfig(task="multitask", n_classes=3, batch_size=2, use_transforms=True)}}


def _real_steps(spec: dict) -> int:
    b = spec["cfg"].batch_size
    return sum(len(p) // b if v is None else int(v.sum()) for p, v in spec["epochs"])


def _single(spec: dict) -> dict:
    with counting_twins():
        return _run(spec["model"], spec["cfg"], None, spec["train"], spec["epochs"], False)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    specs = _specs(2)
    return specs, run_ranks(2, "test_torch_graphs_mesh", "case_graphed_and_eager",
                            tmp_path_factory.mktemp("graphs_mesh_2"), {"runs": specs})


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    specs = _specs(3)
    return specs, run_ranks(3, "test_torch_graphs_mesh", "case_graphed_and_eager",
                            tmp_path_factory.mktemp("graphs_mesh_3"), {"runs": specs})


def _bitwise(a, b) -> bool:
    """Equal trees of tensors, floats and ints, bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bitwise(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_bitwise(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _graphed_is_eager(res: dict, name: str, spec: dict, rows: bool) -> None:
    """Rank ``res``'s graphed run of ``name`` against its eager run; a rank
    with ``rows`` launches per real step as ``NORM_SITES`` and the
    augmentation say, one without none."""
    eager, graphed = res[name, False], res[name, True]
    real_steps = _real_steps(spec)
    per = (NORM_SITES[name], NORM_SITES[name], int(spec["cfg"].fast_augmentation))
    launches = tuple(real_steps * n * rows for n in per)
    for key in ("metrics", "per_step", "grads", "state", "moments", "step"):
        assert _bitwise(graphed[key], eager[key]), key
    assert len(graphed["grads"]) == real_steps
    assert graphed["launches"] == eager["launches"] == launches
    # two programs, the part before the all-reduce and the part after, each
    # replayed at every real step but the first (the eager warm-up)
    assert graphed["replays"] == [real_steps - 1] * 2
    assert graphed["padding_noop"] and eager["padding_noop"]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["MTnnUNet", "BTSUNet"])
def test_two_rank_graphed_epochs_are_the_eager_epochs(two_ranks, name):
    """Two ranks, two rows each: MTnnUNet with the fast augmentation (6
    real steps around a padding step, an lr change between its epochs) and
    BTSUNet without augmentation (4 steps)."""
    specs, ranks = two_ranks
    for res in ranks:
        _graphed_is_eager(res, name, specs[name], True)


@pytest.mark.parametrize("name", ["MTnnUNet", "BTSUNet"])
def test_two_rank_graphed_epochs_match_one_process(two_ranks, name):
    specs, ranks = two_ranks
    single = _single(specs[name])
    _same_state([r[name, True] for r in ranks])
    for res in ranks:
        for got, want in zip(res[name, True]["metrics"], single["metrics"]):
            assert not _close(got, want, RTOL)


def test_graphed_mesh_padding_replays_nothing_and_a_new_fold_captures_anew(two_ranks):
    _, ranks = two_ranks
    for res in ranks:
        fold = res["MTnnUNet", True]["new_fold"]
        # the old pair released; the fresh optimizer's first step warms up,
        # the next captures and replays a new pair
        assert fold["closed"] == [True, True] and fold["replays"] == [1, 1]


def test_two_rank_graphed_btsunet_matches_the_jax_data_mesh(two_ranks):
    """The graphed ranks' BTSUNet epoch against the JAX Engine on a
    2-device data mesh from the same weights (``tests/test_parallel.py``'s
    comparison, as ``test_torch_parallel`` holds the eager ranks)."""
    import jax
    import jax.numpy as jnp
    from flax.core import FrozenDict

    from multi_task_breast_cancer_tpu.data.dataset import ArrayDataset as JaxDataset
    from multi_task_breast_cancer_tpu.models.bts_unet import BTSUNet as JBTSUNet
    from multi_task_breast_cancer_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from multi_task_breast_cancer_tpu.train import loop as JL
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_to_jax

    specs, ranks = two_ranks
    spec = specs["BTSUNet"]
    port = spec["model"]
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict(), port))
    tx = init_optimizer("Adam", 1e-3)
    cfg = spec["cfg"]
    jengine = JL.Engine(JBTSUNet(width=4, deep_supervision=False), tx,
                        JL.EngineConfig(task="segmentation", n_classes=3,
                                        batch_size=cfg.batch_size, use_transforms=False),
                        mesh=jax_data_mesh(2))
    jstate = TrainState(params=params, batch_stats=FrozenDict(), opt_state=tx.init(params),
                        step=jnp.zeros((), jnp.int32))
    (perm, _), = spec["epochs"]
    _, jtm = jengine.train_epoch(jstate, jengine.device_data(JaxDataset(**vars(spec["train"]))),
                                 perm, jax.random.PRNGKey(1))
    for res in ranks:
        assert not _close(res["BTSUNet", True]["metrics"][0], jtm, JAX_RTOL, JAX_ATOL,
                          ("loss", "dice"))


def test_three_ranks_with_an_empty_shard_graphed_is_eager(three_ranks):
    """``test_torch_parallel``'s uneven batch graphed: batch 2 over 3 ranks
    (rows 1, 1, 0), the exact augmentation; every rank graphed == eager, the
    empty rank replaying its programs on zero rows with no launch and
    joining every all-reduce; the ranks against one process."""
    specs, ranks = three_ranks
    assert [DataMesh(3, r, "cpu").shard(2) for r in range(3)] == [
        slice(0, 1), slice(1, 2), slice(2, 2)]
    spec = specs["Multi_BTSUNet"]
    for r, res in enumerate(ranks):
        _graphed_is_eager(res, "Multi_BTSUNet", spec, r < 2)
    _same_state([r["Multi_BTSUNet", True] for r in ranks])
    single = _single(spec)
    for res in ranks:
        assert not _close(res["Multi_BTSUNet", True]["metrics"][0], single["metrics"][0], RTOL)


RULE_CASES = {  # device, mesh, architecture, graphed
    "no mesh": ("cuda", None, "MTnnUNet", True),
    "data mesh": ("cuda", "data", "MTnnUNet", True),
    "data mesh, ResidualUNet (BatchNorm)": ("cuda", "data", "ResidualUNet", False),
    "space group": ("cuda", "space", "MTnnUNet", False),
    "CPU": ("cpu", "data", "MTnnUNet", False),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_the_rule_decides_each_engine(monkeypatch, case):
    """``graphs.enabled`` and the Engine built on that device and mesh
    (the card's device stood in for: the model stays on the CPU)."""
    device, kind, arch, want = RULE_CASES[case]
    device = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = None if kind is None else DataMesh(
        2, 0, device, space=Space(2, 0, (0, 1)) if kind == "space" else None,
        data_axis=DataMesh(1, 0, device) if kind == "space" else None)
    model = (_mtnnunet() if arch == "MTnnUNet" else
             registry.init_segmentation_model(arch, width=4, size=SIZE))
    model.to = lambda *args, **kwargs: model
    monkeypatch.setattr(loop, "resolve_device", lambda d: device)
    assert graphs.enabled(device, mesh, model) is want
    cfg = EngineConfig(task="segmentation", batch_size=2)
    assert Engine(model, cfg, mesh=mesh).graphed is want
    assert Engine(model, cfg, mesh=mesh, cuda_graphs=False).graphed is False


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_split_step_on_a_one_rank_nccl_mesh_is_the_eager_step(dtype):
    """A one-rank NCCL ``DataMesh`` (built directly: ``data_mesh(1)`` is
    ``None``): the graphed Engine replays its two parts around a real NCCL
    all-reduce; it equals the eager Engine on the same mesh and the graphed
    Engine without a mesh bit for bit (metrics, weights, Adam's state,
    launches), cuDNN deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    import torch.distributed as dist
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{multihost.free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = DataMesh(1, 0, torch.device("cuda", 0))
        runs = [_cuda_run(dtype, g, m) for g, m in ((True, mesh), (False, mesh), (True, None))]
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic = deterministic
    (m_g, c_g, w_g, s_g), rest = runs[0], runs[1:]
    assert c_g == (25 * 6, 25 * 6, 6), c_g
    for m, c, w, s in rest:
        assert m == m_g and c == c_g
        assert all(torch.equal(w[k], w_g[k]) for k in w)
        assert all(torch.equal(a[k], b[k]) for a, b in zip(s, s_g) for k in a)


def _cuda_run(dtype: str, graphed: bool, mesh):
    """``tests/test_torch_graphs.py``'s two epochs (a padding step, an lr
    change) of a batch-2 MTnnUNet on the card."""
    model = _mtnnunet()
    engine = Engine(model, EngineConfig(task="multitask", batch_size=2, fast_augmentation=True,
                                        compute_dtype=dtype),
                    device="cuda", mesh=mesh, cuda_graphs=graphed)
    assert engine.graphed is graphed
    state = create_train_state(engine.model, "Adam", 1e-3)
    data = engine.device_data(_fold(8, 5))
    before = _counts()
    metrics = []
    for epoch, valid in enumerate((np.array([1, 0, 1, 1], np.float32), None)):
        perm = np.random.default_rng(epoch).permutation(8)[:(4 if valid is not None else 3) * 2]
        metrics.append(engine.train_epoch(state, data, perm, torch.Generator().manual_seed(epoch),
                                          step_valid=valid)[1])
        O.set_learning_rate(state.optimizer, 5e-4)
    return (metrics, tuple(a - b for a, b in zip(_counts(), before)),
            {k: v.cpu() for k, v in state.model.state_dict().items()},
            [{k: v.cpu() for k, v in state.optimizer.state[p].items()}
             for p in state.model.parameters()])
