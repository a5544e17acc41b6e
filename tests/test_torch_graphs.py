"""The port's captured programs (``graphs.py``) and what they ask of the
Engine, the optimizers and the checkpoints.

On the CPU (no CUDA graph here) the Engine's graphed path runs with a
stand-in :class:`_StandIn` in place of ``graphs.Program``: it has a
capture's data flow, so nothing runs at the capture and every replay runs
the captured step on the static buffers and writes its results into the
first replay's output tensors, as a graph replay overwrites its static
outputs. The graphed epoch must then equal the eager one bit for bit: the
epoch metrics, the per-step loss shares and Dice counts, the confusion
matrix, the parameters, Adam's moments, the batch statistics, the dropout
masks and where the dropout generator ends (one torch thread: the CPU's
sums in one order). A step that kept a static output instead of copying it
out, or a confusion matrix that was not the static one, would differ.

Also: the launch counters through a stand-in capture (unchanged by the
capture, the captured growth added per replay) and the registry holding
every counted entry point of ``ops/``; a tensor learning rate changed
between steps against optax (Adam, AdamW, the port's SGD; 1e-6 absolute,
as ``tests/test_torch_optim.py``); the checkpoint of the card's optimizer
form writing today's bytes; and the one rule (graphed on CUDA without a
mesh or under a data mesh whose forward calls no collective). The ``cuda`` tests hold a graphed step and a graphed serving
bucket against eager ones on the card, and with cuDNN timing its engines
(the port's policy) show that a capture and its replays search no
convolution problem (skipped here; on the card run ``-m cuda
--noconftest``: this module imports nothing of the JAX package at its
top).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import pkgutil

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch import graphs
from multi_task_breast_cancer_tpu_torch import ops as ops_package
from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.nnunet import NNUNET_WIDTHS
from multi_task_breast_cancer_tpu_torch.ops import fast_augment as FA
from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
from multi_task_breast_cancer_tpu_torch.ops import launches
from multi_task_breast_cancer_tpu_torch.parallel.mesh import DataMesh
from multi_task_breast_cancer_tpu_torch.train import checkpoint as C
from multi_task_breast_cancer_tpu_torch.train import loop
from multi_task_breast_cancer_tpu_torch.train import optim as O
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from multi_task_breast_cancer_tpu_torch.utils import profiling

WIDTHS = (4, 8, 8, 16, 16)
SIZE = 64
B = 2
OPTAX_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (as ``tests/test_torch_driver.py``): the gate's
    six workers share eight cores, and one thread fixes the CPU's order of
    summation."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fold(n: int, seed: int, size: int = SIZE) -> ArrayDataset:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    labels = (np.arange(n) % 3).astype(np.int32)
    masks = np.zeros((n, size, size, 1), np.float32)
    for i in np.flatnonzero(labels != 2):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        r = rng.integers(size // 10, size // 5)
        masks[i, ..., 0] = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    images = np.clip(rng.normal(90, 30, masks.shape) + 80 * masks, 0, 255).round()
    return ArrayDataset(images=images.astype(np.float32), masks=masks, labels=labels,
                        patient_ids=np.arange(n), class_names=["benign"] * n,
                        tumor_pixels=masks.sum(axis=(1, 2, 3)).astype(np.int64))


# ---------------------------------------------------------------------------
# the Engine's graphed path, with a stand-in capture
# ---------------------------------------------------------------------------


class _NoStream:
    def wait_stream(self, other) -> None:
        pass


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _leaves(t)]
    return [] if tree is None else [tree]


class _StandIn:
    """``graphs.Program`` on the CPU with a capture's data flow (module
    docstring). The backward of a step captured with no ``.grad`` writes
    the gradients afresh at every replay, where a Python rerun would add to
    them: the stand-in drops the ``.grad`` of ``params`` before each rerun of
    a program that runs the backward. That is the first program captured
    into a memory pool, or one with a pool of its own: the Engine's whole
    step, or its part before the gradient all-reduce; the part after it,
    captured second into the same pool, reads those gradients."""

    made: list = []
    params: list = []
    pools: list = []

    def __init__(self, fn, inputs, device, *, stream=None, pool=None, generator=None):
        self.fn, self.inputs, self.generator = fn, list(inputs), generator
        self.outputs, self.replays, self.closed = None, 0, False
        self.backward = pool is None or not any(p is pool for p in _StandIn.pools)
        if pool is not None:
            _StandIn.pools.append(pool)
        _StandIn.made.append(self)

    def replay(self, *sources, generator=None):
        for static, source in zip(self.inputs, sources):
            if source is not None:
                static.copy_(source)
        if generator is not None:
            self.generator.set_state(generator.get_state())
        if self.backward:
            for p in _StandIn.params:
                p.grad = None
        out = self.fn(*self.inputs)
        if generator is not None:
            generator.set_state(self.generator.get_state())
        if self.outputs is None:
            self.outputs = out
        else:
            for static, new in zip(_leaves(self.outputs), _leaves(out)):
                static.copy_(new)
        self.replays += 1
        return self.outputs

    def close(self) -> None:
        self.closed = True


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(graphs, "Program", _StandIn)
    monkeypatch.setattr(graphs, "new_pool", object)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _NoStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _NoStream())
    _StandIn.made.clear()
    return _StandIn


CASES = {
    "MTnnUNet, fast augmentation": ("multitask", "MTnnUNet", True),
    "MTnnUNet, exact augmentation": ("multitask", "MTnnUNet", False),
    "ResidualUNet, dropout and batch statistics": ("segmentation", "ResidualUNet", True),
}


def _engine(case: str, graphed: bool):
    task, arch, fast = CASES[case]
    gen = torch.Generator().manual_seed(3)
    if task == "multitask":
        model = registry.init_multitask_model(arch, nnunet_widths=WIDTHS, generator=gen)
    else:
        model = registry.init_segmentation_model(arch, width=4, size=SIZE, generator=gen)
    engine = Engine(model, EngineConfig(task=task, batch_size=B, fast_augmentation=fast),
                    device="cpu")
    engine.graphed = graphed  # the card's path, on the stand-in capture
    return engine


def _run(case: str, graphed: bool) -> dict:
    """Two epochs: 3 real steps around a padding step, the learning rate
    halved, 3 more real steps; every step's shares and counts recorded."""
    engine = _engine(case, graphed)
    state = create_train_state(engine.model, "Adam", 1e-3)
    _StandIn.params = list(engine.model.parameters())
    data = engine.device_data(_fold(8, 5))
    per_step = []
    real_sums = engine._epoch_sums

    def record(sums, shares, counts):
        per_step.append(([s.clone() for s in shares], [c.clone() for c in counts]))
        return real_sums(sums, shares, counts)

    engine._epoch_sums = record
    drop = torch.Generator().manual_seed(11)
    metrics = []
    rng = np.random.default_rng(1)
    for epoch, valid in enumerate((np.array([1, 0, 1, 1], np.float32), None)):
        perm = rng.permutation(8)[:(4 if valid is not None else 3) * B]
        metrics.append(engine.train_epoch(state, data, perm, torch.Generator().manual_seed(epoch),
                                          step_valid=valid, dropout_generator=drop)[1])
        O.set_learning_rate(state.optimizer, 5e-4)
    moments = [{k: v.clone() for k, v in state.optimizer.state[p].items()}
               for p in state.model.parameters()]
    return {"engine": engine, "state": state, "data": data, "metrics": metrics,
            "per_step": per_step, "moments": moments, "drop": drop.get_state(),
            "weights": {k: v.clone() for k, v in state.model.state_dict().items()}}


@pytest.mark.parametrize("case", list(CASES))
def test_step_body_on_static_buffers_is_the_eager_epoch(stand_in, case):
    eager, graphed = _run(case, False), _run(case, True)
    # one capture (after the first real step's eager warm-up), replayed for
    # the other 2 + 3 real steps, never for the padding step
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 5
    assert graphed["metrics"] == eager["metrics"]
    for (shares_e, counts_e), (shares_g, counts_g) in zip(eager["per_step"], graphed["per_step"]):
        assert len(shares_e) == len(shares_g) == 3
        assert all(torch.equal(a, b) for a, b in zip(shares_e, shares_g))
        assert all(torch.equal(a, b) for a, b in zip(counts_e, counts_g))
    # the steps' values differ, so an aliased output could not pass
    shares = graphed["per_step"][1][0]
    assert not torch.equal(shares[0], shares[1]) and not torch.equal(shares[1], shares[2])
    for k, v in eager["weights"].items():
        assert torch.equal(v, graphed["weights"][k]), k
    for a, b in zip(eager["moments"], graphed["moments"]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(eager["drop"], graphed["drop"])
    assert graphed["state"].step == eager["state"].step == 6


def test_graphed_padding_is_a_no_op_and_a_new_fold_captures_anew(stand_in):
    run = _run("ResidualUNet, dropout and batch statistics", True)
    engine, state, data = run["engine"], run["state"], run["data"]
    (program,) = stand_in.made
    replays = program.replays
    engine.train_epoch(state, data, np.arange(2 * B), torch.Generator().manual_seed(4),
                       step_valid=np.zeros(2, np.float32),
                       dropout_generator=torch.Generator().manual_seed(5))
    assert program.replays == replays and state.step == 6
    for k, v in run["weights"].items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    # a new optimizer over the same model (the driver's next fold): the old
    # program is released, the first real step runs eagerly, the next captures
    fresh = create_train_state(engine.model, "Adam", 1e-3)
    engine.train_epoch(fresh, data, np.arange(3 * B), torch.Generator().manual_seed(6),
                       dropout_generator=torch.Generator().manual_seed(7))
    assert program.closed and len(stand_in.made) == 2 and stand_in.made[1].replays == 2


# ---------------------------------------------------------------------------
# the launch counters
# ---------------------------------------------------------------------------


def test_every_counted_entry_point_of_ops_is_in_the_registry():
    counted = set()
    for info in pkgutil.iter_modules(ops_package.__path__):
        module = importlib.import_module(f"{ops_package.__name__}.{info.name}")
        counted |= {obj for obj in vars(module).values()
                    if callable(obj) and hasattr(obj, "launches")}
    assert counted == set(launches.REGISTRY) and len(counted) == 7
    assert {hk.instance_norm_leaky_relu, hk.instance_norm_leaky_relu_backward,
            FA.fast_augment, hk.instance_norm_split_sums} <= counted


def test_a_capture_leaves_the_counters_and_each_replay_adds_its_launches(monkeypatch):
    """``graphs.Program`` over a stand-in CUDA graph: the function runs once
    at the capture, as a capture calls every wrapper, and the counters it
    moved come back; each replay adds the capture's growth."""
    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _NoStream())

    def step(x):  # what one captured training step calls
        hk.instance_norm_leaky_relu.launches += 25
        hk.instance_norm_leaky_relu_backward.launches += 25
        FA.fast_augment.launches += 1
        return x * 2

    before = launches.snapshot()
    program = graphs.Program(step, [torch.ones(3)], "cuda", stream=_NoStream())
    assert launches.snapshot() == before
    assert program.launches == {hk.instance_norm_leaky_relu: 25,
                                hk.instance_norm_leaky_relu_backward: 25, FA.fast_augment: 1}
    for k in (1, 2, 3):
        out = program.replay(torch.full((3,), float(k)))
        assert FakeGraph.replays == k and out is program.outputs
        assert hk.instance_norm_leaky_relu.launches == before[hk.instance_norm_leaky_relu] + 25 * k
        assert FA.fast_augment.launches == before[FA.fast_augment] + k
        assert hk.instance_norm_split_sums.launches == before[hk.instance_norm_split_sums]
    assert torch.equal(program.inputs[0], torch.full((3,), 3.0))
    launches.restore(before)


# ---------------------------------------------------------------------------
# the optimizers' tensor learning rate, and checkpoints of it
# ---------------------------------------------------------------------------


def _card_form(opt: torch.optim.Optimizer) -> torch.optim.Optimizer:
    """The graph-safe form (``optim.device_hyperparameters``) on the CPU: a
    0-d f32 tensor rate, the float beside it, ``capturable`` set (a CPU
    optimizer cannot run capturable: only the stored flag is the card's)."""
    for group in opt.param_groups:
        group["host_lr"] = float(group["lr"])
        group["lr"] = torch.tensor(group["host_lr"], dtype=torch.float32)
    return opt


@pytest.mark.parametrize("name,lr", [("Adam", 1e-3), ("AdamW", 1e-3), ("SGD", 1e-2)])
def test_tensor_learning_rate_changed_between_steps_matches_optax(name, lr):
    import jax.numpy as jnp
    import optax

    from multi_task_breast_cancer_tpu.train import optim as JO

    rng = np.random.default_rng(2)
    p0 = {"w": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-5, 1)).astype(np.float32)
              for k, v in p0.items()} for _ in range(6)]
    rates = [lr, lr, lr / 2, lr / 2, lr / 10, lr / 10]

    tx = JO.init_optimizer(name, lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for rate, g in zip(rates, grads):
        state = JO.set_learning_rate(state, rate)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    params = list(tp.values())
    opt = _card_form({"Adam": lambda: torch.optim.Adam(params, lr=lr, eps=1e-4),
                      "AdamW": lambda: torch.optim.AdamW(params, lr=lr, weight_decay=0.01,
                                                         eps=1e-8),
                      "SGD": lambda: O.DeviceLrSGD(params, lr=lr, momentum=0.9)}[name]())
    rate_tensor = opt.param_groups[0]["lr"]
    for rate, g in zip(rates, grads):
        O.set_learning_rate(opt, rate)
        assert opt.param_groups[0]["lr"] is rate_tensor  # filled in place
        assert O.get_learning_rate(opt) == rate and float(rate_tensor) == np.float32(rate)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=OPTAX_TOL)


def test_set_learning_rate_changes_the_next_step_of_the_port_sgd():
    def one_step(lr_after):
        p = torch.nn.Parameter(torch.ones(3))
        opt = _card_form(O.DeviceLrSGD([p], lr=0.1, momentum=0.9))
        p.grad = torch.ones(3)
        opt.step()
        O.set_learning_rate(opt, lr_after)
        p.grad = torch.ones(3)
        opt.step()
        return p.detach().clone()

    # first step: buffer 1, update 1 + 0.9 = 1.9; second: buffer 1.9, update 2.71
    torch.testing.assert_close(one_step(0.1), torch.full((3,), 1 - 0.19 - 0.271))
    torch.testing.assert_close(one_step(0.01), torch.full((3,), 1 - 0.19 - 0.0271))


def test_checkpoint_of_the_card_form_writes_todays_bytes(tmp_path):
    """Adam with a tensor rate, ``capturable`` set and its step a tensor
    writes the bytes the plain Adam writes (the float rate, ``capturable``
    off), from the state and from a snapshot; a CPU restore is plain."""
    def trained():
        engine = Engine(registry.init_multitask_model(
            "MTnnUNet", nnunet_widths=WIDTHS, generator=torch.Generator().manual_seed(0)),
            EngineConfig(task="multitask", use_transforms=False), device="cpu")
        state = create_train_state(engine.model, "Adam", 1e-3)
        engine.train_epoch(state, engine.device_data(_fold(2, 3, 32)), np.array([0, 1]))
        return engine, state

    def written(name, what):
        path = str(tmp_path / name)
        C.save_checkpoint(path, what, epoch=1, val_loss=0.5, resume_state={"patience": 1.0})
        with open(path, "rb") as f:
            return f.read()

    _, plain = trained()
    today = written("plain", plain)
    engine, card = trained()
    _card_form(card.optimizer)
    for group in card.optimizer.param_groups:
        group["capturable"] = True
    assert all(torch.is_tensor(s["step"]) for s in card.optimizer.state.values())
    assert written("card", card) == today
    assert written("snapshot", C.snapshot(card)) == today
    restored, *_ = C.restore_checkpoint(create_train_state(engine.model, "Adam", 1e-3),
                                        str(tmp_path / "card"))
    group = restored.optimizer.param_groups[0]
    assert group["lr"] == 1e-3 and group["capturable"] is False and "host_lr" not in group


# ---------------------------------------------------------------------------
# the one rule
# ---------------------------------------------------------------------------


def test_graphed_only_on_cuda_without_a_mesh(monkeypatch):
    """The one rule: graphed on CUDA without a mesh, and under a data mesh
    without ``space`` for a model whose forward calls no collective; eager on
    the CPU, under a ``space`` group, and for a model with ``BatchNorm``
    under a data mesh (the name predates the data-mesh case)."""
    cuda = torch.device("cuda", 0)
    assert graphs.enabled("cuda") and graphs.enabled(cuda)
    assert not graphs.enabled("cpu")
    data_mesh = DataMesh(world_size=2, rank=0, device=cuda)
    space_mesh = DataMesh(world_size=2, rank=0, device=cuda, space=object(),
                          data_axis=DataMesh(world_size=1, rank=0, device=cuda))
    nnunet = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    residual = registry.init_segmentation_model("ResidualUNet", width=4, size=32)
    assert graphs.enabled(cuda, data_mesh, nnunet)
    assert not graphs.enabled(cuda, data_mesh, residual)
    assert not graphs.enabled(cuda, space_mesh, nnunet)
    assert not graphs.enabled("cpu", data_mesh, nnunet)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        graphs.Program(lambda: None, [], "cpu")

    assert Engine(nnunet, EngineConfig(task="multitask"), device="cpu").graphed is False

    class _Stub(torch.nn.Linear):
        def to(self, *args, **kwargs):  # stays on the CPU
            return self

    monkeypatch.setattr(loop, "resolve_device", lambda device: cuda)
    cfg = EngineConfig(task="segmentation")
    assert Engine(_Stub(1, 1), cfg).graphed is True
    assert Engine(_Stub(1, 1), cfg, cuda_graphs=False).graphed is False
    one_rank = DataMesh(world_size=1, rank=0, device=cuda)
    assert Engine(_Stub(1, 1), cfg, mesh=one_rank).graphed is True
    assert Engine(_Stub(1, 1), cfg, mesh=one_rank, cuda_graphs=False).graphed is False


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")


def _counts():
    return (hk.instance_norm_leaky_relu.launches, hk.instance_norm_leaky_relu_backward.launches,
            FA.fast_augment.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_graphed_step_is_the_eager_step(dtype):
    """Two epochs (a padding step, an lr change between them) of a graphed
    and an eager Engine from the same weights and draws: metrics, weights,
    Adam's state and the kernels' launch counts equal. cuDNN deterministic:
    without it two eager runs may differ already (as ``chip_smoke.py``
    phase 7f)."""
    _cuda_or_skip()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = _cuda_step_runs(dtype)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m_e, c_e, w_e, s_e), (m_g, c_g, w_g, s_g) = runs[False], runs[True]
    assert m_e == m_g, (m_e, m_g)
    assert c_e == c_g == (25 * 6, 25 * 6, 6), (c_e, c_g)
    assert all(torch.equal(w_e[k], w_g[k]) for k in w_e)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(s_e, s_g) for k in a)


def _cuda_step_runs(dtype: str, widths=WIDTHS, size: int = SIZE,
                    order=(False, True)) -> dict:
    runs = {}
    for graphed in order:
        model = registry.init_multitask_model("MTnnUNet", nnunet_widths=widths, size=size,
                                              generator=torch.Generator().manual_seed(3))
        engine = Engine(model, EngineConfig(task="multitask", batch_size=B,
                                            fast_augmentation=True, compute_dtype=dtype),
                        device="cuda", cuda_graphs=graphed)
        assert engine.graphed is graphed
        state = create_train_state(engine.model, "Adam", 1e-3)
        data = engine.device_data(_fold(8, 5, size))
        before = _counts()
        metrics = []
        for epoch, valid in enumerate((np.array([1, 0, 1, 1], np.float32), None)):
            perm = np.random.default_rng(epoch).permutation(8)[:(4 if valid is not None else 3) * B]
            metrics.append(engine.train_epoch(state, data, perm,
                                              torch.Generator().manual_seed(epoch),
                                              step_valid=valid)[1])
            O.set_learning_rate(state.optimizer, 5e-4)
        runs[graphed] = (metrics, tuple(a - b for a, b in zip(_counts(), before)),
                         {k: v.cpu() for k, v in state.model.state_dict().items()},
                         [{k: v.cpu() for k, v in state.optimizer.state[p].items()}
                          for p in state.model.parameters()])
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_graphed_bucket_is_the_eager_forward(dtype):
    """``CheckpointBackend`` graphed and eager: the same answers bit for
    bit, 25 forward norm launches per bucket execution, and a weight swap
    taking effect in the graph (cuDNN deterministic, as above)."""
    _cuda_or_skip()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _cuda_bucket_check(dtype)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _cuda_bucket_check(dtype: str) -> None:
    from multi_task_breast_cancer_tpu_torch.config import Config, ModelConfig
    from multi_task_breast_cancer_tpu_torch.serve.server import CheckpointBackend

    cfg = Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=list(WIDTHS)))
    cfg.training.compute_dtype = dtype
    images = np.random.default_rng(0).integers(0, 256, (5, SIZE, SIZE, 1)).astype(np.uint8)
    backends = [CheckpointBackend(cfg, "multitask", size=SIZE, max_batch=8, device="cuda",
                                  cuda_graphs=g) for g in (False, True)]
    eager, graphed = backends
    assert graphed.graphed and not eager.graphed
    before = hk.instance_norm_leaky_relu.launches
    got = graphed.predict(images)
    assert hk.instance_norm_leaky_relu.launches - before == 25
    want = eager.predict(images)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))
    other = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                          generator=torch.Generator().manual_seed(9))
    for backend in backends:
        backend.load_weights(other.state_dict())
    swapped, want = graphed.predict(images), eager.predict(images)
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(swapped), _leaves(want)))
    assert not all(np.array_equal(a, b) for a, b in zip(_leaves(swapped), _leaves(got)))


def _measured() -> int:
    return profiling.counters().get("conv.problems_measured", 0)


class _CountedCaptures(graphs.Program):
    """A ``graphs.Program`` that keeps ``conv.problems_measured`` before and
    after each capture (class-wide, in order)."""
    measured: list = []

    def __init__(self, *args, **kwargs):
        type(self).measured.append(_measured())
        super().__init__(*args, **kwargs)
        type(self).measured.append(_measured())


def _in_a_fresh_thread(fn):
    """``fn()`` in a thread of its own, its result or its exception: PyTorch
    keeps cuDNN's chosen engines per thread, so the thread starts with none
    and every problem it runs is searched there."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        return pool.submit(fn).result()


@pytest.mark.cuda
def test_cuda_timed_engines_graphed_epoch_is_the_eager_epoch(monkeypatch):
    """cuDNN timing its engines (the Engine's policy) with deterministic
    set, MTnnUNet at the paper's widths, 128², batch 2: the graphed Engine's
    eager warm-up step measures the step's problems, its capture and every
    replay measure none, and its epochs equal an eager Engine's bit for bit
    (the eager Engine runs after it in the same thread: the same engines)."""
    _cuda_or_skip()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(graphs, "Program", _CountedCaptures)
    monkeypatch.setattr(_CountedCaptures, "measured", [])

    def runs():
        start = _measured()
        graphed = _cuda_step_runs("float32", NNUNET_WIDTHS, 128, order=(True,))
        after_graphed = _measured()
        eager = _cuda_step_runs("float32", NNUNET_WIDTHS, 128, order=(False,))
        return start, after_graphed, _measured(), {**graphed, **eager}

    start, after_graphed, end, runs = _in_a_fresh_thread(runs)
    assert torch.backends.cudnn.benchmark is True
    assert torch.backends.cudnn.allow_tf32 is False
    captured = _CountedCaptures.measured
    assert len(captured) == 2, captured  # one capture: the graphed Engine's step
    assert captured[0] - start > 0  # the warm-up step searched
    assert captured[0] == captured[1] == after_graphed == end  # capture, replays, eager run
    (m_e, c_e, w_e, s_e), (m_g, c_g, w_g, s_g) = runs[False], runs[True]
    assert m_e == m_g, (m_e, m_g)
    assert c_e == c_g == (25 * 6, 25 * 6, 6), (c_e, c_g)
    assert all(torch.equal(w_e[k], w_g[k]) for k in w_e)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(s_e, s_g) for k in a)


@pytest.mark.cuda
def test_cuda_timed_engines_serving_bucket_searches_before_its_capture(monkeypatch):
    """One serving bucket (``CheckpointBackend``, the paper's widths, 128²,
    max batch 4): its eager warm-up measures the forward's problems, its
    capture and the replays of every request measure none, and its answers
    equal an eager backend's bit for bit (deterministic set)."""
    _cuda_or_skip()
    from multi_task_breast_cancer_tpu_torch.config import Config, ModelConfig
    from multi_task_breast_cancer_tpu_torch.serve.server import CheckpointBackend

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(graphs, "Program", _CountedCaptures)
    monkeypatch.setattr(_CountedCaptures, "measured", [])
    cfg = Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=list(NNUNET_WIDTHS)))
    images = np.random.default_rng(0).integers(0, 256, (7, 128, 128, 1)).astype(np.uint8)

    def serve():
        start = _measured()
        graphed = CheckpointBackend(cfg, "multitask", size=128, max_batch=4, device="cuda")
        assert graphed.graphed and graphed.buckets == [4]
        built = _measured()
        got = graphed.predict(images)  # two replays: 4 rows, then 3 padded to 4
        replayed = _measured()
        eager = CheckpointBackend(cfg, "multitask", size=128, max_batch=4, device="cuda",
                                  cuda_graphs=False)
        return start, built, replayed, _measured(), got, eager.predict(images)

    start, built, replayed, end, got, want = _in_a_fresh_thread(serve)
    captured = _CountedCaptures.measured
    assert len(captured) == 2, captured
    assert captured[0] - start > 0  # the bucket's warm-up searched
    assert captured[0] == captured[1] == built == replayed == end
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(got), _leaves(want)))
