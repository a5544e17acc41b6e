"""The port reads the JAX package's flax-msgpack checkpoints without flax or
msgpack (``train/flax_msgpack.py``, ``train/checkpoint.py``), and
``chip_smoke.py``'s writer of that format is flax's, byte for byte.

The JAX side writes with its own ``save_checkpoint``. Its train state is
built from the port's seeded MTnnUNet at narrow widths (the tree of
``jax_weights.params_to_jax``) with one optax Adam step taken, so no JAX ``init``
is compiled. Tolerances: the forward of the loaded weights equals JAX's to
1e-4 of the output scale (two frameworks' f32 convolutions and norm sums);
the decoded trees equal flax's exactly; a resumed Adam step equals optax's
second step to 1e-5 absolute on the weights (f32 arithmetic in another
order); the restored moments equal optax's exactly (a copy).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import chip_smoke
from multi_task_breast_cancer_tpu.models import init_multitask_model as jax_mtnnunet
from multi_task_breast_cancer_tpu.train import checkpoint as jax_ckpt
from multi_task_breast_cancer_tpu.train.optim import init_optimizer as jax_optimizer
from multi_task_breast_cancer_tpu.train.state import TrainState as JaxTrainState
from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig, ModelConfig
from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_from_jax, params_to_jax
from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
from multi_task_breast_cancer_tpu_torch.serve.server import CheckpointBackend
from multi_task_breast_cancer_tpu_torch.train import checkpoint as ckpt
from multi_task_breast_cancer_tpu_torch.train import flax_msgpack
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

WIDTHS = [4, 8, 8, 16, 16]
SIZE = 32
LR = 1e-3
RESUME = {"sched_lr": 5e-4, "sched_best": 0.25, "sched_bad": 2.0, "sched_epoch": 3.0,
          "patience": 1.0, "best_val_loss": 0.25}


def _grads(params, seed: int):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state of the port's seeded weights after one Adam step."""
    port = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                generator=torch.Generator().manual_seed(3))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict(), port))
    tx = jax_optimizer("Adam", LR)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    updates, opt_state = update(_grads(params, 1), opt_state, params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    state = JaxTrainState(params=params, batch_stats={}, opt_state=opt_state,
                          step=jnp.asarray(1, jnp.int32))
    return state, tx, update


@pytest.fixture(scope="module")
def files(jax_state, tmp_path_factory):
    """The JAX ``save_checkpoint``'s file, and a legacy one without
    ``resume_state`` (written before it existed)."""
    state = jax_state[0]
    root = tmp_path_factory.mktemp("jax_ckpt")
    current, legacy = root / "model_fold_0", root / "legacy_fold_0"
    jax_ckpt.save_checkpoint(str(current), state, epoch=4, val_loss=0.25, resume_state=RESUME)
    payload = jax_ckpt._template(state)
    del payload["resume_state"]
    payload.update(epoch=2, val_loss=0.5)
    legacy.write_bytes(serialization.to_bytes(payload))
    return current, legacy


def _port_state(widths=WIDTHS):
    model = init_multitask_model("MTnnUNet", nnunet_widths=widths)
    return create_train_state(model, "Adam", LR)


def _images(n=2):
    return np.random.default_rng(5).uniform(0, 255, (n, SIZE, SIZE, 1)).astype(np.float32)


@pytest.mark.parametrize("which", ["current", "legacy"])
def test_port_forward_on_a_jax_checkpoint_matches_jax(jax_state, files, which):
    path = files[0] if which == "current" else files[1]
    state = ckpt.load_pretrained_model(_port_state(), str(path))
    x = _images()
    with torch.no_grad():
        port_out = state.model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    apply = jax.jit(jax_mtnnunet("MTnnUNet", nnunet_widths=WIDTHS).apply,
                    static_argnames="train")
    jax_out = apply({"params": jax_state[0].params}, jnp.asarray(x), train=False)
    (pc,), ps = port_out
    (jc,), js = jax_out
    pairs = [(pc.numpy(), np.asarray(jc))] + [
        (p.numpy().transpose(0, 2, 3, 1), np.asarray(j)) for p, j in zip(ps, js)]
    for p, j in pairs:
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-4 * np.abs(j).max())


def test_restore_reads_epoch_counters_and_marks_legacy_files(files):
    _, epoch, val_loss, resume = ckpt.restore_checkpoint(_port_state(), str(files[0]))
    assert (epoch, val_loss) == (4, 0.25)
    assert resume == dict(RESUME, valid=1.0)
    state, epoch, val_loss, resume = ckpt.restore_checkpoint(_port_state(), str(files[1]))
    assert (epoch, val_loss, state.step) == (2, 0.5, 1)
    assert resume == ckpt.EMPTY_RESUME_STATE


def test_a_width_mismatch_raises(files):
    for load in (ckpt.load_pretrained_model, ckpt.restore_checkpoint):
        with pytest.raises(ValueError, match="shape mismatch"):
            load(_port_state([4, 8, 8, 16, 32]), str(files[0]))


def test_resumed_adam_step_matches_optax(jax_state, files):
    """The port resumes the JAX run: optax's moments, count and learning rate
    go into ``torch.optim.Adam``, and its next step equals optax's."""
    state, tx, update = jax_state
    port, _, _, _ = ckpt.restore_checkpoint(_port_state(), str(files[0]))
    adam = state.opt_state.inner_state[0]
    mu, nu = params_from_jax(adam.mu, port.model), params_from_jax(adam.nu, port.model)
    names = [n for n, _ in port.model.named_parameters()]
    for i, name in enumerate(names):
        s = port.optimizer.state[port.optimizer.param_groups[0]["params"][i]]
        assert float(s["step"]) == 1.0
        assert torch.equal(s["exp_avg"], mu[name]) and torch.equal(s["exp_avg_sq"], nu[name])
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(LR)

    grads = _grads(state.params, 2)
    updates, _ = update(grads, state.opt_state, state.params)
    want = params_from_jax(jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates),
                           port.model)
    g = params_from_jax(grads, port.model)
    for name, p in port.model.named_parameters():
        p.grad = g[name]
    port.optimizer.step()
    got = port.model.state_dict()
    for name in names:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("opt", ["SGD", "Lion"])
def test_resumed_sgd_step_matches_optax(tmp_path, opt):
    """A JAX run trained with SGD resumes in the port: optax's Nesterov
    ``trace`` goes into ``torch.optim.SGD``'s ``momentum_buffer`` and the
    next step equals optax's. Both factories take SGD(momentum 0.9,
    nesterov) for ``SGD`` and for a name they do not know (``Lion``). An
    optimizer of another type than the state raises."""
    port0 = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                 generator=torch.Generator().manual_seed(3))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port0.state_dict(), port0))
    tx = jax_optimizer(opt, LR)
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    for seed in (1, 2):  # two steps, so the trace is not the first gradient
        updates, opt_state = update(_grads(params, seed), opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
    state = JaxTrainState(params=params, batch_stats={}, opt_state=opt_state,
                          step=jnp.asarray(2, jnp.int32))
    path = tmp_path / "model_fold_0"
    jax_ckpt.save_checkpoint(str(path), state, epoch=1, val_loss=0.5, resume_state=RESUME)

    model = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS)
    port, _, _, _ = ckpt.restore_checkpoint(create_train_state(model, opt, LR), str(path))
    assert isinstance(port.optimizer, torch.optim.SGD) and port.step == 2
    trace = params_from_jax(opt_state.inner_state[0].trace, port.model)
    for p, (name, _) in zip(port.optimizer.param_groups[0]["params"],
                            port.model.named_parameters()):
        assert torch.equal(port.optimizer.state[p]["momentum_buffer"], trace[name])
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(LR)

    grads = _grads(state.params, 3)
    updates, _ = update(grads, state.opt_state, state.params)
    want = params_from_jax(jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates),
                           port.model)
    g = params_from_jax(grads, port.model)
    for name, p in port.model.named_parameters():
        p.grad = g[name]
    port.optimizer.step()
    got = port.model.state_dict()
    for name, _ in port.model.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0, atol=1e-6)

    adam = create_train_state(init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS),
                              "Adam", LR)
    with pytest.raises(ValueError, match=r"got optax state \['trace'\] for Adam"):
        ckpt.restore_checkpoint(adam, str(path))


def test_checkpoint_backend_serves_a_jax_checkpoint(files):
    cfg = Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=WIDTHS),
                 data=DataConfig(input_img="unused"))
    backend = CheckpointBackend(cfg, "multitask", checkpoint=str(files[0]), size=SIZE,
                                max_batch=2, device="cpu")
    x = _images()
    state = ckpt.load_pretrained_model(_port_state(), str(files[0]))
    with torch.inference_mode():
        (cls,), _ = state.model.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    (served,), _ = backend.predict(x)
    # the same weights and CPU code; the backend's input has NCHW strides,
    # this one a transposed view's, and oneDNN may sum in another order
    np.testing.assert_allclose(served, cls.numpy(), rtol=0, atol=1e-5 * np.abs(cls.numpy()).max())


def _numpy_leaves(node):
    """jax arrays to numpy, dict order kept (``tree_map`` would sort keys)."""
    if isinstance(node, dict):
        return {k: _numpy_leaves(v) for k, v in node.items()}
    return np.asarray(node) if isinstance(node, jax.Array) else node


def _jax_state_dict(payload) -> dict:
    """flax's state dict of ``payload`` with numpy leaves (what ``to_bytes``
    packs): the input of ``chip_smoke.flax_msgpack_bytes``."""
    return _numpy_leaves(serialization.to_state_dict(payload))


def _assert_same_tree(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_smoke_writer_is_flax_byte_for_byte_and_the_decoder_reads_it(jax_state, files):
    state = jax_state[0]
    payload = dict(jax_ckpt._template(state), epoch=4, val_loss=0.25,
                   resume_state=dict(jax_ckpt.EMPTY_RESUME_STATE, valid=1.0, **RESUME))
    written = chip_smoke.flax_msgpack_bytes(_jax_state_dict(payload))
    assert written == serialization.to_bytes(payload) == files[0].read_bytes()
    _assert_same_tree(flax_msgpack.msgpack_restore(written), serialization.msgpack_restore(written))
    # numpy scalar leaves, as a loss from a numpy reduction would be: flax
    # packs them as ext type 3 (np.float64 is also a Python float)
    scalars = dict(payload, val_loss=np.float64(0.25), step=np.int64(3), flag=np.bool_(True))
    written = chip_smoke.flax_msgpack_bytes(_jax_state_dict(scalars))
    assert written == serialization.to_bytes(scalars)
    _assert_same_tree(flax_msgpack.msgpack_restore(written), serialization.msgpack_restore(written))


def test_decoder_reads_every_type_flax_writes(monkeypatch):
    """Scalars of every width and sign, strings and bins of each length
    class, bool, nil, lists, numpy scalars, bfloat16, complex, long maps and
    chunked arrays (flax splits arrays above ``MAX_CHUNK_SIZE``, lowered
    here so a small array is split)."""
    rng = np.random.default_rng(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e300], "none": None, "flags": [True, False],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "npscalar": np.float32(2.5), "complex": 1.5 - 2j,
        "bf16": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
        "arrays": {str(i): rng.standard_normal((i + 1, 3)).astype(np.float32) for i in range(20)},
        "big": rng.standard_normal((40, 7)).astype(np.float64),
        "shapes": {"scalar": np.asarray(3, np.int32), "u8": np.arange(6, dtype=np.uint8)},
    }
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    data = serialization.msgpack_serialize(tree)
    got, want = flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data)
    assert isinstance(want["big"], np.ndarray) and b"__msgpack_chunked_array__" in data
    np.testing.assert_array_equal(got.pop("bf16"), np.asarray(want.pop("bf16"), np.float32))
    _assert_same_tree(got, want)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(data[:-3])
