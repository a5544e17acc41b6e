"""The port's serving artifacts (``serve export``, ``serve/export.py``) on the
CPU, at a small size (MTnnUNet widths (4, 8, 8, 16, 16), 32², buckets 1, 2
and 4), against the live model and against the JAX package's artifact of
the same weights.

Tolerances: an artifact's f32 program against the live model, 1e-5 of the
output's scale (the same f32 arithmetic; the traced program lays out its
convolutions' inputs itself). Port artifact against JAX artifact: f32 raw
outputs to 1e-4 absolute (two frameworks' f32 convolutions, as
``tests/test_torch_serving.py``), masks by the rule of
``tests/test_torch_tools.py``. bf16: raw outputs within 5e-2 of each
output's scale, the port-vs-JAX bound of ``tests/test_torch_bf16.py``
(measured at most 0.042); probabilities within 1e-2 (measured 2.6e-3) and
masks by the flip rule at 2 % of the pixels (measured at most 11 of 1,024).
Compact outputs against the host postprocessing of the raw ones, the packed
mask, uint8 against f32 input, weights and manifest: exactly.
"""

from __future__ import annotations

import json
import shutil
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig, ModelConfig
from multi_task_breast_cancer_tpu_torch.models.jax_weights import flat_jax_weights, transposed_convs
from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model
from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk
from multi_task_breast_cancer_tpu_torch.serve import export as E
from multi_task_breast_cancer_tpu_torch.serve import post
from multi_task_breast_cancer_tpu_torch.serve.server import ArtifactBackend, CheckpointBackend
from multi_task_breast_cancer_tpu_torch.train.checkpoint import save_checkpoint
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from multi_task_breast_cancer_tpu_torch.utils.trees import tree_map
from test_torch_driver import one_torch_thread  # noqa: F401  (a fixture)

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = [4, 8, 8, 16, 16]
SIZE = 32
BUCKETS = (1, 2, 4)
CLASSES = ["benign", "malignant", "normal"]


def _cfg(dtype: str = "float32") -> Config:
    cfg = Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=WIDTHS),
                 data=DataConfig(input_img="unused", classes=CLASSES))
    cfg.training.compute_dtype = dtype
    return cfg


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)


def _flat(out):
    (cls,), seg = out
    return [cls, *seg]


def _checkpoint(path: Path, seed: int) -> Path:
    model = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                 generator=torch.Generator().manual_seed(seed))
    save_checkpoint(str(path), create_train_state(model, "Adam", 1e-4), epoch=1, val_loss=0.5)
    return path


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A port checkpoint, and its f32 raw and bf16 compact artifacts."""
    root = tmp_path_factory.mktemp("export")
    ckpt = _checkpoint(root / "model_fold_0", seed=5)
    return {
        "root": root, "ckpt": ckpt,
        "raw": E.export_inference(_cfg(), "multitask", ckpt, root / "raw", buckets=BUCKETS,
                                  size=SIZE, platforms=("cpu",)),
        "compact": E.export_inference(_cfg(), "multitask", ckpt, root / "compact",
                                      buckets=BUCKETS, size=SIZE, platforms=("cpu",),
                                      device_postprocess=True),
    }


def _live(ckpt, dtype="float32"):
    return CheckpointBackend(_cfg(dtype), "multitask", checkpoint=str(ckpt), size=SIZE,
                             max_batch=4, device="cpu")


@pytest.mark.parametrize("n", [1, 3, 5, 9])  # one image, padded, tail bucket, chunked
def test_artifact_equals_the_live_model(artifacts, n):
    model = E.ExportedModel(artifacts["raw"], device="cpu")
    images = _images(n, seed=n)
    got, want = _flat(model.predict(images)), _flat(_live(artifacts["ckpt"]).predict(images))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_buckets_padding_and_chunking(artifacts, monkeypatch):
    """The bucket plan (largest-bucket chunks, the tail in the smallest
    bucket that holds it); the host uploads only the next power of two of a
    short batch and the device pads the rest; every answer is the answer of
    the image alone."""
    model = E.ExportedModel(artifacts["raw"], device="cpu")
    assert [model._plan(n) for n in (1, 2, 3, 4, 5, 7, 9)] == [
        [1], [2], [4], [4], [4, 1], [4, 4], [4, 4, 1]]
    uploads, runs = [], []
    real_from_numpy, real_fn = torch.from_numpy, model._fn

    def from_numpy(a):
        uploads.append(a.shape[0])
        return real_from_numpy(a)

    def fn(bucket):
        program = real_fn(bucket)

        def run(weights, x):
            runs.append((bucket, x.shape[0], x.dtype))
            return program(weights, x)
        return run

    monkeypatch.setattr(E.torch, "from_numpy", from_numpy)
    monkeypatch.setattr(model, "_fn", fn)
    images = _images(7, seed=7)
    (cls,), _ = model.predict(images)
    assert uploads == [4, 4] and runs == [(4, 4, torch.float32)] * 2
    uploads.clear(), runs.clear()
    model.predict(images[:5])
    assert uploads == [4, 1] and runs == [(4, 4, torch.float32), (1, 1, torch.float32)]
    uploads.clear(), runs.clear()
    model.buckets = [1, 4]  # two images go to bucket 4: two uploaded, two padded on the device
    model.predict(images[:2])
    assert uploads == [2] and runs == [(4, 4, torch.float32)]
    monkeypatch.undo()
    model.buckets = list(BUCKETS)
    singles = np.concatenate([model.predict(images[i:i + 1])[0][0] for i in range(7)])
    # bucket 1's program against bucket 4's: f32 convolutions of other batch
    # sizes sum in other orders
    assert np.abs(cls - singles).max() <= 1e-5 * np.abs(singles).max()


def test_compact_outputs_equal_host_postprocess(artifacts, monkeypatch):
    """The device-postprocessed artifact's answer, decoded, equals the host
    postprocessing of the raw artifact's outputs; its mask is downloaded
    bit-packed (``_pack_mask_bits`` on the device) and unpacked on the host
    to the same bytes."""
    images = _images(6, seed=11)
    raw = E.ExportedModel(artifacts["raw"], device="cpu").predict(images)
    packed = []
    real_pack = E._pack_mask_bits

    def pack(mask):
        packed.append(real_pack(mask).numpy())
        return torch.from_numpy(packed[-1])

    monkeypatch.setattr(E, "_pack_mask_bits", pack)
    compact = E.ExportedModel(artifacts["compact"], device="cpu").predict(images)
    assert compact["mask"].dtype == np.uint8 and compact["tumor_pixels"].dtype == np.int32
    # buckets 4 + 2: each execution's mask crossed bit-packed
    assert [p.shape for p in packed] == [(4, SIZE, SIZE // 8), (2, SIZE, SIZE // 8)]
    np.testing.assert_array_equal(np.concatenate(packed), np.packbits(compact["mask"], axis=-1))
    m = json.loads((artifacts["compact"] / "manifest.json").read_text())
    got = post.postprocess_compact(compact, "multitask", 3, m["pipeline_refinement"])
    want = post.postprocess(raw, "multitask", 3, m["pipeline_refinement"], False)
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=1e-6)
    assert got.pred_class == want.pred_class and got.mask_scale == want.mask_scale
    np.testing.assert_array_equal(got.masks, want.masks)
    np.testing.assert_array_equal(compact["tumor_pixels"], want.masks.sum(axis=(1, 2)))


@pytest.mark.parametrize("semantic", [False, True])
def test_compact_outputs_twin_jax(semantic):
    """``_compact_outputs`` against the JAX function on the same raw outputs
    (binary heads, and a 3-label semantic head)."""
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.serve.export import _compact_outputs as jax_compact

    rng = np.random.default_rng(3)
    regions = 3 if semantic else 1
    heads = tuple(rng.standard_normal((4, 8, 8, regions)).astype(np.float32) for _ in range(4))
    out = ((rng.standard_normal((4, 3)).astype(np.float32),), heads)
    task = "segmentation" if semantic else "multitask"
    tree = heads if semantic else out
    got = E._compact_outputs(tree_map(torch.from_numpy, tree), task, 3, False)
    want = jax_compact(tree_map(jnp.asarray, tree), task, 3, False)
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6)


def test_packed_mask_equals_np_packbits():
    mask = np.random.default_rng(4).integers(0, 2, (3, 16, 24), dtype=np.uint8)
    got = E._pack_mask_bits(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.packbits(mask, axis=-1))
    np.testing.assert_array_equal(np.unpackbits(got, axis=-1), mask)


def test_uint8_input_is_bit_identical_to_f32(artifacts):
    model = E.ExportedModel(artifacts["raw"], device="cpu")
    images = _images(3, seed=12)
    for a, b in zip(_flat(model.predict(images)), _flat(model.predict(images.astype(np.float32)))):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """One JAX-written (flax-msgpack) checkpoint of the port's seeded
    weights, and the JAX package's artifacts of it: f32 and bf16, raw and
    device-postprocessed. The JAX ``create_train_state`` is handed the
    state's tree, so no JAX ``init`` compiles."""
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.config import (
        Config as JaxConfig,
        DataConfig as JaxDataConfig,
        ModelConfig as JaxModelConfig,
    )
    from multi_task_breast_cancer_tpu.serve import export as JE
    from multi_task_breast_cancer_tpu.train import checkpoint as jax_ckpt
    from multi_task_breast_cancer_tpu.train import driver as jax_driver
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState as JaxTrainState
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import params_to_jax

    root = tmp_path_factory.mktemp("jax_side")
    port = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                generator=torch.Generator().manual_seed(13))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(port.state_dict(), port))
    tx = init_optimizer("Adam", 1e-4)
    state = JaxTrainState(params=params, batch_stats={}, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32))
    ckpt = root / "model_fold_0"
    jax_ckpt.save_checkpoint(str(ckpt), state, epoch=1, val_loss=0.5)
    real = jax_driver.create_train_state
    jax_driver.create_train_state = lambda *args: state
    try:
        artifacts = {}
        for dtype in ("float32", "bfloat16"):
            jcfg = JaxConfig(model=JaxModelConfig(architecture="MTnnUNet", nnunet_widths=WIDTHS),
                             data=JaxDataConfig(input_img="unused", classes=CLASSES))
            jcfg.training.compute_dtype = dtype
            for compact in (False, True):
                artifacts[dtype, compact] = JE.export_inference(
                    jcfg, "multitask", str(ckpt), root / f"{dtype}_{compact}", buckets=(4,),
                    size=SIZE, platforms=("cpu",), device_postprocess=compact)
    finally:
        jax_driver.create_train_state = real
    return {"ckpt": ckpt, "state_dict": port.state_dict(), "model": port, "artifacts": artifacts}


def test_manifest_and_weights_follow_the_jax_layout(jax_side, tmp_path):
    """The manifest has the JAX manifest's keys (``torch_version`` for
    ``jax_version``, plus ``format`` and ``transposed_convs``); ``weights.npz``
    has JAX's keys, shapes and values for the same weights."""
    jart = jax_side["artifacts"]["float32", False]
    part = E.export_inference(_cfg(), "multitask", str(jax_side["ckpt"]), tmp_path / "port",
                              buckets=(1,), size=SIZE, platforms=("cpu",))
    want = json.loads((jart / "manifest.json").read_text())
    got = json.loads((part / "manifest.json").read_text())
    assert set(got) == (set(want) - {"jax_version"}) | {"torch_version", "format",
                                                         "transposed_convs"}
    assert got["transposed_convs"] == sorted(transposed_convs(jax_side["model"]))
    assert got["format"] == "torch.export" and got["platforms"] == ["cpu"]
    for k in set(want) - {"jax_version", "buckets", "platforms"}:
        assert got[k] == want[k], k
    with np.load(jart / "weights.npz") as zj, np.load(part / "weights.npz") as zp:
        assert set(zj.files) == set(zp.files)
        for k in zj.files:
            assert zp[k].dtype == np.float32
            np.testing.assert_array_equal(zp[k], zj[k])
    flat = flat_jax_weights(jax_side["state_dict"], jax_side["model"])
    with np.load(part / "weights.npz") as zp:
        assert set(flat) == set(zp.files)


def test_programs_carry_no_weights_and_swapped_weights_take_effect(artifacts, tmp_path):
    """Each program's ``state_dict`` (and constants) is empty, the fused
    norm is one node of it, 25 times; a ``weights.npz`` swapped in gives the
    new weights' answer."""
    for b in BUCKETS:
        program = torch.export.load(artifacts["raw"] / E.program_name(b, "cpu"))
        assert len(program.state_dict) == 0 and len(program.constants) == 0
        ops = [n for n in program.graph.nodes
               if n.op == "call_function" and "mtbc_torch" in str(n.target)]
        assert len(ops) == 25
    swapped = tmp_path / "swapped"
    shutil.copytree(artifacts["raw"], swapped)
    other = init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                 generator=torch.Generator().manual_seed(9))
    np.savez(swapped / "weights.npz", **flat_jax_weights(other.state_dict(), other))
    images = _images(3, seed=14)
    got = _flat(E.ExportedModel(swapped, device="cpu").predict(images))
    want = _flat(_live(_checkpoint(tmp_path / "other_fold_0", seed=9)).predict(images))
    before = _flat(E.ExportedModel(artifacts["raw"], device="cpu").predict(images))
    for a, b, c in zip(got, want, before):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
        assert np.abs(a - c).max() > 1e-3 * np.abs(b).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_artifact_agrees_with_jax_artifact(jax_side, tmp_path, dtype):
    """The JAX package's ``export_inference`` and the port's, on one
    JAX-written (flax-msgpack) checkpoint, served on the CPU by each
    package's own loader: raw outputs within tolerance, the compact answer's
    classes equal and masks by the flip rule."""
    from multi_task_breast_cancer_tpu.serve import export as JE

    images = _images(5, seed=15)
    answers = {}
    for compact in (False, True):
        part = E.export_inference(_cfg(dtype), "multitask", str(jax_side["ckpt"]),
                                  tmp_path / f"port{compact}", buckets=(4,), size=SIZE,
                                  platforms=("cpu",), device_postprocess=compact)
        answers[compact] = (E.ExportedModel(part, device="cpu").predict(images),
                            JE.ExportedModel(jax_side["artifacts"][dtype, compact]).predict(images))
    got, want = answers[False]
    for a, b in zip(_flat(got), _flat(want)):
        b = np.asarray(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        else:  # two bf16 forwards (measured: 0.024 to 0.042 of the scale)
            assert np.abs(a - b).max() <= 5e-2 * np.abs(b).max()
    got, want = answers[True]
    atol, share = (1e-4, 0.01) if dtype == "float32" else (1e-2, 0.02)
    np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]), rtol=0, atol=atol)
    assert (got["probs"].argmax(-1) == np.asarray(want["probs"]).argmax(-1)).all()
    k = (got["mask"] != np.asarray(want["mask"])).sum(axis=(1, 2))
    assert (k <= share * SIZE * SIZE).all(), k
    assert (np.abs(got["tumor_pixels"] - np.asarray(want["tumor_pixels"])) <= k).all()


def test_custom_op_traces_and_matches_the_function():
    """The norm's custom operator: a fake tensor gets the input's shape,
    dtype and strides; on the CPU it is the plain twin; its gradient (the
    registered autograd formula) equals the ``torch.autograd.Function``'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(2, 3, 8, 8, dtype=torch.bfloat16)
        y = hk.instance_norm_leaky_relu_op(x, 1e-5, 0.01)
        assert y.shape == x.shape and y.dtype == x.dtype and y.stride() == x.stride()
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(0)) * 2 + 5
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        assert torch.equal(hk.instance_norm_leaky_relu_op(xd, 1e-5, 0.01),
                           hk.instance_norm_leaky_relu_reference(xd))
    g = torch.randn_like(x)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    hk.instance_norm_leaky_relu_op(a, 1e-5, 0.01).backward(g)
    hk.instance_norm_leaky_relu(b).backward(g)
    assert torch.equal(a.grad, b.grad)


def test_exporting_for_the_card_without_one_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        E.export_inference(_cfg(), "multitask", None, tmp_path / "art", buckets=(1,),
                           size=SIZE)
    assert not (tmp_path / "art").exists()


def test_data_parallel_over_gpus_raises(artifacts, monkeypatch):
    """Data parallelism over several devices is ported: ``ExportedModel``
    with two replicas no longer raises, keeps one weight copy per device and
    answers as one replica; over several visible GPUs it picks one replica
    per GPU."""
    model = E.ExportedModel(artifacts["raw"], devices=["cpu", "cpu"])
    assert model.devices == [torch.device("cpu")] * 2 and len(model._weights) == 1
    images = _images(9, seed=2)
    one = E.ExportedModel(artifacts["raw"], device="cpu")
    for a, b in zip(_flat(model.predict(images)), _flat(one.predict(images))):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert E.replica_devices(None) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert E.replica_devices("cuda:1") == [torch.device("cuda", 1)]
    assert E.replica_devices(None, data_parallel=False) == [torch.device("cuda", 0)]


def test_loading_an_artifact_imports_no_model_code(artifacts):
    """A fresh interpreter loads and runs an artifact with the operator
    library and without the model zoo."""
    code = (
        "import sys, numpy as np\n"
        "from multi_task_breast_cancer_tpu_torch.serve.export import ExportedModel\n"
        f"m = ExportedModel({str(artifacts['raw'])!r}, device='cpu')\n"
        f"m.predict(np.zeros((2, {SIZE}, {SIZE}, 1), np.uint8))\n"
        "zoo = sorted(n for n in sys.modules if n.startswith(\n"
        "    'multi_task_breast_cancer_tpu_torch.models.') and not n.endswith('jax_weights'))\n"
        "assert not zoo, zoo\n"
        "assert 'multi_task_breast_cancer_tpu_torch.ops.hopper_kernels' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_export_then_serve_run_through_the_cli(artifacts, tmp_path):
    """``serve export`` (in-process, ``--platforms cpu``) writes an artifact;
    ``serve run --artifact`` in a process of its own serves it; ``/predict``
    answers what ``ArtifactBackend`` answers directly."""
    from multi_task_breast_cancer_tpu_torch.config import config_to_yaml
    from multi_task_breast_cancer_tpu_torch.serve.__main__ import main

    cfg = tmp_path / "config.yaml"
    cfg.write_text(config_to_yaml(_cfg()))
    art = tmp_path / "art"
    main(["export", "--config", str(cfg), "--checkpoint", str(artifacts["ckpt"]),
          "--output", str(art), "--buckets", "1,4", "--size", str(SIZE), "--platforms", "cpu",
          "--device-postprocess"])
    assert sorted(p.name for p in art.iterdir()) == [
        "fwd_b1.cpu.pt2", "fwd_b4.cpu.pt2", "manifest.json", "weights.npz"]
    image = _images(1, seed=16)
    backend = ArtifactBackend(str(art), device="cpu")
    assert backend.info["device_postprocess"] is True
    want = backend.postprocess(backend.predict(image)).record(0)

    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "multi_task_breast_cancer_tpu_torch.serve", "run", "--artifact",
         str(art), "--port", str(port), "--host", "127.0.0.1", "--device", "cpu",
         "--max-batch", "4"], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            try:
                health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=5).read())
                break
            except OSError:
                assert proc.poll() is None and time.monotonic() < deadline, \
                    proc.stderr.read().decode()[-3000:] if proc.poll() is not None else "timeout"
                time.sleep(0.5)
        assert health["model"]["backend"] == "artifact"
        req = urllib.request.Request(base + "/predict", data=image[0, ..., 0].tobytes(),
                                     method="POST",
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert got["predicted_class"] == want["predicted_class"]
    assert got["tumor_pixels"] == want["tumor_pixels"]
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=0, atol=1e-6)


def test_residual_unet_artifact_round_trip(tmp_path):
    """ResidualUNet's batch statistics through ``serve export`` and back.
    Port → JAX: the port artifact's ``weights.npz`` holds them under
    ``batch_stats/`` bit for bit, and the JAX model on its variables answers
    as the exported program and the live backend do (1e-4 of scale). JAX →
    port: ``ArtifactBackend`` over JAX's own artifact of the same checkpoint
    reads them and answers as the live backend does. The program takes them
    as inputs: none is a constant of it."""
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.config import (
        Config as JaxConfig,
        DataConfig as JaxDataConfig,
        ModelConfig as JaxModelConfig,
    )
    from multi_task_breast_cancer_tpu.models.residual_unet import ResidualUNet as JResidualUNet
    from multi_task_breast_cancer_tpu.serve import export as JE
    from multi_task_breast_cancer_tpu.train import checkpoint as jax_ckpt
    from multi_task_breast_cancer_tpu.train import driver as jax_driver
    from multi_task_breast_cancer_tpu.train.optim import init_optimizer
    from multi_task_breast_cancer_tpu.train.state import TrainState as JaxTrainState
    from multi_task_breast_cancer_tpu_torch.models.jax_weights import variables_to_jax
    from multi_task_breast_cancer_tpu_torch.models.registry import init_segmentation_model

    model = init_segmentation_model("ResidualUNet", width=4,
                                    generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(5)
    for name, buf in model.named_buffers():
        buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if name.endswith("var") else 0.0))
    ckpt = tmp_path / "model_fold_0.tar"
    save_checkpoint(str(ckpt), create_train_state(model, "Adam", 1e-4), epoch=1, val_loss=0.5)
    cfg = Config(model=ModelConfig(architecture="ResidualUNet", width=4),
                 data=DataConfig(input_img="unused", classes=CLASSES))
    art = E.export_inference(cfg, "segmentation", str(ckpt), tmp_path / "port", buckets=(2,),
                             size=SIZE, platforms=("cpu",))
    with np.load(art / "weights.npz") as z:
        flat = {k: z[k] for k in z.files}
    for name, buf in model.named_buffers():
        np.testing.assert_array_equal(flat["batch_stats/" + name.replace(".", "/")], buf.numpy())
    program = torch.export.load(art / E.program_name(2, "cpu"))
    assert len(program.state_dict) == 0 and len(program.constants) == 0

    images = _images(2, 6)
    live = CheckpointBackend(cfg, "segmentation", checkpoint=str(ckpt), size=SIZE, device="cpu")
    want = live.predict(images)
    scale = max(1.0, float(np.abs(want).max()))
    got = ArtifactBackend(str(art), device="cpu").predict(images)
    assert np.abs(got - want).max() <= 1e-4 * scale
    variables = variables_to_jax(model.state_dict(), model)
    jout = np.asarray(JResidualUNet(width=4).apply(
        {"params": JE._unflatten_variables(flat)["params"],
         "batch_stats": JE._unflatten_variables(flat)["batch_stats"]},
        jnp.asarray(images, jnp.float32), train=False))
    assert np.abs(jout - want).max() <= 1e-4 * scale

    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = init_optimizer("Adam", 1e-4)
    state = JaxTrainState(params=params, batch_stats=variables["batch_stats"],
                          opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    jckpt = tmp_path / "jax_fold_0.tar"
    jax_ckpt.save_checkpoint(str(jckpt), state, epoch=1, val_loss=0.5)
    real = jax_driver.create_train_state
    jax_driver.create_train_state = lambda *args: state
    try:
        jcfg = JaxConfig(model=JaxModelConfig(architecture="ResidualUNet", width=4),
                         data=JaxDataConfig(input_img="unused", classes=CLASSES))
        jart = JE.export_inference(jcfg, "segmentation", str(jckpt), tmp_path / "jax",
                                   buckets=(2,), size=SIZE, platforms=("cpu",))
    finally:
        jax_driver.create_train_state = real
    with np.load(jart / "weights.npz") as zj:
        assert set(zj.files) == set(flat)
        for k in zj.files:
            np.testing.assert_array_equal(zj[k], flat[k])
    got = ArtifactBackend(str(jart), device="cpu").predict(images)
    assert np.abs(got - want).max() <= 1e-4 * scale
    # a JAX flax-msgpack checkpoint of it loads with its batch statistics
    served = CheckpointBackend(cfg, "segmentation", checkpoint=str(jckpt), size=SIZE,
                               device="cpu")
    assert all(torch.equal(b, dict(served.model.named_buffers())[k])
               for k, b in model.named_buffers())


@pytest.mark.parametrize("arch", ["UNet", "AttentionUNet", "SegResNet", "SwinUNETR"])
def test_seg_zoo_artifact_equals_the_live_backend(arch, tmp_path):
    """The MONAI twins and SwinUNETR through ``serve export``: the program
    answers as the live backend does (1e-5 of scale, as the flagship's).
    SwinUNETR's relative-position index and shift masks, first made inside
    the trace, become real constants of the program, and each of its 20
    LayerNorm sites is one ``mtbc_torch::layer_norm`` node."""
    from multi_task_breast_cancer_tpu_torch.models import swin_unetr
    from multi_task_breast_cancer_tpu_torch.models.registry import init_segmentation_model

    swin_unetr._CONSTANTS.clear()
    model = init_segmentation_model(arch, width=4, size=SIZE,
                                    generator=torch.Generator().manual_seed(7))
    ckpt = tmp_path / "model_fold_0.tar"
    save_checkpoint(str(ckpt), create_train_state(model, "Adam", 1e-4), epoch=1, val_loss=0.5)
    cfg = Config(model=ModelConfig(architecture=arch, width=4),
                 data=DataConfig(input_img="unused", classes=CLASSES))
    art = E.export_inference(cfg, "segmentation", str(ckpt), tmp_path / "art", buckets=(2,),
                             size=SIZE, platforms=("cpu",))
    images = _images(3, 8)
    want = CheckpointBackend(cfg, "segmentation", checkpoint=str(ckpt), size=SIZE,
                             device="cpu").predict(images)
    got = ArtifactBackend(str(art), device="cpu").predict(images)
    assert got.shape == (3, SIZE, SIZE, 1)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, float(np.abs(want).max()))
    program = torch.export.load(art / E.program_name(2, "cpu"))
    assert len(program.state_dict) == 0
    assert (len(program.constants) > 0) == (arch == "SwinUNETR")
    ops = [str(n.target) for n in program.graph.nodes
           if n.op == "call_function" and "mtbc_torch" in str(n.target)]
    assert ops == ["mtbc_torch.layer_norm.default"] * (20 if arch == "SwinUNETR" else 0)
