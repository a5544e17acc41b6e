"""The PyTorch port's serving path against the JAX package's.

A narrow MTnnUNet (widths 4…16, 64²) is exported by the JAX package into a
serving artifact; the port serves the same artifact from its ``weights.npz``
on the CPU. Probabilities agree to 1e-4 (f32 forwards of two frameworks);
predicted classes and masks are equal. Postprocessing is a copy, so it must
give the same answers bit for bit.
"""

from __future__ import annotations

import io
import json
import shutil
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.config import (
    Config as JaxConfig,
    DataConfig as JaxDataConfig,
    ModelConfig as JaxModelConfig,
)
from multi_task_breast_cancer_tpu.serve import post as jax_post
from multi_task_breast_cancer_tpu.serve.export import export_inference
from multi_task_breast_cancer_tpu.serve.server import (
    ArtifactBackend as JaxArtifactBackend,
    prepare_image as jax_prepare_image,
)
from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig, ModelConfig
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.models.blocks import ConvInNormLeReLU
from multi_task_breast_cancer_tpu_torch.serve import post
from multi_task_breast_cancer_tpu_torch.serve.server import (
    ArtifactBackend,
    CheckpointBackend,
    InferenceServer,
    prepare_image,
)
from multi_task_breast_cancer_tpu_torch.train.checkpoint import save_checkpoint
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state

SIZE = 64
WIDTHS = [4, 8, 8, 16, 16]
CLASSES = ["benign", "malignant", "normal"]


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A JAX serving artifact of a freshly initialised narrow MTnnUNet."""
    cfg = JaxConfig(model=JaxModelConfig(architecture="MTnnUNet", nnunet_widths=WIDTHS),
                    data=JaxDataConfig(input_img="unused", classes=CLASSES))
    return export_inference(cfg, "multitask", None,
                            tmp_path_factory.mktemp("serve") / "artifact",
                            buckets=(4,), size=SIZE, platforms=("cpu",))


def _port_cfg() -> Config:
    return Config(model=ModelConfig(architecture="MTnnUNet", nnunet_widths=WIDTHS),
                  data=DataConfig(input_img="unused", classes=CLASSES))


def _assert_same_answers(got, want, probs_atol: float) -> None:
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=probs_atol)
    assert got.pred_class == want.pred_class
    np.testing.assert_array_equal(got.masks, want.masks)
    assert got.mask_scale == want.mask_scale


def _raw_outputs(task: str, n_classes: int, regions: int, rng):
    n = 4
    n_out = 1 if n_classes == 2 else n_classes
    heads = tuple(rng.standard_normal((n, 8, 8, regions)).astype(np.float32) for _ in range(4))
    heads[-1][0] = -10.0  # an empty mask: the pipeline-refinement rule fires
    cls = rng.standard_normal((n, n_out)).astype(np.float32)
    return {"multitask": ((cls,), heads), "segmentation": heads,
            "classification": cls}[task]


@pytest.mark.parametrize("task,n_classes,regions,pr,softmax_in_forward", [
    ("multitask", 3, 1, True, False),
    ("multitask", 2, 1, False, False),
    ("segmentation", 3, 3, True, False),
    ("segmentation", 3, 1, True, False),
    ("classification", 3, 1, False, True),
    ("classification", 2, 1, False, False),
])
def test_postprocess_matches_jax(task, n_classes, regions, pr, softmax_in_forward):
    out = _raw_outputs(task, n_classes, regions, np.random.default_rng(regions + n_classes))
    got = post.postprocess(out, task, n_classes, pr, softmax_in_forward)
    want = jax_post.postprocess(out, task, n_classes, pr, softmax_in_forward)
    for name in ("probs", "masks"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert got.pred_class == want.pred_class and got.mask_scale == want.mask_scale
    assert [got.record(i) for i in range(4)] == [want.record(i) for i in range(4)]


@pytest.mark.parametrize("semantic", [False, True])
def test_postprocess_compact_matches_jax(semantic):
    rng = np.random.default_rng(3)
    out = {"probs": rng.random((4, 3)).astype(np.float32),
           "mask": rng.integers(0, 3 if semantic else 2, (4, 8, 8), dtype=np.uint8)}
    if semantic:
        out["label_counts"] = rng.integers(0, 20, (4, 3)).astype(np.int32)
    else:
        out["tumor_pixels"] = np.array([0, 5, 0, 9], np.int32)
    task = "segmentation" if semantic else "multitask"
    got = post.postprocess_compact(out, task, 3, True)
    want = jax_post.postprocess_compact(out, task, 3, True)
    _assert_same_answers(got, want, probs_atol=0)


@pytest.mark.parametrize("n", [3, 9])  # pads into the B=4 bucket / chunks by it
def test_artifact_backend_matches_jax(artifact, n):
    jax_b = JaxArtifactBackend(str(artifact))
    port_b = ArtifactBackend(str(artifact), device="cpu")
    for key in ("task", "architecture", "n_classes", "classes", "size", "channels",
                "buckets", "augmentation", "pipeline_refinement", "softmax_in_forward"):
        assert port_b.info[key] == jax_b.info[key], key
    images = _images(n, seed=n)
    raw = port_b.predict(images)
    want_raw = jax_b.predict(images)
    (cls,), seg = raw
    (want_cls,), want_seg = want_raw
    np.testing.assert_allclose(cls, np.asarray(want_cls), rtol=0, atol=1e-4)
    for a, b in zip(seg, want_seg):
        assert a.shape == (n, SIZE, SIZE, 1) and a.dtype == np.float32
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    _assert_same_answers(port_b.postprocess(raw), jax_b.postprocess(want_raw), probs_atol=1e-4)


def test_checkpoint_backend_loads_artifact_weights(artifact):
    """``CheckpointBackend(checkpoint=weights.npz)`` serves what the artifact
    serves, and feeds the fused norm NCHW-contiguous activations (a permuted
    one-channel batch must not leave channels-last strides behind)."""
    ckpt = CheckpointBackend(_port_cfg(), "multitask", checkpoint=str(artifact / "weights.npz"),
                             size=SIZE, max_batch=4, device="cpu")
    seen = []
    for m in ckpt.model.modules():
        if isinstance(m, ConvInNormLeReLU):
            m.conv.register_forward_hook(lambda _m, _i, out: seen.append(out.is_contiguous()))
    images = _images(5, seed=11)
    got = ckpt.postprocess(ckpt.predict(images))
    assert seen and all(seen)
    art = ArtifactBackend(str(artifact), device="cpu")
    _assert_same_answers(got, art.postprocess(art.predict(images)), probs_atol=1e-6)


def test_checkpoint_backend_pads_by_wrapping_and_takes_raw_intensities():
    """A short batch is padded by repeating its images; results per image do
    not depend on the padding or chunking; inputs are raw 0-255 values."""
    backend = CheckpointBackend(_port_cfg(), "multitask", size=SIZE, max_batch=4, device="cpu")
    images = _images(5, seed=12)
    batched = backend.predict(images)
    singles = [backend.predict(images[i:i + 1]) for i in range(5)]
    np.testing.assert_allclose(batched[0][0], np.concatenate([s[0][0] for s in singles]),
                               rtol=0, atol=1e-5)
    x = torch.from_numpy(images.transpose(0, 3, 1, 2).astype(np.float32))
    with torch.inference_mode():
        (cls,), _ = backend.model(x[:1])
    np.testing.assert_allclose(singles[0][0][0], cls.numpy(), rtol=0, atol=1e-5)


def test_bf16_artifact_backend_matches_jax(artifact, tmp_path):
    """A JAX artifact exported with ``compute_dtype: bfloat16`` is served in
    bf16 by the port, against JAX's own backend on the same artifact:
    probabilities within 2e-2 (a bf16 forward of two frameworks, whose
    convolutions and norms round at other places; measured 2.6e-3), classes
    equal, masks by at most 1 % of the pixels (measured 35 of 4,096; they
    sit at the threshold)."""
    cfg = JaxConfig(model=JaxModelConfig(architecture="MTnnUNet", nnunet_widths=WIDTHS),
                    data=JaxDataConfig(input_img="unused", classes=CLASSES))
    cfg.training.compute_dtype = "bfloat16"
    bf16 = export_inference(cfg, "multitask", None, tmp_path / "bf16", buckets=(4,),
                            size=SIZE, platforms=("cpu",))
    jax_b, port_b = JaxArtifactBackend(str(bf16)), ArtifactBackend(str(bf16), device="cpu")
    assert port_b.info["device_postprocess"] is False
    images = _images(6, seed=6)
    got, want = port_b.postprocess(port_b.predict(images)), jax_b.postprocess(jax_b.predict(images))
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=2e-2)
    assert got.pred_class == want.pred_class
    assert (got.masks != want.masks).sum(axis=(1, 2)).max() <= 0.01 * SIZE * SIZE


def test_unported_options_raise(artifact, tmp_path):
    # flax-msgpack checkpoints are read now (tests/test_torch_checkpoint_msgpack.py);
    # a file that is neither format, or none at all, is refused
    (tmp_path / "ckpt_fold_0").write_bytes(b"\x00not a checkpoint")
    with pytest.raises(ValueError, match="neither a torch.save checkpoint nor a flax-msgpack"):
        CheckpointBackend(_port_cfg(), "multitask", checkpoint=str(tmp_path / "ckpt_fold_0"),
                          device="cpu")
    with pytest.raises(ValueError, match="No checkpoint found"):
        CheckpointBackend(_port_cfg(), "multitask", checkpoint=str(tmp_path / "absent"),
                          device="cpu")
    # ResidualUNet is served in eval mode: an answer moves none of its batch
    # statistics
    cfg = Config(model=ModelConfig(architecture="ResidualUNet", width=4),
                 data=DataConfig(input_img="unused", classes=CLASSES))
    backend = CheckpointBackend(cfg, "segmentation", size=SIZE, device="cpu")
    stats = {k: v.clone() for k, v in backend.model.named_buffers()}
    out = backend.predict(np.zeros((2, SIZE, SIZE, 1), np.uint8))
    assert out.shape == (2, SIZE, SIZE, 1) and not backend.model.training
    assert all(torch.equal(v, dict(backend.model.named_buffers())[k]) for k, v in stats.items())


def test_checkpoint_backend_serves_a_training_checkpoint(tmp_path):
    """``CheckpointBackend`` reads a checkpoint of the port's driver and
    answers what the trained model answers (classification too, where the
    backend builds an ``nnUNetClassifier``)."""
    images = np.random.default_rng(1).integers(0, 256, (3, 32, 32, 1), dtype=np.uint8)
    x = torch.from_numpy(images.transpose(0, 3, 1, 2).astype(np.float32))
    for task, arch in (("multitask", "MTnnUNet"), ("classification", "nnUNetClassifier")):
        cfg = Config(model=ModelConfig(architecture=arch, nnunet_widths=WIDTHS),
                     data=DataConfig(input_img="unused"))
        build = registry.init_multitask_model if task == "multitask" \
            else registry.init_classification_model
        model = build(arch, nnunet_widths=WIDTHS,
                      generator=torch.Generator().manual_seed(5))
        engine = Engine(model, EngineConfig(task=task, use_transforms=False), device="cpu")
        state = create_train_state(engine.model, "Adam", 1e-3)
        path = str(tmp_path / f"model_20260101_000000_fold_0_{task}")
        save_checkpoint(path, state, 0, 1.0)
        backend = CheckpointBackend(cfg, task, checkpoint=path, size=32, max_batch=4,
                                    device="cpu")
        with torch.no_grad():
            want = model.eval()(x)
        got = backend.predict(images)
        if task == "multitask":
            np.testing.assert_allclose(got[0][0], want[0][0].numpy(), rtol=0, atol=1e-5)
            np.testing.assert_allclose(got[1][-1][..., 0], want[1][-1][:, 0].numpy(),
                                       rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)
            assert backend.info["softmax_in_forward"]
            np.testing.assert_allclose(got.sum(-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(SIZE, SIZE), (100, 80), (37, 129)])
def test_prepare_image_matches_jax(shape):
    gray = np.random.default_rng(shape[0]).integers(0, 256, shape, dtype=np.uint8)
    got = prepare_image(gray, SIZE, {"CLAHE": False})
    assert got.dtype == np.uint8 and got.shape == (SIZE, SIZE, 1)
    np.testing.assert_array_equal(got, jax_prepare_image(gray, SIZE, {"CLAHE": False}))


def _post(url: str, body: bytes, headers: dict) -> dict:
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def test_http_round_trip():
    """``/predict`` with one raw plane and ``/predict_batch`` with an .npy
    body through the port's server answer what the backend answers directly."""
    backend = CheckpointBackend(_port_cfg(), "multitask", size=SIZE, max_batch=4, device="cpu")
    images = _images(3, seed=13)
    direct = backend.postprocess(backend.predict(images))
    octet = {"Content-Type": "application/octet-stream"}
    with InferenceServer(backend, max_batch=4, batch_wait_ms=1) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        health = json.loads(urllib.request.urlopen(base + "/healthz", timeout=30).read())
        assert health["model"]["backend"] == "checkpoint"
        assert health["model"]["device"] == "cpu"

        one = _post(base + "/predict?mask=1", images[0, ..., 0].tobytes(), octet)
        buf = io.BytesIO()
        np.save(buf, images[..., 0])
        many = _post(base + "/predict_batch", buf.getvalue(), octet)

        with pytest.raises(urllib.error.HTTPError) as exc:  # 2 planes, no count
            _post(base + "/predict_batch", images[:2, ..., 0].tobytes(), octet)
        assert exc.value.code == 400

    assert "mask_b64" in one
    assert many["count"] == 3
    for rec, i in [(one, 0)] + [(r, i) for i, r in enumerate(many["predictions"])]:
        want = direct.record(i)
        np.testing.assert_allclose(rec["probs"], want["probs"], rtol=0, atol=1e-6)
        assert abs(sum(rec["probs"]) - 1) < 1e-5
        assert rec["predicted_class"] == want["predicted_class"]
        assert rec["tumor_pixels"] == want["tumor_pixels"]
