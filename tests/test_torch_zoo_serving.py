"""Serving the zoo on the CPU: the port's backends and artifacts for the BTS
family and the UNet++ family, at narrow widths and 32².

- ``ArtifactBackend`` over the JAX package's ``serve export`` artifact of a
  deep-supervised Multi_BTSUNet (width 4): the JAX manifest records neither
  the width nor the deep supervision, so the port reads both from
  ``weights.npz``; raw outputs against the JAX backend's to 1e-4 absolute
  (f32 forwards of two frameworks, as ``tests/test_torch_serving.py``),
  postprocessed answers equal.
- ``CheckpointBackend`` over the port's checkpoint of BTSUNetClassifier
  (its flatten head fixes the input side): the answer of the model with the
  checkpoint's weights at the backend's batch, exactly (same CPU code and
  input).
- ``serve export`` of the port's MTUNetPlusPlus: no fused-norm node in its
  programs (the UNet++ blocks run plain PyTorch), the program's answer the
  live model's to 1e-5 of scale, as ``tests/test_torch_export.py`` holds
  MTnnUNet's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.config import (
    Config as JaxConfig,
    DataConfig as JaxDataConfig,
    ModelConfig as JaxModelConfig,
)
from multi_task_breast_cancer_tpu.serve.export import export_inference as jax_export
from multi_task_breast_cancer_tpu.serve.server import ArtifactBackend as JaxArtifactBackend
from multi_task_breast_cancer_tpu_torch.config import Config, DataConfig, ModelConfig
from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.serve import export as E
from multi_task_breast_cancer_tpu_torch.serve.server import ArtifactBackend, CheckpointBackend
from multi_task_breast_cancer_tpu_torch.train.checkpoint import save_checkpoint
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from multi_task_breast_cancer_tpu_torch.utils.trees import tree_map
from test_torch_driver import one_torch_thread  # noqa: F401  (a fixture)

SIZE = 32
WIDTH = 4
CLASSES = ["benign", "malignant", "normal"]


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)


def _leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [np.asarray(out)]


def _nchw(images: np.ndarray) -> torch.Tensor:
    """NCHW strides, as the backends lay their input out: a permuted
    one-channel batch passes for contiguous with channels-last strides, and
    the convolutions would then run another algorithm."""
    return torch.from_numpy(images.astype(np.float32)).permute(0, 3, 1, 2).clone(
        memory_format=torch.contiguous_format)


def _cfg(arch: str, **model) -> Config:
    return Config(model=ModelConfig(architecture=arch, width=WIDTH, **model),
                  data=DataConfig(input_img="unused", classes=CLASSES))


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX package's artifact of a freshly initialised Multi_BTSUNet."""
    cfg = JaxConfig(model=JaxModelConfig(architecture="Multi_BTSUNet", width=WIDTH,
                                         deep_supervision=True),
                    data=JaxDataConfig(input_img="unused", classes=CLASSES))
    return jax_export(cfg, "multitask", None, tmp_path_factory.mktemp("zoo") / "artifact",
                      buckets=(4,), size=SIZE, platforms=("cpu",))


@pytest.mark.parametrize("n", [3, 6])  # pads into the B=4 bucket / chunks by it
def test_artifact_backend_serves_a_jax_multi_btsunet_artifact(jax_artifact, n):
    artifact = jax_artifact
    jax_b = JaxArtifactBackend(str(artifact))
    port_b = ArtifactBackend(str(artifact), device="cpu")
    model = port_b._runner.model
    assert model.deep_supervision and model.trunk.encoder1.block2.conv.out_channels == WIDTH
    images = _images(n, seed=n)
    raw, want = port_b.predict(images), jax_b.predict(images)
    (cls,), seg = raw
    assert len(seg) == 3
    for a, b in zip(_leaves(raw), _leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    got, exp = port_b.postprocess(raw), jax_b.postprocess(want)
    np.testing.assert_allclose(got.probs, exp.probs, rtol=0, atol=1e-4)
    assert got.pred_class == exp.pred_class
    np.testing.assert_array_equal(got.masks, exp.masks)


def test_checkpoint_backend_serves_a_bts_classifier_checkpoint(tmp_path):
    model = registry.init_classification_model("BTSUNetClassifier", width=WIDTH, size=SIZE,
                                               generator=torch.Generator().manual_seed(4))
    ckpt = tmp_path / "model_fold_0"
    save_checkpoint(str(ckpt), create_train_state(model, "Adam", 1e-4), epoch=1, val_loss=0.5)
    backend = CheckpointBackend(_cfg("BTSUNetClassifier"), "classification",
                                checkpoint=str(ckpt), size=SIZE, max_batch=4, device="cpu")
    images = _images(4, seed=2)  # the backend's batch: the same convolutions
    got = backend.predict(images)
    with torch.inference_mode():
        x = _nchw(images)
        want = model.eval()(x).numpy()
    assert got.shape == (4, 3)
    np.testing.assert_array_equal(got, want)
    answer = backend.postprocess(got)
    assert backend.info["softmax_in_forward"] is False
    np.testing.assert_allclose(answer.probs.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="shape mismatch"):  # a checkpoint of 32² at 128²
        CheckpointBackend(_cfg("BTSUNetClassifier"), "classification", checkpoint=str(ckpt),
                          device="cpu")


def test_serve_export_of_mtunetplusplus(tmp_path):
    model = registry.init_multitask_model("MTUNetPlusPlus", deep_supervision=True,
                                          generator=torch.Generator().manual_seed(6))
    ckpt = tmp_path / "model_fold_0"
    save_checkpoint(str(ckpt), create_train_state(model, "Adam", 1e-4), epoch=1, val_loss=0.5)
    cfg = _cfg("MTUNetPlusPlus", deep_supervision=True)
    art = E.export_inference(cfg, "multitask", ckpt, tmp_path / "art", buckets=(2,), size=SIZE,
                             platforms=("cpu",))
    program = torch.export.load(art / E.program_name(2, "cpu"))
    assert len(program.state_dict) == 0
    assert not [n for n in program.graph.nodes
                if n.op == "call_function" and "mtbc_torch" in str(n.target)]
    images = _images(3, seed=5)
    got = E.ExportedModel(art, device="cpu").predict(images)
    x = _nchw(images)
    with torch.inference_mode():
        want = tree_map(lambda t: t.permute(0, 2, 3, 1).numpy() if t.dim() == 4 else t.numpy(),
                        model.eval()(x))
    (cls,), seg = got
    assert cls.shape == (3, 3) and len(seg) == 4
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
