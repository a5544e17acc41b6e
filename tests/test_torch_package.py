"""Package rules of the PyTorch port: it imports neither JAX, flax, msgpack,
sklearn nor the JAX package, its entry points run on CUDA unless the CPU is asked
for, float32 on the card means float32 (TF32 off), and its copy of the config
loads a YAML exactly as the JAX package's does."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import multi_task_breast_cancer_tpu.config as jax_config
import multi_task_breast_cancer_tpu_torch.config as port_config
from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.serve.server import ArtifactBackend, CheckpointBackend

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Every module of the port, imported in a fresh interpreter (this one has
    JAX loaded by ``conftest.py``)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_task_breast_cancer_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'sklearn', 'msgpack',\n"
        "              'multi_task_breast_cancer_tpu'))\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 65  # every module was walked: the driver's, the tools', the zoo's
    tools = {"predict", "evaluate", "native", "data.holdout_check", "data.preprocessing",
             "data.ssim", "models.torch_import", "train.flax_msgpack", "serve.export",
             "models.bts_unet", "models.fsb_bts_unet", "models.unetpp",
             "models.residual_unet", "models.monai_zoo", "models.swin_unetr",
             "parallel", "parallel.mesh", "parallel.multihost", "parallel.spatial",
             "graphs", "ops.launches"}
    assert {f"multi_task_breast_cancer_tpu_torch.{m}" for m in tools} <= names


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(device)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointBackend(port_config.Config(), "multitask")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ArtifactBackend(str(tmp_path))


def test_engine_on_cuda_turns_tf32_off(monkeypatch):
    """An Engine built for the card with ``compute_dtype: float32`` computes
    convolutions and matmuls in float32, whoever built it (the driver, a
    script), not only under the smoke's global switches."""
    from torch import nn

    from multi_task_breast_cancer_tpu_torch.train import loop

    class _Stub(nn.Linear):
        def to(self, *args, **kwargs):  # stays on the CPU
            return self

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(loop, "resolve_device", lambda device: torch.device("cuda", 0))
    engine = loop.Engine(_Stub(1, 1), loop.EngineConfig(task="segmentation"))
    assert engine.device.type == "cuda"
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_serve_cli_requires_a_model(monkeypatch):
    from multi_task_breast_cancer_tpu_torch.serve.__main__ import main
    monkeypatch.setattr(sys, "argv", ["serve", "run", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--artifact or --checkpoint"):
        main()


@pytest.mark.parametrize("text", [
    jax_config.DEFAULT_CONFIG_YAML,
    "model: {architecture: MTnnUNet, nnunet_widths: [4, 8, 8, 16, 16], bogus: 1}\n"
    "training: {compute_dtype: bfloat16, seed: 7}\n"
    "data: {classes: [benign, malignant], augmentation: {CLAHE: True}}\n",
])
def test_config_copy_loads_yaml_identically(tmp_path, text):
    path = tmp_path / "config.yaml"
    path.write_text(text)
    assert dataclasses.asdict(port_config.load_config(path)) == \
        dataclasses.asdict(jax_config.load_config(path))
    assert port_config.config_to_yaml(port_config.load_config(path)) == \
        jax_config.config_to_yaml(jax_config.load_config(path))
