"""Import the reference's own PyTorch checkpoints (twin of
``multi_task_breast_cancer_tpu/models/torch_import.py``), for the nnU-Net
family: nnUNet, MTnnUNet and nnUNetClassifier.

Users of the reference codebase (caumente/multi_task_breast_cancer) carry
their trained weights over instead of retraining: :func:`convert_state_dict`
renames a reference ``state_dict`` into the port's, and the CLI rewrites a
reference checkpoint (the ``torch.save`` dict of
``training_multitask.py:243-249``) as a checkpoint of the port, which
``predict``, ``evaluate`` and ``load_pretrained_model`` read.

    python -m multi_task_breast_cancer_tpu_torch.models.torch_import \\
        --config config.yaml --task multitask \\
        --torch-checkpoint ref_runs/.../fold_0/model_..._fold_0 \\
        --out converted/model_fold_0

Layouts. The JAX package converts each tensor to flax's layout
(``Conv2d`` OIHW → HWIO, ``ConvTranspose2d`` (I, O, kh, kw) → HWIO with the
taps flipped, ``Linear`` (O, I) → (I, O)); the port's modules keep torch's
layouts and the reference's tap order (``models/jax_weights.py`` undoes
exactly those conversions), so here only the names change and every tensor is
copied as it is, to float32 on the CPU (a copy: the result must not track a
live model's storage). ``tests/test_torch_import.py`` holds the port's result
equal, tensor for tensor, to ``params_from_jax`` of the JAX conversion.

nnUNetClassifier's decoders 4..1 are dead code in the reference's forward
(``nnUNet_classifier.py:106-109``) and are dropped. The other architectures
the JAX importer maps wait for the rest of the zoo (``ROADMAP.md``, Queue 1).
"""

from __future__ import annotations

import argparse
import logging
from typing import Callable, Dict, Iterator, Mapping, Tuple

import torch

from multi_task_breast_cancer_tpu_torch.config import load_config
from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.train.checkpoint import check_fits, save_checkpoint
from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state

Pairs = Iterator[Tuple[str, str]]  # (port name, reference name)

# the JAX importer's architectures that the port does not build yet
_ZOO = ("BTSUNet", "FSBBTSUNet", "ResidualUNet", "BTSUNetClassifier",
        "Multi_BTSUNet", "Multi_FSB_BTSUNet", "Adityan")


def _t(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _cinl(port: str, ref: str) -> Pairs:
    """ConvInNormLeReLU: one bias-free conv (InstanceNorm has no weights)."""
    yield f"{port}.conv.weight", f"{ref}.Conv.weight"


def _levelblock(port: str, ref: str) -> Pairs:
    yield from _cinl(f"{port}.block1", f"{ref}.ConvInNormLRelu1")
    yield from _cinl(f"{port}.block2", f"{ref}.ConvInNormLRelu2")


def _layer(port: str, ref: str) -> Pairs:
    """A Conv2d, ConvTranspose2d or Linear with bias."""
    yield f"{port}.weight", f"{ref}.weight"
    yield f"{port}.bias", f"{ref}.bias"


def _deconv_head(port: str, ref: str) -> Pairs:
    """torch ``Sequential(ConvTranspose2d, conv1x1)`` → ``DeconvHead``."""
    yield f"{port}.deconv_kernel", f"{ref}.0.weight"
    yield f"{port}.deconv_bias", f"{ref}.0.bias"
    yield f"{port}.conv1x1_kernel", f"{ref}.1.weight"
    yield f"{port}.conv1x1_bias", f"{ref}.1.bias"


def _nnunet_backbone(port: str) -> Pairs:
    yield from _levelblock(f"{port}bottleneck", "bottleneck")
    for i in range(1, 6):
        yield from _levelblock(f"{port}encoder{i}", f"encoder{i}")
        yield from _levelblock(f"{port}decoder{i}", f"decoder{i}")
        yield from _layer(f"{port}upsample{i}", f"upsample{i}")


def _nnunet_seg_heads() -> Pairs:
    for i in (4, 3, 2):
        yield from _deconv_head(f"heads.output{i}", f"output{i}")
    yield from _layer("heads.output1", "output1")


def _nnunet_cls_head() -> Pairs:
    yield from _cinl("cls_head.process_encoder_5", "process_encoder_5")
    yield from _cinl("cls_head.process_decoder_5", "process_decoder_5")
    yield from _cinl("cls_head.cls_conv", "classifier.0")
    yield from _layer("cls_head.fc1", "classifier.3")
    yield from _layer("cls_head.fc2", "classifier.5")


def _map_nnunet() -> Pairs:
    yield from _nnunet_backbone("backbone.")
    yield from _nnunet_seg_heads()


def _map_mtnnunet() -> Pairs:
    yield from _map_nnunet()
    yield from _nnunet_cls_head()


def _map_nnunet_classifier() -> Pairs:
    for i in range(1, 6):
        yield from _levelblock(f"encoder{i}", f"encoder{i}")
    yield from _levelblock("bottleneck", "bottleneck")
    yield from _layer("upsample5", "upsample5")
    yield from _levelblock("decoder5", "decoder5")
    yield from _nnunet_cls_head()


_MAPPERS: Dict[str, Callable[[], Pairs]] = {
    "nnUNet": _map_nnunet,
    "nnUNetClassifier": _map_nnunet_classifier,
    "MTnnUNet": _map_mtnnunet,
}


def convert_state_dict(architecture: str, state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` → the port's ``state_dict`` of the
    same-named architecture (float32 CPU copies)."""
    if architecture in _ZOO:
        raise NotImplementedError(
            f"importing reference weights for {architecture!r} waits for the "
            f"architecture itself: ROADMAP.md, Queue 1, item 2 (the rest of the zoo)")
    if architecture not in _MAPPERS:
        raise ValueError(
            f"cannot import torch weights for {architecture!r}: supported "
            f"architectures are {sorted(_MAPPERS)} (the MONAI factory models "
            f"have no custom reference source to map from)")
    try:
        return {port: _t(state_dict[ref]) for port, ref in _MAPPERS[architecture]()}
    except KeyError as e:
        raise KeyError(
            f"state_dict key {e.args[0]!r} not found while importing "
            f"{architecture!r} — is the checkpoint from the same "
            f"architecture/configuration?") from e


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="./config.yaml",
                        help="the port's config.yaml describing the model")
    parser.add_argument("--task", default="multitask",
                        choices=["segmentation", "classification", "multitask"])
    parser.add_argument("--torch-checkpoint", required=True,
                        help="reference checkpoint (torch.save dict or raw state_dict)")
    parser.add_argument("--out", required=True, help="output checkpoint path (the port's format)")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)

    # weights_only: the reference checkpoints are plain dicts of tensors and
    # scalars (training_multitask.py:243-249); a tampered pickle must not run
    ckpt = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    epoch = int(ckpt.get("epoch", 0)) if isinstance(ckpt, dict) else 0
    val_loss = float(ckpt.get("val_loss", float("inf"))) if isinstance(ckpt, dict) else float("inf")

    cfg = load_config(args.config)
    converted = convert_state_dict(cfg.model.architecture, sd)
    state, _ = build_inference_state(cfg, args.task, device=device)
    check_fits(converted, state.model, "converted weights")
    state.model.load_state_dict(converted, strict=True)
    save_checkpoint(args.out, state, epoch=epoch, val_loss=val_loss)
    logging.info("wrote %s (epoch %d, val_loss %s): load with predict / evaluate / "
                 "load_pretrained_model", args.out, epoch, val_loss)


if __name__ == "__main__":
    main()
