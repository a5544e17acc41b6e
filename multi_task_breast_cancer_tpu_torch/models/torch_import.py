"""Import the reference's own PyTorch checkpoints (twin of
``multi_task_breast_cancer_tpu/models/torch_import.py``), for every custom
reference architecture: BTSUNet, FSBBTSUNet, nnUNet, ResidualUNet,
BTSUNetClassifier, nnUNetClassifier, MTnnUNet, Multi_BTSUNet,
Multi_FSB_BTSUNet and Adityan.

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
live model's storage). One exception: a ``Linear`` after the reference's
``Flatten`` of a (B, C, H, W) map (the BTS classification heads) reads its
input in (c, h, w) order, the port's ``MLPHead`` flattens in JAX's (h, w, c)
order (``blocks.flatten_hwc``), so that weight's input axis is permuted, as
JAX's ``_dense_after_flatten`` does; ``width`` (the config's
``model.width``) gives its channel count. ``tests/test_torch_import.py``
holds the port's result equal, tensor for tensor, to ``params_from_jax`` of
the JAX conversion.

nnUNetClassifier's decoders 4..1 are dead code in the reference's forward
(``nnUNet_classifier.py:106-109``) and are dropped, as are ResidualUNet's
``decoder.conv1-3`` (never called by its forward) and its BatchNorms'
``num_batches_tracked`` (flax keeps no such count). A ``BatchNorm2d``'s
``weight``, ``bias``, ``running_mean`` and ``running_var`` become the port's
``scale``, ``bias`` and buffers ``mean``, ``var``. The MONAI factory models
(UNet++ family among them) have no reference source to map from.
"""

from __future__ import annotations

import argparse
import logging
import math
from typing import Callable, Dict, Iterator, Mapping, Tuple

import torch

from multi_task_breast_cancer_tpu_torch.config import load_config
from multi_task_breast_cancer_tpu_torch.device import resolve_device
from multi_task_breast_cancer_tpu_torch.train.checkpoint import check_fits, save_checkpoint
from multi_task_breast_cancer_tpu_torch.train.driver import build_inference_state

# (port name, reference name[, a function of the reference's tensor])
Pairs = Iterator[Tuple]

def _t(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def _hwc_inputs(channels: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """A ``Linear`` weight (O, C·H·W) read after a flatten of (C, H, W), in
    the (h, w, c) input order of ``MLPHead`` (square H = W, inferred)."""
    def permute(w: torch.Tensor) -> torch.Tensor:
        hw = w.shape[1] // channels
        side = math.isqrt(hw)
        if side * side * channels != w.shape[1]:
            raise ValueError(f"cannot split a flattened input of {w.shape[1]} features "
                             f"into {channels} channels of a square map")
        return (w.reshape(-1, channels, side, side).permute(0, 2, 3, 1)
                .reshape(w.shape[0], -1).contiguous())
    return permute


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


def _map_nnunet(**_) -> Pairs:
    yield from _nnunet_backbone("backbone.")
    yield from _nnunet_seg_heads()


def _map_mtnnunet(**_) -> Pairs:
    yield from _map_nnunet()
    yield from _nnunet_cls_head()


def _map_nnunet_classifier(**_) -> Pairs:
    for i in range(1, 6):
        yield from _levelblock(f"encoder{i}", f"encoder{i}")
    yield from _levelblock("bottleneck", "bottleneck")
    yield from _layer("upsample5", "upsample5")
    yield from _levelblock("decoder5", "decoder5")
    yield from _nnunet_cls_head()


def _bts_trunk(port: str, fsb: bool = False) -> Pairs:
    for name in ("encoder1", "encoder2", "encoder3", "encoder4",
                 "bottleneck", "decoder3", "decoder2", "decoder1"):
        yield from _levelblock(port + name, name)
    yield from _cinl(port + "bottleneck2", "bottleneck2")
    if fsb:
        for name in ("npl1", "npl2", "npl3", "npl4"):
            yield from _levelblock(port + name, name)


def _bts_seg_heads(deep_supervision: bool, fsb: bool = False) -> Pairs:
    yield from _layer("output1", "output1")
    if deep_supervision:
        yield from _deconv_head("output3", "output3")
        yield from _deconv_head("output2", "output2")
        if fsb:
            for name in ("input1", "out_npl1", "out_npl2", "out_npl3", "out_npl4"):
                yield from _layer(name, f"{name}.0")


def _flattened_mlp(port: str, channels: int) -> Pairs:
    """The reference's ``classifier`` Sequential (Flatten, Linear, ReLU,
    Linear) → ``MLPHead``."""
    permute = _hwc_inputs(channels)
    yield f"{port}.fc1.weight", "classifier.1.weight", permute
    yield f"{port}.fc1.bias", "classifier.1.bias"
    yield from _layer(f"{port}.fc2", "classifier.3")


def _bts_cls_head(width: int) -> Pairs:
    yield from _cinl("cls_head.process_bottleneck2", "process_bottleneck2")
    yield from _cinl("cls_head.process_features_map", "process_features_map")
    yield from _flattened_mlp("cls_head.classifier", 8 * width)


def _map_btsunet(*, deep_supervision=False, **_) -> Pairs:
    yield from _bts_trunk("")
    yield from _bts_seg_heads(deep_supervision)


def _map_fsb(*, deep_supervision=False, **_) -> Pairs:
    yield from _bts_trunk("", fsb=True)
    yield from _bts_seg_heads(deep_supervision, fsb=True)


def _map_bts_classifier(*, width=24, **_) -> Pairs:
    for i in range(5):
        yield from _levelblock(f"enc{i + 1}", f"encoder.{2 * i}")
    yield from _flattened_mlp("classifier", 8 * width)


def _map_multi_bts(*, deep_supervision=False, width=24, **_) -> Pairs:
    yield from _bts_trunk("trunk.")
    yield from _bts_cls_head(width)
    yield from _bts_seg_heads(deep_supervision)


def _map_multi_fsb(*, deep_supervision=False, width=24, **_) -> Pairs:
    yield from _bts_trunk("trunk.", fsb=True)
    yield from _bts_cls_head(width)
    yield from _bts_seg_heads(deep_supervision, fsb=True)


def _convrelu_level(port: str, ref: str) -> Pairs:
    """Adityan's level: two biased ConvReLU (``AdityanNetwork.py:19-39``)."""
    yield from _layer(f"{port}.conv1", f"{ref}.ConvRelu1.Conv")
    yield from _layer(f"{port}.conv2", f"{ref}.ConvRelu2.Conv")


def _bn(port: str, ref: str) -> Pairs:
    """``BatchNorm2d`` → :class:`~.blocks.BatchNorm` (the JAX ``_BN``'s
    ``bn``): parameters and running statistics."""
    yield f"{port}.bn.scale", f"{ref}.weight"
    yield f"{port}.bn.bias", f"{ref}.bias"
    yield f"{port}.bn.mean", f"{ref}.running_mean"
    yield f"{port}.bn.var", f"{ref}.running_var"


def _residual_block(port: str, ref: str, in_block: bool = False) -> Pairs:
    for bn in ("bn1", "bn3") if in_block else ("bn1", "bn2", "bn3"):
        yield from _bn(f"{port}.{bn}", f"{ref}.{bn}")
    for conv in ("conv1", "conv2", "conv3"):
        yield from _layer(f"{port}.{conv}", f"{ref}.{conv}")


def _map_residual_unet(**_) -> Pairs:
    yield from _residual_block("in_block", "in_block", in_block=True)
    for i in (2, 3, 4):
        yield from _residual_block(f"down_block{i}", f"encoder.down_block{i}")
    for i in (3, 2, 1):
        yield from _layer(f"upsample{i}", f"decoder.upsample{i}")
        yield from _residual_block(f"up_block{i}", f"decoder.up_block{i}")
    yield from _layer("seg_out", "out_block.conv")


def _map_adityan(**_) -> Pairs:
    for name in ("encoder1", "encoder2", "encoder3", "encoder4", "bottleneck",
                 "decoder4", "decoder3", "decoder2", "segmap", "recmap"):
        yield from _convrelu_level(name, name)
    for i in range(1, 5):
        yield from _layer(f"upsample{i}", f"upsample{i}")
    yield from _layer("seg_out", "seg_out")
    yield from _layer("rec_out", "rec_out")
    yield from _layer("cls_conv", "classmap.3.Conv")
    yield from _layer("cls_fc1", "classmap.6")
    yield from _layer("cls_fc2", "classmap.8")


_MAPPERS: Dict[str, Callable[..., Pairs]] = {
    "BTSUNet": _map_btsunet,
    "FSBBTSUNet": _map_fsb,
    "nnUNet": _map_nnunet,
    "ResidualUNet": _map_residual_unet,
    "BTSUNetClassifier": _map_bts_classifier,
    "nnUNetClassifier": _map_nnunet_classifier,
    "MTnnUNet": _map_mtnnunet,
    "Multi_BTSUNet": _map_multi_bts,
    "Multi_FSB_BTSUNet": _map_multi_fsb,
    "Adityan": _map_adityan,
}


def convert_state_dict(architecture: str, state_dict: Mapping, *,
                       deep_supervision: bool = False,
                       width: int = 24) -> Dict[str, torch.Tensor]:
    """A reference ``state_dict`` → the port's ``state_dict`` of the
    same-named architecture (float32 CPU copies; with ResidualUNet's running
    statistics). ``deep_supervision`` and
    ``width`` are the checkpoint's ``model.deep_supervision`` and
    ``model.width``: the BTS family's heads depend on the first, the
    flattened classification heads' input order on the second."""
    if architecture not in _MAPPERS:
        raise ValueError(
            f"cannot import torch weights for {architecture!r}: supported "
            f"architectures are {sorted(_MAPPERS)} (the MONAI factory models "
            f"have no custom reference source to map from)")
    out = {}
    try:
        for port, ref, *fn in _MAPPERS[architecture](deep_supervision=deep_supervision,
                                                     width=width):
            t = _t(state_dict[ref])
            out[port] = fn[0](t) if fn else t
    except KeyError as e:
        raise KeyError(
            f"state_dict key {e.args[0]!r} not found while importing "
            f"{architecture!r} (deep_supervision={deep_supervision}) — is the "
            f"checkpoint from the same architecture/configuration?") from e
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="./config.yaml",
                        help="the port's config.yaml describing the model")
    parser.add_argument("--task", default="multitask",
                        choices=["segmentation", "classification", "multitask"])
    parser.add_argument("--torch-checkpoint", required=True,
                        help="reference checkpoint (torch.save dict or raw state_dict)")
    parser.add_argument("--out", required=True, help="output checkpoint path (the port's format)")
    parser.add_argument("--size", type=int, default=128)
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
    converted = convert_state_dict(cfg.model.architecture, sd,
                                   deep_supervision=cfg.model.deep_supervision,
                                   width=cfg.model.width)
    state, _ = build_inference_state(cfg, args.task, device=device, size=args.size)
    check_fits(converted, state.model, "converted weights")
    state.model.load_state_dict(converted, strict=True)
    save_checkpoint(args.out, state, epoch=epoch, val_loss=val_loss)
    logging.info("wrote %s (epoch %d, val_loss %s): load with predict / evaluate / "
                 "load_pretrained_model", args.out, epoch, val_loss)


if __name__ == "__main__":
    main()
