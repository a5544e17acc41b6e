"""Model factories of the port (twin of
``multi_task_breast_cancer_tpu/models/registry.py``).

Every architecture of the JAX registry builds. Factories return a model on
the CPU with its parameters drawn as the JAX initialisers draw them, from an
explicit ``torch.Generator`` (seed 0 when none is given). ``size`` is the
input side, which the BTS flatten heads (BTSUNetClassifier, Multi_BTSUNet,
Multi_FSB_BTSUNet), SwinUNETR's window sizes and UMambaEnc's token layouts
need; JAX infers it at ``init``.

``PORT_ONLY_SEGMENTATION_ARCHS`` are architectures the port runs and the JAX
registry has not: UMambaEnc (:mod:`.umamba`), held to the benchmark's plain
reference instead of a JAX twin.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import init_weights
from multi_task_breast_cancer_tpu_torch.models.bts_unet import BTSUNet
from multi_task_breast_cancer_tpu_torch.models.classifiers import (
    BTSUNetClassifier,
    NNUNetClassifier,
)
from multi_task_breast_cancer_tpu_torch.models.fsb_bts_unet import FSBBTSUNet
from multi_task_breast_cancer_tpu_torch.models.monai_zoo import AttentionUNet, SegResNet, UNet
from multi_task_breast_cancer_tpu_torch.models.multitask import (
    Adityan,
    MTnnUNet,
    MultiBTSUNet,
    MultiFSBBTSUNet,
)
from multi_task_breast_cancer_tpu_torch.models.nnunet import NNUNet2021
from multi_task_breast_cancer_tpu_torch.models.residual_unet import ResidualUNet
from multi_task_breast_cancer_tpu_torch.models.swin_unetr import SwinUNETR
from multi_task_breast_cancer_tpu_torch.models.umamba import UMambaEnc, init_ssm
from multi_task_breast_cancer_tpu_torch.models.unetpp import (
    BasicUNetPlusPlus,
    MTUNetPlusPlus,
    UNetPlusPlusClassifier,
)

SEGMENTATION_ARCHS = ("BTSUNet", "nnUNet", "UNet", "AttentionUNet", "ResidualUNet",
                      "UnetPlusPlus", "FSBBTSUNet", "SegResNet", "SwinUNETR")
PORT_ONLY_SEGMENTATION_ARCHS = ("UMambaEnc",)
CLASSIFICATION_ARCHS = ("BTSUNetClassifier", "UNetPlusPlusClassifier", "nnUNetClassifier")
MULTITASK_ARCHS = ("Multi_BTSUNet", "MTUNetPlusPlus", "MTnnUNet", "Multi_FSB_BTSUNet", "Adityan")

# architectures whose feature sizes are fixed (model.width is ignored; the
# nnU-Net family takes model.nnunet_widths) and whose deep supervision is
# fixed (always on for the nnU-Nets, absent elsewhere): the reference's
# factory ignores these knobs silently, the factories here warn
_WIDTH_IGNORED = {"nnUNet", "UnetPlusPlus", "SegResNet", "SwinUNETR", "UMambaEnc",
                  "UNetPlusPlusClassifier", "nnUNetClassifier",
                  "MTUNetPlusPlus", "MTnnUNet"}
_DS_FIXED = {"UNet": False, "AttentionUNet": False, "ResidualUNet": False,
             "SegResNet": False, "SwinUNETR": False, "UMambaEnc": False,
             "nnUNet": True, "MTnnUNet": True, "Adityan": False}

# not a deliberate override: None (the knob was not passed) and the
# ModelConfig default, which the driver always forwards
_DEFAULT_WIDTH = 24
_FACTORY_WIDTH = 48  # the width when the factory is called without one


def count_parameters(model: nn.Module) -> int:
    """Number of trainable parameters."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


def save_model_summary(model: nn.Module, save_folder: Optional[Path]) -> None:
    """The module tree and the parameter count, to ``model.txt`` in the run
    dir (the reference prints its torch module there,
    ``experiment_init.py:75-78``)."""
    if save_folder is None:
        return
    save_folder = Path(save_folder)
    save_folder.mkdir(parents=True, exist_ok=True)
    with (save_folder / "model.txt").open("w") as f:
        print(model, file=f)
        print(f"\nTotal number of trainable parameters: {count_parameters(model)}", file=f)


def _unknown(kind: str, architecture: str, known) -> Exception:
    return ValueError(f"Unknown {kind} architecture {architecture!r}. "
                      f"Available: {known}")


def _warn_ignored_knobs(architecture: str, width=None, deep_supervision=None) -> None:
    if width not in (None, _DEFAULT_WIDTH) and architecture in _WIDTH_IGNORED:
        logging.warning(
            "model.width=%s is ignored by %s (fixed feature sizes%s)",
            width, architecture,
            "; use model.nnunet_widths" if "nnUNet" in architecture else "")
    fixed = _DS_FIXED.get(architecture)
    if deep_supervision is not None and fixed is not None and deep_supervision != fixed:
        logging.warning(
            "model.deep_supervision=%s is ignored by %s (deep supervision "
            "is %s for this architecture)", deep_supervision, architecture,
            "always on" if fixed else "not available")


def _reject_nnunet_widths(architecture: str, nnunet_widths) -> None:
    """``model.nnunet_widths`` applies to the nnU-Net family only: training
    another architecture at its default widths would hide a config mistake."""
    if nnunet_widths is not None:
        raise ValueError(
            f"model.nnunet_widths is only valid for the nnU-Net family "
            f"(nnUNet / nnUNetClassifier / MTnnUNet), not {architecture!r}; "
            f"use model.width for this architecture")


def _nnunet_kw(nnunet_widths) -> dict:
    if nnunet_widths is None:
        return {}
    widths = tuple(int(w) for w in nnunet_widths)
    if len(widths) != 5:
        raise ValueError(
            f"model.nnunet_widths must list the 5 level widths "
            f"(reference default (32, 64, 128, 256, 320)); got {widths!r}")
    return {"widths": widths}


def _knobs(architecture: str, nnunet_family: tuple, width, deep_supervision,
           nnunet_widths) -> tuple:
    """Warn about knobs the architecture ignores, refuse nnU-Net widths
    elsewhere; the width and deep supervision the model is built with."""
    _warn_ignored_knobs(architecture, width, deep_supervision)
    if architecture not in nnunet_family:
        _reject_nnunet_widths(architecture, nnunet_widths)
    return (_FACTORY_WIDTH if width is None else width,
            False if deep_supervision is None else deep_supervision)


def _seeded(model: nn.Module, generator: Optional[torch.Generator]) -> nn.Module:
    return init_weights(model, generator or torch.Generator().manual_seed(0))


def init_segmentation_model(architecture: str, sequences: int = 1, regions: int = 1,
                            width: Optional[int] = None,
                            deep_supervision: Optional[bool] = None,
                            nnunet_widths=None, size: int = 128,
                            generator: Optional[torch.Generator] = None) -> nn.Module:
    """``nnUNet`` always has 4-head deep supervision (``deep_supervision`` is
    ignored, as in JAX). UNet and AttentionUNet take channels (w, 2w, 4w,
    8w); SegResNet (8 initial filters) and SwinUNETR (feature size 24) have
    fixed widths. UMambaEnc takes one width a stage in ``nnunet_widths``
    (default the planner's (32, 64, 128, 256, 512, 512)) and has no deep
    supervision."""
    logging.info("Creating %s model (fed with %d sequences)", architecture, sequences)
    width, ds = _knobs(architecture, ("nnUNet", "UMambaEnc"), width, deep_supervision,
                       nnunet_widths)
    if architecture == "BTSUNet":
        model = BTSUNet(sequences, regions, width, ds)
    elif architecture == "FSBBTSUNet":
        model = FSBBTSUNet(sequences, regions, width, ds)
    elif architecture == "UnetPlusPlus":
        model = BasicUNetPlusPlus(sequences, regions, deep_supervision=ds)
    elif architecture == "nnUNet":
        model = NNUNet2021(sequences, regions, **_nnunet_kw(nnunet_widths))
    elif architecture in ("UNet", "AttentionUNet"):
        channels = (width, 2 * width, 4 * width, 8 * width)
        model = (UNet if architecture == "UNet" else AttentionUNet)(sequences, regions, channels)
    elif architecture == "ResidualUNet":
        model = ResidualUNet(sequences, regions, width)
    elif architecture == "SegResNet":
        model = SegResNet(sequences, regions)
    elif architecture == "SwinUNETR":
        model = SwinUNETR(sequences, regions, size=size)
    elif architecture == "UMambaEnc":
        generator = generator or torch.Generator().manual_seed(0)
        kw = {} if nnunet_widths is None else {"widths": nnunet_widths}
        return init_ssm(_seeded(UMambaEnc(sequences, regions, size=size, **kw), generator),
                        generator)
    else:
        raise _unknown("segmentation", architecture,
                       SEGMENTATION_ARCHS + PORT_ONLY_SEGMENTATION_ARCHS)
    return _seeded(model, generator)


def init_multitask_model(architecture: str, sequences: int = 1, regions: int = 1,
                         n_classes: int = 3, width: Optional[int] = None,
                         deep_supervision: Optional[bool] = None,
                         nnunet_widths=None, size: int = 128,
                         generator: Optional[torch.Generator] = None) -> nn.Module:
    """``MTnnUNet`` always has 4-head deep supervision; ``Multi_FSB_BTSUNet``
    (1 logit) and ``Adityan`` (3 logits) ignore ``n_classes``, as in JAX."""
    logging.info("Creating %s model (fed with %d sequences)", architecture, sequences)
    width, ds = _knobs(architecture, ("MTnnUNet",), width, deep_supervision, nnunet_widths)
    if architecture == "Multi_BTSUNet":
        model = MultiBTSUNet(sequences, regions, n_classes, width, ds, size)
    elif architecture == "MTUNetPlusPlus":
        model = MTUNetPlusPlus(sequences, regions, n_classes, deep_supervision=ds)
    elif architecture == "MTnnUNet":
        model = MTnnUNet(sequences, regions, n_classes, **_nnunet_kw(nnunet_widths))
    elif architecture == "Multi_FSB_BTSUNet":
        model = MultiFSBBTSUNet(sequences, regions, width, ds, size)
    elif architecture == "Adityan":
        model = Adityan(sequences, regions, width)
    else:
        raise _unknown("multitask", architecture, MULTITASK_ARCHS)
    return _seeded(model, generator)


def init_classification_model(architecture: str, sequences: int = 1, n_classes: int = 3,
                              width: Optional[int] = None, nnunet_widths=None,
                              size: int = 128,
                              generator: Optional[torch.Generator] = None) -> nn.Module:
    """``nnUNetClassifier`` applies softmax in its forward when multiclass,
    as the reference's does."""
    logging.info("Creating %s model (fed with %d sequences)", architecture, sequences)
    width, _ = _knobs(architecture, ("nnUNetClassifier",), width, None, nnunet_widths)
    if architecture == "BTSUNetClassifier":
        model = BTSUNetClassifier(sequences, n_classes, width, size)
    elif architecture == "UNetPlusPlusClassifier":
        model = UNetPlusPlusClassifier(sequences, n_classes)
    elif architecture == "nnUNetClassifier":
        model = NNUNetClassifier(sequences, n_classes, **_nnunet_kw(nnunet_widths))
    else:
        raise _unknown("classification", architecture, CLASSIFICATION_ARCHS)
    return _seeded(model, generator)
