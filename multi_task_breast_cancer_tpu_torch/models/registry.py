"""Model factories of the port (twin of
``multi_task_breast_cancer_tpu/models/registry.py``).

The port has the nnU-Net family: ``MTnnUNet``, ``nnUNet`` and
``nnUNetClassifier``; every other architecture of the JAX zoo raises
``NotImplementedError``. Factories return
a model on the CPU with its parameters drawn as the JAX initialisers draw
them, from an explicit ``torch.Generator`` (seed 0 when none is given).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import init_weights
from multi_task_breast_cancer_tpu_torch.models.classifiers import NNUNetClassifier
from multi_task_breast_cancer_tpu_torch.models.multitask import MTnnUNet
from multi_task_breast_cancer_tpu_torch.models.nnunet import NNUNet2021

SEGMENTATION_ARCHS = ("BTSUNet", "nnUNet", "UNet", "AttentionUNet", "ResidualUNet",
                      "UnetPlusPlus", "FSBBTSUNet", "SegResNet", "SwinUNETR")
CLASSIFICATION_ARCHS = ("BTSUNetClassifier", "UNetPlusPlusClassifier", "nnUNetClassifier")
MULTITASK_ARCHS = ("Multi_BTSUNet", "MTUNetPlusPlus", "MTnnUNet", "Multi_FSB_BTSUNet", "Adityan")

_DEFAULT_WIDTH = 24  # ModelConfig.width: an untouched config forwards it


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


def _not_ported(kind: str, architecture: str, known) -> Exception:
    if architecture in known:
        return NotImplementedError(
            f"{kind} architecture {architecture!r} is not ported to PyTorch yet: "
            f"it is in ROADMAP.md, Queue 1, item 2 (the rest of the zoo)")
    return ValueError(f"Unknown {kind} architecture {architecture!r}. "
                      f"Available: {known}")


def _nnunet_widths(architecture: str, width, nnunet_widths) -> dict:
    if width not in (None, _DEFAULT_WIDTH):
        logging.warning("model.width=%s is ignored by %s (fixed feature sizes; "
                        "use model.nnunet_widths)", width, architecture)
    if nnunet_widths is None:
        return {}
    widths = tuple(int(w) for w in nnunet_widths)
    if len(widths) != 5:
        raise ValueError(
            f"model.nnunet_widths must list the 5 level widths "
            f"(reference default (32, 64, 128, 256, 320)); got {widths!r}")
    return {"widths": widths}


def init_segmentation_model(architecture: str, sequences: int = 1, regions: int = 1,
                            width: Optional[int] = None,
                            deep_supervision: Optional[bool] = None,
                            nnunet_widths=None,
                            generator: Optional[torch.Generator] = None) -> nn.Module:
    """``nnUNet`` (always 4-head deep supervision; ``deep_supervision`` is
    ignored, as in JAX)."""
    if architecture != "nnUNet":
        raise _not_ported("segmentation", architecture, SEGMENTATION_ARCHS)
    model = NNUNet2021(sequences, regions, **_nnunet_widths(architecture, width, nnunet_widths))
    return init_weights(model, generator or torch.Generator().manual_seed(0))


def init_multitask_model(architecture: str, sequences: int = 1, regions: int = 1,
                         n_classes: int = 3, width: Optional[int] = None,
                         deep_supervision: Optional[bool] = None,
                         nnunet_widths=None,
                         generator: Optional[torch.Generator] = None) -> nn.Module:
    """``MTnnUNet`` (always 4-head deep supervision)."""
    if architecture != "MTnnUNet":
        raise _not_ported("multitask", architecture, MULTITASK_ARCHS)
    model = MTnnUNet(sequences, regions, n_classes,
                     **_nnunet_widths(architecture, width, nnunet_widths))
    return init_weights(model, generator or torch.Generator().manual_seed(0))


def init_classification_model(architecture: str, sequences: int = 1, n_classes: int = 3,
                              width: Optional[int] = None, nnunet_widths=None,
                              generator: Optional[torch.Generator] = None) -> nn.Module:
    """``nnUNetClassifier`` (softmax in the forward when multiclass, as the
    reference's)."""
    if architecture != "nnUNetClassifier":
        raise _not_ported("classification", architecture, CLASSIFICATION_ARCHS)
    model = NNUNetClassifier(sequences, n_classes,
                             **_nnunet_widths(architecture, width, nnunet_widths))
    return init_weights(model, generator or torch.Generator().manual_seed(0))
