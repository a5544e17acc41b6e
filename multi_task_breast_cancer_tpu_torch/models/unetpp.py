"""UNet++ family on MONAI ``basic_unet``-equivalent blocks (PyTorch, NCHW):
segmentation ``BasicUNetPlusPlus``, ``UNetPlusPlusClassifier`` and the
multitask ``MTUNetPlusPlus`` over a shared nested encoder. Twins of
``multi_task_breast_cancer_tpu/models/unetpp.py``.

The blocks (biased conv → affine InstanceNorm → LeakyReLU(0.1)) run as
plain PyTorch: the JAX models reach no Pallas kernel either. The reference's
quirk stays: the classification head applies the *same* ``process_level_3``
Down block to both ``x_3_0`` and ``x_3_1`` (shared weights on two tensors).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    Down,
    TwoConv,
    UpCat,
    conv1x1,
    global_avg_pool,
)

# the reference's multitask / classifier widths and the MONAI defaults of the
# plain segmentation factory
MT_FEATURES = (24, 48, 96, 192, 384, 24)
MONAI_DEFAULT_FEATURES = (32, 32, 64, 128, 256, 32)


class UNetPlusPlusNest(nn.Module):
    """The full nested UNet++ topology; returns every ``x_i_j`` a head reads."""

    def __init__(self, in_features: int = 1, features: Sequence[int] = MT_FEATURES,
                 dropout: float = 0.0):
        super().__init__()
        f, d = tuple(features), dropout
        self.conv_0_0 = TwoConv(in_features, f[0], d)
        self.conv_1_0 = Down(f[0], f[1], d)
        self.upcat_0_1 = UpCat(f[1], f[0], f[0], halves=False, dropout=d)
        self.conv_2_0 = Down(f[1], f[2], d)
        self.upcat_1_1 = UpCat(f[2], f[1], f[1], dropout=d)
        self.upcat_0_2 = UpCat(f[1], 2 * f[0], f[0], halves=False, dropout=d)
        self.conv_3_0 = Down(f[2], f[3], d)
        self.upcat_2_1 = UpCat(f[3], f[2], f[2], dropout=d)
        self.upcat_1_2 = UpCat(f[2], 2 * f[1], f[1], dropout=d)
        self.upcat_0_3 = UpCat(f[1], 3 * f[0], f[0], halves=False, dropout=d)
        self.conv_4_0 = Down(f[3], f[4], d)
        self.upcat_3_1 = UpCat(f[4], f[3], f[3], dropout=d)
        self.upcat_2_2 = UpCat(f[3], 2 * f[2], f[2], dropout=d)
        self.upcat_1_3 = UpCat(f[2], 3 * f[1], f[1], dropout=d)
        self.upcat_0_4 = UpCat(f[1], 4 * f[0], f[5], halves=False, dropout=d)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        cat = lambda *ts: torch.cat(ts, dim=1)  # noqa: E731
        x_0_0 = self.conv_0_0(x)
        x_1_0 = self.conv_1_0(x_0_0)
        x_0_1 = self.upcat_0_1(x_1_0, x_0_0)

        x_2_0 = self.conv_2_0(x_1_0)
        x_1_1 = self.upcat_1_1(x_2_0, x_1_0)
        x_0_2 = self.upcat_0_2(x_1_1, cat(x_0_0, x_0_1))

        x_3_0 = self.conv_3_0(x_2_0)
        x_2_1 = self.upcat_2_1(x_3_0, x_2_0)
        x_1_2 = self.upcat_1_2(x_2_1, cat(x_1_0, x_1_1))
        x_0_3 = self.upcat_0_3(x_1_2, cat(x_0_0, x_0_1, x_0_2))

        x_4_0 = self.conv_4_0(x_3_0)
        x_3_1 = self.upcat_3_1(x_4_0, x_3_0)
        x_2_2 = self.upcat_2_2(x_3_1, cat(x_2_0, x_2_1))
        x_1_3 = self.upcat_1_3(x_2_2, cat(x_1_0, x_1_1, x_1_2))
        x_0_4 = self.upcat_0_4(x_1_3, cat(x_0_0, x_0_1, x_0_2, x_0_3))
        return {"x_0_1": x_0_1, "x_0_2": x_0_2, "x_0_3": x_0_3, "x_0_4": x_0_4,
                "x_3_0": x_3_0, "x_3_1": x_3_1, "x_4_0": x_4_0}


class UNetPlusPlusClsHead(nn.Module):
    """One Down block applied to both x_3_0 and x_3_1 (shared weights),
    concatenated around x_4_0, then TwoConv(512) → GAP → MLP(256 → n_out)."""

    def __init__(self, features: Sequence[int] = MT_FEATURES, n_out: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        f = tuple(features)
        self.process_level_3 = Down(f[3], f[4], dropout)
        self.cls_convs = TwoConv(3 * f[4], 512, dropout)
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, n_out)

    def forward(self, x_3_0, x_4_0, x_3_1) -> torch.Tensor:
        feats = torch.cat([self.process_level_3(x_3_0), x_4_0,
                           self.process_level_3(x_3_1)], dim=1)
        feats = global_avg_pool(self.cls_convs(feats))
        return self.fc2(F.relu(self.fc1(feats)))


def _add_final_convs(model: nn.Module, features, regions: int, all_heads: bool) -> None:
    """The 1×1 output convs ``final_conv_0_j`` over x_0_j: the finest
    (j = 4) always, j = 1..3 with ``all_heads``."""
    for j in (1, 2, 3, 4) if all_heads else (4,):
        setattr(model, f"final_conv_0_{j}", conv1x1(features[5 if j == 4 else 0], regions))


def _final_heads(model: nn.Module, nest) -> tuple:
    return tuple(getattr(model, f"final_conv_0_{j}")(nest[f"x_0_{j}"]) for j in (1, 2, 3, 4))


class BasicUNetPlusPlus(nn.Module):
    """Segmentation UNet++; deep supervision → the 4-head tuple (finest
    last), else the finest head alone."""

    space_row_multiple = 16  # four pools

    def __init__(self, in_features: int = 1, regions: int = 1,
                 features: Sequence[int] = MONAI_DEFAULT_FEATURES,
                 deep_supervision: bool = False, dropout: float = 0.0):
        super().__init__()
        self.deep_supervision = deep_supervision
        self.nest = UNetPlusPlusNest(in_features, features, dropout)
        _add_final_convs(self, features, regions, deep_supervision)

    def forward(self, x: torch.Tensor):
        nest = self.nest(x)
        if not self.deep_supervision:
            return self.final_conv_0_4(nest["x_0_4"])
        return _final_heads(self, nest)


class UNetPlusPlusClassifier(nn.Module):
    """Classification-only UNet++: the encoder column, ``upcat_3_1`` and the
    classification head."""

    space_row_multiple = 16  # four pools (the head's Down too: x_3_0 at 1/8)

    def __init__(self, in_features: int = 1, n_classes: int = 3,
                 features: Sequence[int] = MT_FEATURES, dropout: float = 0.0):
        super().__init__()
        f, d = tuple(features), dropout
        self.conv_0_0 = TwoConv(in_features, f[0], d)
        self.conv_1_0 = Down(f[0], f[1], d)
        self.conv_2_0 = Down(f[1], f[2], d)
        self.conv_3_0 = Down(f[2], f[3], d)
        self.conv_4_0 = Down(f[3], f[4], d)
        self.upcat_3_1 = UpCat(f[4], f[3], f[3], dropout=d)
        self.cls_head = UNetPlusPlusClsHead(f, 1 if n_classes == 2 else n_classes, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_3_0 = self.conv_3_0(self.conv_2_0(self.conv_1_0(self.conv_0_0(x))))
        x_4_0 = self.conv_4_0(x_3_0)
        return self.cls_head(x_3_0, x_4_0, self.upcat_3_1(x_4_0, x_3_0))


class MTUNetPlusPlus(nn.Module):
    """Multitask UNet++: the shared nest, the four seg heads and the
    classification head. Returns ``((cls,), (o01, o02, o03, o04))`` with deep
    supervision, else ``(cls, o04)``."""

    space_row_multiple = 16  # four pools

    def __init__(self, in_features: int = 1, regions: int = 1, n_classes: int = 3,
                 features: Sequence[int] = MT_FEATURES, deep_supervision: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.deep_supervision = deep_supervision
        self.nest = UNetPlusPlusNest(in_features, features, dropout)
        _add_final_convs(self, features, regions, all_heads=True)
        self.cls_head = UNetPlusPlusClsHead(features, 1 if n_classes == 2 else n_classes,
                                            dropout)

    def forward(self, x: torch.Tensor):
        nest = self.nest(x)
        heads = _final_heads(self, nest)
        cls = self.cls_head(nest["x_3_0"], nest["x_4_0"], nest["x_3_1"])
        if self.deep_supervision:
            return (cls,), heads
        return cls, heads[-1]
