"""Residual U-Net (PyTorch, NCHW), twin of
``multi_task_breast_cancer_tpu/models/residual_unet.py``: BatchNorm residual
blocks with dropout 0.2, strided-conv downsampling, deconv upsampling and, as
the reference's ``forward`` and the JAX model do, **no skip connections** in
the decoder.

The batch statistics are the :class:`~.blocks.BatchNorm` buffers ``mean`` and
``var`` (JAX's ``batch_stats``); dropout draws from the generator the Engine
sets (:func:`~.blocks.dropout_draws`) and is active in training only, as in
JAX (the reference leaves it on at eval time).

Under a ``space`` group the 3×3 convolutions (stride 1 and 2) exchange
halo rows, the batch statistics are summed over every rank of the mesh and
the dropout masks are the global batch's rows (:mod:`.blocks`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    BatchNorm,
    Conv3x3,
    Dropout,
    conv1x1,
    deconv,
)


def _conv3(in_features: int, features: int, stride: int = 1) -> Conv3x3:
    """3×3, biased, symmetric padding 1 (JAX ``padding=1``), halo-aware."""
    return Conv3x3(in_features, features, bias=True, stride=stride)


class _BN(nn.Module):
    """The JAX ``_BN`` wrapper: a :class:`BatchNorm` named ``bn``."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class InBlock(nn.Module):
    def __init__(self, in_features: int, features: int, dropout: float = 0.2):
        super().__init__()
        self.conv1 = _conv3(in_features, features)
        self.bn1 = _BN(features)
        self.dropout = Dropout(dropout)
        self.conv2 = _conv3(features, features)
        self.conv3 = _conv3(in_features, features)
        self.bn3 = _BN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        path = self.dropout(F.leaky_relu(self.bn1(self.conv1(x)), 0.01))
        return self.conv2(path) + self.bn3(self.conv3(x))


class ResBlock(nn.Module):
    def __init__(self, features_in: int, downsample: bool = False, dropout: float = 0.2):
        super().__init__()
        features_out = 2 * features_in if downsample else features_in
        stride = 2 if downsample else 1
        self.bn1 = _BN(features_in)
        self.dropout = Dropout(dropout)
        self.conv1 = _conv3(features_in, features_out, stride)
        self.bn2 = _BN(features_out)
        self.conv2 = _conv3(features_out, features_out)
        self.conv3 = _conv3(features_in, features_out, stride)
        self.bn3 = _BN(features_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        path = self.conv1(self.dropout(F.leaky_relu(self.bn1(x), 0.01)))
        path = self.conv2(self.dropout(F.leaky_relu(self.bn2(path), 0.01)))
        return path + self.bn3(self.conv3(x))


class ResidualUNet(nn.Module):
    name_str = "Residual UNet"
    space_row_multiple = 8  # three stride-2 convolutions

    def __init__(self, sequences: int = 1, regions: int = 1, width: int = 24):
        super().__init__()
        bf = width
        self.in_block = InBlock(sequences, bf)
        self.down_block2 = ResBlock(bf, downsample=True)
        self.down_block3 = ResBlock(2 * bf, downsample=True)
        self.down_block4 = ResBlock(4 * bf, downsample=True)
        self.upsample3 = deconv(8 * bf, 4 * bf, 2)
        self.up_block3 = ResBlock(4 * bf)
        self.upsample2 = deconv(4 * bf, 2 * bf, 2)
        self.up_block2 = ResBlock(2 * bf)
        self.upsample1 = deconv(2 * bf, bf, 2)
        self.up_block1 = ResBlock(bf)
        self.seg_out = conv1x1(bf, regions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down_block4(self.down_block3(self.down_block2(self.in_block(x))))
        x = self.up_block3(self.upsample3(x))
        x = self.up_block2(self.upsample2(x))
        x = self.up_block1(self.upsample1(x))
        return self.seg_out(x)
