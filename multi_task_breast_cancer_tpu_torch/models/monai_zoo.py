"""The MONAI networks of the reference factory (PyTorch, NCHW): ``UNet``,
``AttentionUNet`` and ``SegResNet``, twins of
``multi_task_breast_cancer_tpu/models/monai_zoo.py`` (which re-implements the
architecture families, not MONAI line for line).

Plain PyTorch: the JAX models reach no Pallas kernel (their norms are
InstanceNorm + PReLU, InstanceNorm + ReLU and GroupNorm + ReLU). Two flax
padding conventions are kept: a stride-2 ``padding="SAME"`` conv pads
(0, 1) (:class:`~.blocks.SameConv2d`), and the 3×3 stride-2 ``SAME``
transposed conv is the unpadded one cropped at its high end
(:class:`~.blocks.SameConvTranspose2d`). Concatenations keep the JAX order.
Under a ``space`` group each of these layers takes its row rule
(:mod:`.blocks`): halo rows for the convolutions at the global height's
``SAME`` pads, the norms' sums over the group.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    GroupNorm,
    InstanceNorm,
    LecunConv2d,
    PReLU,
    SameConv2d,
    SameConvTranspose2d,
    conv1x1,
    conv3x3,
    deconv,
    max_pool_2x2,
    upsample_nearest_2x,
)


class _ConvINPrelu(nn.Module):
    """MONAI ``Convolution``: a 3×3 ``SAME`` conv (or transposed conv) →
    InstanceNorm → PReLU; ``conv_only`` stops after the conv."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 transposed: bool = False, conv_only: bool = False):
        super().__init__()
        self.conv = (SameConvTranspose2d(in_features, features, 3, stride) if transposed
                     else SameConv2d(in_features, features, 3, stride))
        self.norm = self.act = None
        if not conv_only:
            self.norm = InstanceNorm()
            self.act = PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return x if self.act is None else self.act(self.norm(x))


class UNet(nn.Module):
    """MONAI ``UNet`` with ``num_res_units=0``: strided convs down,
    transposed convs up, concatenated skips; channels (w, 2w, 4w, 8w)."""

    name_str = "UNet"
    space_row_multiple = 8  # three stride-2 convolutions

    def __init__(self, sequences: int = 1, regions: int = 1,
                 channels: Sequence[int] = (48, 96, 192, 384)):
        super().__init__()
        c = tuple(channels)
        self.down1 = _ConvINPrelu(sequences, c[0], 2)
        self.down2 = _ConvINPrelu(c[0], c[1], 2)
        self.down3 = _ConvINPrelu(c[1], c[2], 2)
        self.bottom = _ConvINPrelu(c[2], c[3], 1)
        self.up3 = _ConvINPrelu(c[2] + c[3], c[1], 2, transposed=True)
        self.up2 = _ConvINPrelu(c[1] + c[1], c[0], 2, transposed=True)
        self.up1 = _ConvINPrelu(c[0] + c[0], regions, 2, transposed=True, conv_only=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = self.down1(x)
        d2 = self.down2(d1)
        d3 = self.down3(d2)
        bottom = self.bottom(d3)
        u3 = self.up3(torch.cat([d3, bottom], dim=1))
        u2 = self.up2(torch.cat([d2, u3], dim=1))
        return self.up1(torch.cat([d1, u2], dim=1))


class _AttnGate(nn.Module):
    """Additive attention gate: ``x·σ(ψ(ReLU(Wg·g + Wx·x)))``."""

    def __init__(self, g_features: int, x_features: int, inter: int):
        super().__init__()
        self.Wg = LecunConv2d(g_features, inter, 1)
        self.Wx = LecunConv2d(x_features, inter, 1)
        self.psi = LecunConv2d(inter, 1, 1)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.psi(F.relu(self.Wg(g) + self.Wx(x))))


class _ConvBlock(nn.Module):
    """Two (3×3 biased conv → InstanceNorm → ReLU)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.conv0 = conv3x3(in_features, features, use_bias=True)
        self.norm0 = InstanceNorm()
        self.conv1 = conv3x3(features, features, use_bias=True)
        self.norm1 = InstanceNorm()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm0(self.conv0(x)))
        return F.relu(self.norm1(self.conv1(x)))


class AttentionUNet(nn.Module):
    """MONAI ``AttentionUnet``: a U-Net with attention-gated skips;
    channels (w, 2w, 4w, 8w)."""

    name_str = "Attention U-Net"
    space_row_multiple = 8  # three pools

    def __init__(self, sequences: int = 1, regions: int = 1,
                 channels: Sequence[int] = (48, 96, 192, 384)):
        super().__init__()
        c = tuple(channels)
        self.enc1 = _ConvBlock(sequences, c[0])
        self.enc2 = _ConvBlock(c[0], c[1])
        self.enc3 = _ConvBlock(c[1], c[2])
        self.enc4 = _ConvBlock(c[2], c[3])
        self.up3 = deconv(c[3], c[2], 2)
        self.att3 = _AttnGate(c[2], c[2], c[2] // 2)
        self.dec3 = _ConvBlock(2 * c[2], c[2])
        self.up2 = deconv(c[2], c[1], 2)
        self.att2 = _AttnGate(c[1], c[1], c[1] // 2)
        self.dec2 = _ConvBlock(2 * c[1], c[1])
        self.up1 = deconv(c[1], c[0], 2)
        self.att1 = _AttnGate(c[0], c[0], max(c[0] // 2, 1))
        self.dec1 = _ConvBlock(2 * c[0], c[0])
        self.final = conv1x1(c[0], regions)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.enc1(x)
        e2 = self.enc2(max_pool_2x2(e1))
        e3 = self.enc3(max_pool_2x2(e2))
        e4 = self.enc4(max_pool_2x2(e3))
        u3 = self.up3(e4)
        d3 = self.dec3(torch.cat([self.att3(u3, e3), u3], dim=1))
        u2 = self.up2(d3)
        d2 = self.dec2(torch.cat([self.att2(u2, e2), u2], dim=1))
        u1 = self.up1(d2)
        d1 = self.dec1(torch.cat([self.att1(u1, e1), u1], dim=1))
        return self.final(d1)


class _GNRelu(nn.Module):
    """GroupNorm of ``min(8, C)`` groups → ReLU."""

    def __init__(self, features: int, groups: int = 8):
        super().__init__()
        self.gn = GroupNorm(min(groups, features), features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(x))


class _SegResBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.pre0 = _GNRelu(features)
        self.conv0 = conv3x3(features, features, use_bias=True)
        self.pre1 = _GNRelu(features)
        self.conv1 = conv3x3(features, features, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv1(self.pre1(self.conv0(self.pre0(x))))


SEGRESNET_BLOCKS = (1, 2, 2, 4)


class SegResNet(nn.Module):
    """MONAI ``SegResNet``: GroupNorm residual stages of (1, 2, 2, 4) blocks,
    strided-conv downsampling, 1×1 conv + nearest-upsample decoder."""

    name_str = "SegResNet"
    space_row_multiple = 8  # three stride-2 convolutions

    def __init__(self, sequences: int = 1, regions: int = 1, init_filters: int = 8):
        super().__init__()
        f = init_filters
        self.stem = conv3x3(sequences, f, use_bias=True)
        for i, n_blocks in enumerate(SEGRESNET_BLOCKS):
            feats = f * 2 ** i
            if i > 0:
                setattr(self, f"down{i}", SameConv2d(feats // 2, feats, 3, 2))
            for b in range(n_blocks):
                setattr(self, f"stage{i}_block{b}", _SegResBlock(feats))
        for i in range(len(SEGRESNET_BLOCKS) - 2, -1, -1):
            feats = f * 2 ** i
            setattr(self, f"up_conv{i}", LecunConv2d(2 * feats, feats, 1))
            setattr(self, f"up_block{i}", _SegResBlock(feats))
        self.final_norm = _GNRelu(f)
        self.final = LecunConv2d(f, regions, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        skips = []
        for i, n_blocks in enumerate(SEGRESNET_BLOCKS):
            if i > 0:
                x = getattr(self, f"down{i}")(x)
            for b in range(n_blocks):
                x = getattr(self, f"stage{i}_block{b}")(x)
            skips.append(x)
        for i in range(len(SEGRESNET_BLOCKS) - 2, -1, -1):
            x = upsample_nearest_2x(getattr(self, f"up_conv{i}")(x)) + skips[i]
            x = getattr(self, f"up_block{i}")(x)
        return self.final(self.final_norm(x))
