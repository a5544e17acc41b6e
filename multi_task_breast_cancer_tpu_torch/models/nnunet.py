"""nnU-Net 2021: 5-level U-Net, widths (32, 64, 128, 256, 320), deconv
upsampling, always-on 4-head deep supervision (PyTorch, NCHW).

Twin of ``multi_task_breast_cancer_tpu/models/nnunet.py``. Every decoder
level concatenates the skip first, then the upsampled tensor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    DeconvHead,
    LevelBlock,
    conv1x1,
    deconv,
    max_pool_2x2,
)

NNUNET_WIDTHS = (32, 64, 128, 256, 320)


class NNUNetBackbone(nn.Module):
    """Encoder + bottleneck + full decoder. Returns every intermediate tensor
    the seg heads and the multitask classification head read."""

    def __init__(self, in_features: int = 1, widths: Tuple[int, ...] = NNUNET_WIDTHS):
        super().__init__()
        w = widths
        self.encoder1 = LevelBlock(in_features, w[0], w[0])
        self.encoder2 = LevelBlock(w[0], w[1], w[1])
        self.encoder3 = LevelBlock(w[1], w[2], w[2])
        self.encoder4 = LevelBlock(w[2], w[3], w[3])
        self.encoder5 = LevelBlock(w[3], w[4], w[4])
        self.bottleneck = LevelBlock(w[4], w[4], w[4])
        self.upsample5 = deconv(w[4], w[4], 2)
        self.decoder5 = LevelBlock(2 * w[4], w[3], w[3])
        self.upsample4 = deconv(w[3], w[3], 2)
        self.decoder4 = LevelBlock(2 * w[3], w[2], w[2])
        self.upsample3 = deconv(w[2], w[2], 2)
        self.decoder3 = LevelBlock(2 * w[2], w[1], w[1])
        self.upsample2 = deconv(w[1], w[1], 2)
        self.decoder2 = LevelBlock(2 * w[1], w[0], w[0])
        self.upsample1 = deconv(w[0], w[0], 2)
        self.decoder1 = LevelBlock(2 * w[0], w[0], w[0] // 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        e1 = self.encoder1(x)
        e2 = self.encoder2(max_pool_2x2(e1))
        e3 = self.encoder3(max_pool_2x2(e2))
        e4 = self.encoder4(max_pool_2x2(e3))
        e5 = self.encoder5(max_pool_2x2(e4))
        bottleneck = self.bottleneck(max_pool_2x2(e5))

        up5 = self.upsample5(bottleneck)
        d5 = self.decoder5(torch.cat([e5, up5], dim=1))
        d4 = self.decoder4(torch.cat([e4, self.upsample4(d5)], dim=1))
        d3 = self.decoder3(torch.cat([e3, self.upsample3(d4)], dim=1))
        d2 = self.decoder2(torch.cat([e2, self.upsample2(d3)], dim=1))
        d1 = self.decoder1(torch.cat([e1, self.upsample1(d2)], dim=1))
        return {"e5": e5, "bottleneck": bottleneck, "up5": up5,
                "d5": d5, "d4": d4, "d3": d3, "d2": d2, "d1": d1}


class SegHeads(nn.Module):
    """The 4 deep-supervision heads (coarse→fine), each at full resolution."""

    def __init__(self, regions: int = 1, widths: Tuple[int, ...] = NNUNET_WIDTHS):
        super().__init__()
        w = widths
        self.output4 = DeconvHead(w[2], regions, 8)
        self.output3 = DeconvHead(w[1], regions, 4)
        self.output2 = DeconvHead(w[0], regions, 2)
        self.output1 = conv1x1(w[0] // 2, regions)

    def forward(self, feats: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return (self.output4(feats["d4"]), self.output3(feats["d3"]),
                self.output2(feats["d2"]), self.output1(feats["d1"]))


class NNUNet2021(nn.Module):
    """Segmentation nnU-Net; returns the 4-head coarse→fine tuple."""

    space_row_multiple = 32  # five pools

    def __init__(self, in_features: int = 1, regions: int = 1,
                 widths: Tuple[int, ...] = NNUNET_WIDTHS):
        super().__init__()
        self.backbone = NNUNetBackbone(in_features, widths)
        self.heads = SegHeads(regions, widths)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.heads(self.backbone(x))
