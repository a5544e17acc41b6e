"""Multi-task models (PyTorch, NCHW). This slice ports the config-default
flagship ``MTnnUNet``; twin of ``MTnnUNet`` in
``multi_task_breast_cancer_tpu/models/multitask.py``."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.classifiers import NNUNetClassifierHead
from multi_task_breast_cancer_tpu_torch.models.nnunet import (
    NNUNET_WIDTHS,
    NNUNetBackbone,
    SegHeads,
)


class MTnnUNet(nn.Module):
    """nnU-Net backbone + 4 seg heads + classification head over
    cat(proc(e5), upsample5(bottleneck), proc(d5)); the head shares the
    backbone's ``upsample5`` output. Returns ``((cls,), (out4, out3, out2, out1))``."""

    def __init__(self, in_features: int = 1, regions: int = 1, n_classes: int = 3,
                 widths: Tuple[int, ...] = NNUNET_WIDTHS, plain_norm: bool = False):
        super().__init__()
        n_out = 1 if n_classes == 2 else n_classes
        self.backbone = NNUNetBackbone(in_features, widths, plain_norm)
        self.heads = SegHeads(regions, widths)
        self.cls_head = NNUNetClassifierHead(n_out, widths, plain_norm)

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x)
        seg = self.heads(feats)
        cls = self.cls_head(feats["e5"], feats["up5"], feats["d5"])
        return (cls,), seg
