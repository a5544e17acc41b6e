"""Classification heads (PyTorch, NCHW). This slice ports the nnU-Net head
that ``MTnnUNet`` uses; twin of ``NNUNetClassifierHead`` in
``multi_task_breast_cancer_tpu/models/classifiers.py``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import ConvInNormLeReLU
from multi_task_breast_cancer_tpu_torch.models.nnunet import NNUNET_WIDTHS


class NNUNetClassifierHead(nn.Module):
    """cat(proc(e5), up5, proc(d5)) → ConvINLReLU(512) → GAP → MLP(256)."""

    def __init__(self, n_out: int = 3, widths: Tuple[int, ...] = NNUNET_WIDTHS,
                 plain_norm: bool = False):
        super().__init__()
        w = widths
        self.process_encoder_5 = ConvInNormLeReLU(w[4], w[4], plain_norm=plain_norm)
        self.process_decoder_5 = ConvInNormLeReLU(w[3], w[4], plain_norm=plain_norm)
        self.cls_conv = ConvInNormLeReLU(3 * w[4], 512, plain_norm=plain_norm)
        self.fc1 = nn.Linear(512, 256)
        self.fc2 = nn.Linear(256, n_out)

    def forward(self, e5: torch.Tensor, up5: torch.Tensor, d5: torch.Tensor) -> torch.Tensor:
        feats = torch.cat([self.process_encoder_5(e5), up5,
                           self.process_decoder_5(d5)], dim=1)
        feats = self.cls_conv(feats).mean(dim=(2, 3))
        return self.fc2(F.relu(self.fc1(feats)))
