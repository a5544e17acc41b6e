"""Classification models (PyTorch, NCHW): the nnU-Net head that ``MTnnUNet``
shares and the ``NNUNetClassifier`` built on it; twins of
``NNUNetClassifierHead`` and ``NNUNetClassifier`` in
``multi_task_breast_cancer_tpu/models/classifiers.py``, with the JAX
parameter tree's module names."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    ConvInNormLeReLU,
    LevelBlock,
    deconv,
    max_pool_2x2,
)
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


class NNUNetClassifier(nn.Module):
    """nnU-Net encoder, bottleneck and decoder5, the classification head on
    top: 14 fused norms in the trunk and 3 in the head.

    The reference's quirk stays behind ``apply_softmax`` (default True,
    ``nnUNet_classifier.py:168-169``): with more than two classes the forward
    returns softmax probabilities, so the loss receives probabilities, not
    logits."""

    def __init__(self, in_features: int = 1, n_classes: int = 3,
                 widths: Tuple[int, ...] = NNUNET_WIDTHS, apply_softmax: bool = True,
                 plain_norm: bool = False):
        super().__init__()
        w, p = widths, plain_norm
        self.n_classes = n_classes
        self.apply_softmax = apply_softmax
        self.encoder1 = LevelBlock(in_features, w[0], w[0], p)
        self.encoder2 = LevelBlock(w[0], w[1], w[1], p)
        self.encoder3 = LevelBlock(w[1], w[2], w[2], p)
        self.encoder4 = LevelBlock(w[2], w[3], w[3], p)
        self.encoder5 = LevelBlock(w[3], w[4], w[4], p)
        self.bottleneck = LevelBlock(w[4], w[4], w[4], p)
        self.upsample5 = deconv(w[4], w[4], 2)
        self.decoder5 = LevelBlock(2 * w[4], w[3], w[3], p)
        self.cls_head = NNUNetClassifierHead(1 if n_classes == 2 else n_classes, widths, p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e1 = self.encoder1(x)
        e2 = self.encoder2(max_pool_2x2(e1))
        e3 = self.encoder3(max_pool_2x2(e2))
        e4 = self.encoder4(max_pool_2x2(e3))
        e5 = self.encoder5(max_pool_2x2(e4))
        up5 = self.upsample5(self.bottleneck(max_pool_2x2(e5)))
        d5 = self.decoder5(torch.cat([e5, up5], dim=1))
        logits = self.cls_head(e5, up5, d5)
        if self.apply_softmax and self.n_classes > 2:
            logits = torch.softmax(logits, dim=-1)
        return logits
