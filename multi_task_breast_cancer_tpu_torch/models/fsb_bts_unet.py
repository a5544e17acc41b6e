"""FSB BTS U-Net: the BTS U-Net plus a full-resolution "no-pooling" path
(``npl1-4``) bridged into ``decoder1``, with 8-head deep supervision
(PyTorch, NCHW). Twin of ``multi_task_breast_cancer_tpu/models/fsb_bts_unet.py``.
"""

from __future__ import annotations

import torch

from multi_task_breast_cancer_tpu_torch.models.multitask import (
    _BTSTrunk,
    add_bts_seg_heads,
    bts_seg_heads,
)


class FSBBTSUNet(_BTSTrunk):
    """With deep supervision the reference's 8-head order ``(out3, out2,
    npl1, npl2, npl3, npl4, input1, out1)`` (finest last); otherwise one
    logits map. 25 fused norms per forward."""

    space_row_multiple = 8  # three pools

    def __init__(self, in_features: int = 1, regions: int = 1, width: int = 24,
                 deep_supervision: bool = False):
        super().__init__(in_features, width, fsb=True)
        add_bts_seg_heads(self, width, regions, deep_supervision, fsb=True)

    def forward(self, x: torch.Tensor):
        return bts_seg_heads(self, super().forward(x))
