"""BTS U-Net: a 4-level U-Net of ConvInNormLeReLU blocks with a dual
bottleneck, nearest upsampling and optional 3-head deep supervision
(PyTorch, NCHW). Twin of ``multi_task_breast_cancer_tpu/models/bts_unet.py``.

The encoder, bottlenecks and decoders are the multitask models' trunk
(:class:`~.multitask._BTSTrunk`), inherited so that they sit at the top of
the parameter tree, as in JAX.
"""

from __future__ import annotations

import torch

from multi_task_breast_cancer_tpu_torch.models.multitask import (
    _BTSTrunk,
    add_bts_seg_heads,
    bts_seg_heads,
)


class BTSUNet(_BTSTrunk):
    """Input (B, sequences, H, W) → seg logits (B, regions, H, W), or with
    deep supervision the coarse→fine tuple ``(out3, out2, out1)``, all at
    full resolution. 17 fused norms per forward."""

    space_row_multiple = 8  # three pools

    def __init__(self, in_features: int = 1, regions: int = 1, width: int = 24,
                 deep_supervision: bool = False):
        super().__init__(in_features, width, fsb=False)
        add_bts_seg_heads(self, width, regions, deep_supervision, fsb=False)

    def forward(self, x: torch.Tensor):
        return bts_seg_heads(self, super().forward(x))
