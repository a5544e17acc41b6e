"""Multi-task models (PyTorch, NCHW): a shared encoder, a segmentation
decoder and a classification head. Twins of ``MTnnUNet``, ``MultiBTSUNet``,
``MultiFSBBTSUNet`` and ``Adityan`` in
``multi_task_breast_cancer_tpu/models/multitask.py`` (``MTUNetPlusPlus``
lives in :mod:`.unetpp`).

Outputs keep the JAX package's conventions: ``(cls, seg)`` pairs whose
members are a tensor or a tuple of heads; Adityan's triple
``(cls, reconstruction, seg)``.

The BTS models' classification heads flatten a feature map, so their dense
layer's width depends on the input side ``size`` (JAX infers it at
``init``; here it is a constructor argument, 128 by default).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multi_task_breast_cancer_tpu_torch.models.blocks import (
    ConvInNormLeReLU,
    DeconvHead,
    LevelBlock,
    MLPHead,
    avg_pool,
    conv1x1,
    conv3x3,
    deconv,
    flatten_hwc,
    max_pool_2x2,
    upsample_nearest_2x,
)
from multi_task_breast_cancer_tpu_torch.models.classifiers import NNUNetClassifierHead
from multi_task_breast_cancer_tpu_torch.models.nnunet import (
    NNUNET_WIDTHS,
    NNUNetBackbone,
    SegHeads,
)
from multi_task_breast_cancer_tpu_torch.parallel import spatial


class MTnnUNet(nn.Module):
    """nnU-Net backbone + 4 seg heads + classification head over
    cat(proc(e5), upsample5(bottleneck), proc(d5)); the head shares the
    backbone's ``upsample5`` output. Returns ``((cls,), (out4, out3, out2, out1))``."""

    space_row_multiple = 32  # five pools

    def __init__(self, in_features: int = 1, regions: int = 1, n_classes: int = 3,
                 widths: Tuple[int, ...] = NNUNET_WIDTHS):
        super().__init__()
        n_out = 1 if n_classes == 2 else n_classes
        self.backbone = NNUNetBackbone(in_features, widths)
        self.heads = SegHeads(regions, widths)
        self.cls_head = NNUNetClassifierHead(n_out, widths)

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x)
        seg = self.heads(feats)
        cls = self.cls_head(feats["e5"], feats["up5"], feats["d5"])
        return (cls,), seg


class _BTSTrunk(nn.Module):
    """The BTS encoder, dual bottleneck and decoder (and, with ``fsb``, the
    full-resolution no-pooling bridge ``npl1-4`` into ``decoder1``). Returns
    every tensor a head reads. The multitask models hold it as ``trunk``;
    ``BTSUNet`` and ``FSBBTSUNet`` inherit it."""

    def __init__(self, in_features: int, width: int, fsb: bool = False):
        super().__init__()
        w = tuple(width * 2 ** i for i in range(4))
        self.fsb = fsb
        if fsb:
            self.npl1 = LevelBlock(in_features, w[0], w[0])
            self.npl2 = LevelBlock(w[0], w[1] // 2, w[1])
            self.npl3 = LevelBlock(w[1], w[2] // 2, w[2])
            self.npl4 = LevelBlock(w[2], w[3] // 2, w[3])
        self.encoder1 = LevelBlock(in_features, w[0] // 2, w[0])
        self.encoder2 = LevelBlock(w[0], w[1] // 2, w[1])
        self.encoder3 = LevelBlock(w[1], w[2] // 2, w[2])
        self.encoder4 = LevelBlock(w[2], w[3] // 2, w[3])
        # the dual bottleneck runs at 1/8 resolution: no pooling before it
        self.bottleneck = LevelBlock(w[3], w[3], w[3])
        self.bottleneck2 = ConvInNormLeReLU(2 * w[3], w[2])
        self.decoder3 = LevelBlock(2 * w[2], w[2], w[1])
        self.decoder2 = LevelBlock(2 * w[1], w[1], w[0])
        self.decoder1 = LevelBlock(2 * w[0] + (w[3] if fsb else 0), w[0], w[0] // 2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        npl = {}
        if self.fsb:
            npl["npl1"] = self.npl1(x)
            npl["npl2"] = self.npl2(npl["npl1"])
            npl["npl3"] = self.npl3(npl["npl2"])
            npl["npl4"] = self.npl4(npl["npl3"])
        e1 = self.encoder1(x)
        e2 = self.encoder2(max_pool_2x2(e1))
        e3 = self.encoder3(max_pool_2x2(e2))
        e4 = self.encoder4(max_pool_2x2(e3))
        bottleneck = self.bottleneck(e4)
        bottleneck2 = self.bottleneck2(torch.cat([e4, bottleneck], dim=1))
        d3 = self.decoder3(torch.cat([e3, upsample_nearest_2x(bottleneck2)], dim=1))
        d2 = self.decoder2(torch.cat([e2, upsample_nearest_2x(d3)], dim=1))
        d1_in = [e1, upsample_nearest_2x(d2)] + ([npl["npl4"]] if self.fsb else [])
        d1 = self.decoder1(torch.cat(d1_in, dim=1))
        return {"e1": e1, "e4": e4, "bottleneck": bottleneck, "bottleneck2": bottleneck2,
                "d3": d3, "d2": d2, "d1": d1, **npl}


def add_bts_seg_heads(model: nn.Module, width: int, regions: int,
                      deep_supervision: bool, fsb: bool) -> None:
    """The BTS family's segmentation heads, at the top of ``model``'s tree
    as in JAX: ``output1``, and with deep supervision ``output3``/``output2``
    (and, with ``fsb``, ``input1`` and ``out_npl1-4``)."""
    w = tuple(width * 2 ** i for i in range(4))
    model.deep_supervision, model.fsb_heads = deep_supervision, fsb
    model.output1 = conv1x1(w[0] // 2, regions)
    if not deep_supervision:
        return
    if fsb:
        model.input1 = conv1x1(w[0], regions)
        for i in range(4):
            setattr(model, f"out_npl{i + 1}", conv1x1(w[i], regions))
    model.output3 = DeconvHead(w[1], regions, 4)
    model.output2 = DeconvHead(w[0], regions, 2)


def bts_seg_heads(model: nn.Module, t: Dict[str, torch.Tensor]):
    """The heads of :func:`add_bts_seg_heads` on the trunk's tensors:
    ``out1``, or coarse→fine ``(out3, out2, out1)``, with ``fsb`` the 8-head
    ``(out3, out2, npl1, npl2, npl3, npl4, input1, out1)``."""
    out1 = model.output1(t["d1"])
    if not model.deep_supervision:
        return out1
    heads = (model.output3(t["d3"]), model.output2(t["d2"]))
    if model.fsb_heads:
        heads += tuple(getattr(model, f"out_npl{i}")(t[f"npl{i}"]) for i in range(1, 5))
        heads += (model.input1(t["e1"]),)
    return heads + (out1,)


class _BTSClsHead(nn.Module):
    """cat(e4, bottleneck, proc(bottleneck2)) → ConvINLReLU → Flatten → MLP
    (256); the flatten sees ``8·width`` channels at ``size/8``²."""

    def __init__(self, width: int, n_out: int, size: int = 128):
        super().__init__()
        w2, w3 = 4 * width, 8 * width
        self.process_bottleneck2 = ConvInNormLeReLU(w2, w3)
        self.process_features_map = ConvInNormLeReLU(3 * w3, w3)
        self.classifier = MLPHead(w3 * (size // 8) ** 2, 256, n_out)

    def forward(self, e4, bottleneck, bottleneck2) -> torch.Tensor:
        feats = torch.cat([e4, bottleneck, self.process_bottleneck2(bottleneck2)], dim=1)
        return self.classifier(self.process_features_map(feats))


class MultiBTSUNet(nn.Module):
    """BTS U-Net + classification head (19 fused norms per forward). Deep
    supervision → ``((cls,), (out3, out2, out1))``, else ``(cls, out1)``."""

    space_row_multiple = 8  # three pools

    def __init__(self, in_features: int = 1, regions: int = 1, n_classes: int = 3,
                 width: int = 24, deep_supervision: bool = False, size: int = 128):
        super().__init__()
        self.trunk = _BTSTrunk(in_features, width, fsb=False)
        self.cls_head = _BTSClsHead(width, 1 if n_classes == 2 else n_classes, size)
        add_bts_seg_heads(self, width, regions, deep_supervision, fsb=False)

    def forward(self, x: torch.Tensor):
        t = self.trunk(x)
        cls = self.cls_head(t["e4"], t["bottleneck"], t["bottleneck2"])
        seg = bts_seg_heads(self, t)
        return ((cls,), seg) if self.deep_supervision else (cls, seg)


class MultiFSBBTSUNet(nn.Module):
    """FSB BTS U-Net + classification head (27 fused norms per forward).

    The reference's quirks stay: the head emits **1 logit** whatever the
    class count (``Multi_FSB_BTS_UNet.py:152``), and with deep supervision
    the class output is returned bare. Deep supervision → ``(cls, 8-head
    tuple)``, else ``(cls, out1)``."""

    space_row_multiple = 8  # three pools

    def __init__(self, in_features: int = 1, regions: int = 1, width: int = 24,
                 deep_supervision: bool = False, size: int = 128):
        super().__init__()
        self.trunk = _BTSTrunk(in_features, width, fsb=True)
        self.cls_head = _BTSClsHead(width, 1, size)
        add_bts_seg_heads(self, width, regions, deep_supervision, fsb=True)

    def forward(self, x: torch.Tensor):
        t = self.trunk(x)
        return self.cls_head(t["e4"], t["bottleneck"], t["bottleneck2"]), bts_seg_heads(self, t)


class _ConvReLULevel(nn.Module):
    """Two (conv3x3 bias=True → ReLU) blocks: Adityan's level, with no
    normalisation."""

    def __init__(self, in_features: int, mid_features: int, out_features: int):
        super().__init__()
        self.conv1 = conv3x3(in_features, mid_features, use_bias=True)
        self.conv2 = conv3x3(mid_features, out_features, use_bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(F.relu(self.conv1(x))))


class Adityan(nn.Module):
    """Three-output network: ``(cls_logits, reconstruction, seg_logits)``.
    The classification head hard-codes 3 logits; no fused norm. Under a
    ``space`` group the head pools the gathered 1/8 map."""

    space_row_multiple = 16  # four pools

    def __init__(self, in_features: int = 1, regions: int = 1, width: int = 64):
        super().__init__()
        w = tuple(width * 2 ** i for i in range(5))
        self.encoder1 = _ConvReLULevel(in_features, w[0], w[0])
        self.encoder2 = _ConvReLULevel(w[0], w[1], w[1])
        self.encoder3 = _ConvReLULevel(w[1], w[2], w[2])
        self.encoder4 = _ConvReLULevel(w[2], w[3], w[3])
        self.bottleneck = _ConvReLULevel(w[3], w[4], w[3])
        self.upsample4 = deconv(w[3], w[3], 2)
        self.decoder4 = _ConvReLULevel(2 * w[3], w[3], w[2])
        self.upsample3 = deconv(w[2], w[2], 2)
        self.decoder3 = _ConvReLULevel(2 * w[2], w[2], w[1])
        self.upsample2 = deconv(w[1], w[1], 2)
        self.decoder2 = _ConvReLULevel(2 * w[1], w[1], w[0])
        self.upsample1 = deconv(w[0], w[0], 2)
        self.segmap = _ConvReLULevel(2 * w[0], w[0], w[0])
        self.seg_out = conv1x1(w[0], regions)
        self.recmap = _ConvReLULevel(2 * w[0], w[0], w[0])
        self.rec_out = conv3x3(w[0], regions, use_bias=True)
        self.cls_conv = conv3x3(2 * w[0], 32, use_bias=True)
        self.cls_fc1 = nn.Linear(32, 1000)
        self.cls_fc2 = nn.Linear(1000, 3)

    def forward(self, x: torch.Tensor):
        e1 = self.encoder1(x)
        e2 = self.encoder2(max_pool_2x2(e1))
        e3 = self.encoder3(max_pool_2x2(e2))
        e4 = self.encoder4(max_pool_2x2(e3))
        bottleneck = self.bottleneck(max_pool_2x2(e4))
        d4 = self.decoder4(torch.cat([e4, self.upsample4(bottleneck)], dim=1))
        d3 = self.decoder3(torch.cat([e3, self.upsample3(d4)], dim=1))
        d2 = self.decoder2(torch.cat([e2, self.upsample2(d3)], dim=1))
        d1 = torch.cat([e1, self.upsample1(d2)], dim=1)

        seg = self.seg_out(self.segmap(d1))
        rec = torch.sigmoid(self.rec_out(self.recmap(d1)))

        # three pools → ConvReLU(32) → average pool over the map's height
        # (JAX's NHWC ``shape[1]``; the whole map's, gathered under a
        # ``space`` group) → MLP(1000 → 3)
        cmap = F.relu(self.cls_conv(max_pool_2x2(max_pool_2x2(max_pool_2x2(d1)))))
        cmap = spatial.whole_rows(cmap)
        cmap = flatten_hwc(avg_pool(cmap, cmap.shape[2]))
        cls = self.cls_fc2(F.relu(self.cls_fc1(cmap)))
        return cls, rec, seg
