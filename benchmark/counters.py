"""The yardstick's arithmetic: the H100's published peaks, the least time of
a launch of the port's kernels from the bytes it must move, and the model's
operations per image, counted on the plain reference.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit. A bound counts every input byte read once and every output byte
written once, at 3.35 TB/s, or the arithmetic at the f32 rate, whichever
is larger.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
NORM_FWD_FLOPS_PER_ELEMENT = 8    # sum; centre, square, sum; centre, scale, select
NORM_BWD_FLOPS_PER_ELEMENT = 17   # statistics 4; xhat, select, two sums 6; dx 7
AUG_INT_OPS_PER_PIXEL = 14        # three index products and sums, three range tests, the address


def bound_s(numel: int, itemsize: int, tensors: int, flops_per_element: int) -> float:
    """Least time of one launch over ``tensors`` tensors of ``numel``
    elements: the bytes over the memory rate or the arithmetic over the
    f32 rate, the larger."""
    by_bytes = tensors * numel * itemsize / HBM_BYTES_PER_S
    by_ops = flops_per_element * numel / PEAK_FLOPS["float32"]
    return max(by_bytes, by_ops)


def norm_forward_bound_s(sites: Iterable[Tuple[int, int, int]], batch: int,
                         itemsize: int = 4) -> float:
    """Kernel #1 (InstanceNorm + LeakyReLU forward) at every site of one
    forward: x read, y written."""
    return sum(bound_s(batch * c * h * w, itemsize, 2, NORM_FWD_FLOPS_PER_ELEMENT)
               for c, h, w in sites)


def norm_backward_bound_s(sites: Iterable[Tuple[int, int, int]], batch: int,
                          itemsize: int = 4) -> float:
    """Kernel #2 (its backward) at every site of one step: x and dy read,
    dx written."""
    return sum(bound_s(batch * c * h * w, itemsize, 3, NORM_BWD_FLOPS_PER_ELEMENT)
               for c, h, w in sites)


def augment_bound_s(b: int, planes: int, s: int) -> float:
    """Kernel #3 (batch gather + flips + 3-shear rotation) over ``b``
    samples of ``planes`` S×S int32 planes: the selected planes read and the
    output written once, the gather factors (3·(S+2) per sample) and the
    rows read once; or its integer arithmetic at the f32 rate."""
    by_bytes = (2 * b * planes * s * s + 3 * b * (s + 2) + 2 * b) * 4 / HBM_BYTES_PER_S
    by_ops = AUG_INT_OPS_PER_PIXEL * b * planes * s * s / PEAK_FLOPS["float32"]
    return max(by_bytes, by_ops)


def _reference(torch, name: str, kwargs: dict):
    from benchmark.reference import models
    with torch.device("meta"):
        return models.build(name, **kwargs)


def norm_sites(torch, name: str, kwargs: dict, size: int, channels: int) -> List[tuple]:
    """(C, H, W) of every fused-norm site of one forward of the reference
    model (a conv → InstanceNorm → LeakyReLU block), in forward order."""
    from benchmark.reference import models
    model = _reference(torch, name, kwargs)
    models.ConvNormAct.sites = []
    try:
        with torch.no_grad():
            model(torch.zeros(1, channels, size, size, device="meta"))
        return list(models.ConvNormAct.sites)
    finally:
        models.ConvNormAct.sites = None


def forward_flops(torch, name: str, kwargs: dict, size: int, channels: int) -> int:
    """Floating-point operations of one image's forward on the reference
    model (convolutions and matrix products, 2 per multiply-add), with the
    deep-supervision heads counted in the one-transposed-conv form the
    repository runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from benchmark.reference import models
    model = _reference(torch, name, kwargs)
    models.DeconvHead.fused = True
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.zeros(1, channels, size, size, device="meta"))
        return int(counter.get_total_flops())
    finally:
        models.DeconvHead.fused = False
