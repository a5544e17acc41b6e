"""Hand-written Hopper kernels for the port's hot ops, each beside its plain
PyTorch twin (counterpart of ``multi_task_breast_cancer_tpu/ops/pallas_kernels.py``).

``instance_norm_leaky_relu``: fused per-(sample, channel) spatial
normalisation + LeakyReLU, the epilogue of every ``ConvInNormLeReLU`` (25 per
MTnnUNet forward). The CUDA source is ``csrc/instance_norm_leaky_relu.cu``.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. There is no
fallback from a failed launch to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from multi_task_breast_cancer_tpu_torch.ops import _build

_ENTRY = {torch.float32: "instance_norm_leaky_relu_f32",
          torch.bfloat16: "instance_norm_leaky_relu_bf16"}


def instance_norm_leaky_relu_reference(x: torch.Tensor, eps: float = 1e-5,
                                       slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch twin of the kernel over NCHW input: f32 statistics
    (mean, then the variance of the centred values), normalise and LeakyReLU
    in f32, cast to ``x``'s dtype."""
    xf = x.float()
    centered = xf - xf.mean(dim=(2, 3), keepdim=True)
    var = (centered * centered).mean(dim=(2, 3), keepdim=True)
    xhat = centered * torch.rsqrt(var + eps)
    return torch.where(xhat >= 0, xhat, slope * xhat).to(x.dtype)


def _entry(dtype: torch.dtype):
    fn = getattr(_build.library("instance_norm_leaky_relu"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def instance_norm_leaky_relu(x: torch.Tensor, eps: float = 1e-5,
                             slope: float = 0.01) -> torch.Tensor:
    """Fused InstanceNorm(affine=False) + LeakyReLU over NCHW input.

    CPU tensor → :func:`instance_norm_leaky_relu_reference`. CUDA tensor →
    the CUDA kernel (f32 or bf16, contiguous), counted in
    ``instance_norm_leaky_relu.launches``. Forward only: the backward kernel
    belongs to the training slice, so a CUDA input that needs a gradient
    raises rather than silently dropping it."""
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_reference(x, eps, slope)
    if x.device.type != "cuda":
        raise ValueError(f"instance_norm_leaky_relu: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"instance_norm_leaky_relu: expected NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"instance_norm_leaky_relu: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError("instance_norm_leaky_relu: input must be NCHW-contiguous")
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("instance_norm_leaky_relu: the CUDA backward "
                                  "is not ported yet (forward/inference only)")
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(x.data_ptr(), y.data_ptr(), n * c, h * w,
                              float(eps), float(slope),
                              torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"instance_norm_leaky_relu: CUDA launch failed with "
                           f"error {err} at shape {tuple(x.shape)}")
    instance_norm_leaky_relu.launches += 1
    return y


instance_norm_leaky_relu.launches = 0
