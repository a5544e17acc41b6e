"""Hand-written Hopper kernels for the port's hot ops, each beside its plain
PyTorch twin (counterpart of ``multi_task_breast_cancer_tpu/ops/pallas_kernels.py``).

``instance_norm_leaky_relu``: fused per-(sample, channel) spatial
normalisation + LeakyReLU, the epilogue of every ``ConvInNormLeReLU`` (25 per
MTnnUNet forward), with a hand-written backward
(``instance_norm_leaky_relu_backward``) behind a ``torch.autograd.Function``,
as the JAX side has a custom VJP. The forward saves only its input; the
backward recomputes the statistics. The CUDA source of both is
``csrc/instance_norm_leaky_relu.cu``.

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises. There is no
fallback from a failed launch to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from multi_task_breast_cancer_tpu_torch.ops import _build

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_SOURCE = "instance_norm_leaky_relu"


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for f32/bf16 input; f64 stays f64 (the formula checks in tests)."""
    return torch.promote_types(x.dtype, torch.float32)


def _statistics(x: torch.Tensor, eps: float):
    xf = x.to(_compute_dtype(x))
    centered = xf - xf.mean(dim=(2, 3), keepdim=True)
    rstd = torch.rsqrt((centered * centered).mean(dim=(2, 3), keepdim=True) + eps)
    return centered * rstd, rstd


def instance_norm_leaky_relu_reference(x: torch.Tensor, eps: float = 1e-5,
                                       slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel over NCHW input: f32
    statistics (mean, then the variance of the centred values), normalise and
    LeakyReLU in f32, cast to ``x``'s dtype."""
    xhat, _ = _statistics(x, eps)
    return torch.where(xhat >= 0, xhat, slope * xhat).to(x.dtype)


def instance_norm_leaky_relu_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                                eps: float = 1e-5,
                                                slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel (the Pallas ``_bwd_kernel``
    formula): statistics recomputed from ``x``, ``dxhat = g`` where
    ``xhat >= 0`` else ``slope·g``, then
    ``dx = rstd·(dxhat − mean(dxhat) − xhat·mean(dxhat·xhat))``; in f32,
    cast to ``x``'s dtype."""
    xhat, rstd = _statistics(x, eps)
    gf = g.to(xhat.dtype)
    dxhat = torch.where(xhat >= 0, gf, slope * gf)
    m1 = dxhat.mean(dim=(2, 3), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(2, 3), keepdim=True)
    return (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)


def _entry(name: str, dtype: torch.dtype, n_pointers: int):
    fn = getattr(_build.library(_SOURCE), f"{name}_{_DTYPES[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be NCHW-contiguous")


def _launch(name: str, inputs, out: torch.Tensor, eps: float, slope: float) -> None:
    n, c, h, w = out.shape
    with torch.cuda.device(out.device):
        err = _entry(name, out.dtype, len(inputs) + 1)(
            *(t.data_ptr() for t in inputs), out.data_ptr(), n * c, h * w,
            float(eps), float(slope), torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} at "
                           f"shape {tuple(out.shape)}")


def _forward(x: torch.Tensor, eps: float, slope: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_reference(x, eps, slope)
    _check_cuda_input(x, "instance_norm_leaky_relu")
    y = torch.empty_like(x)
    if x.numel():
        _launch("instance_norm_leaky_relu", (x,), y, eps, slope)
        instance_norm_leaky_relu.launches += 1
    return y


def instance_norm_leaky_relu_backward(x: torch.Tensor, g: torch.Tensor,
                                      eps: float = 1e-5,
                                      slope: float = 0.01) -> torch.Tensor:
    """Gradient of :func:`instance_norm_leaky_relu` with respect to ``x``,
    given the output's gradient ``g``.

    CPU tensors → :func:`instance_norm_leaky_relu_backward_reference`. CUDA
    tensors → the backward kernel, counted in
    ``instance_norm_leaky_relu_backward.launches``. ``g`` may arrive with any
    strides (cuDNN's convolution backward can hand over channels-last ones):
    it is made NCHW-contiguous here, a copy only when its layout differs."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"instance_norm_leaky_relu_backward: gradient "
                         f"{tuple(g.shape)} {g.dtype} {g.device} does not match "
                         f"input {tuple(x.shape)} {x.dtype} {x.device}")
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_backward_reference(x, g, eps, slope)
    _check_cuda_input(x, "instance_norm_leaky_relu_backward")
    g = g.contiguous(memory_format=torch.contiguous_format)
    dx = torch.empty_like(x)
    if x.numel():
        _launch("instance_norm_leaky_relu_backward", (x, g), dx, eps, slope)
        instance_norm_leaky_relu_backward.launches += 1
    return dx


class _InstanceNormLeakyReLU(torch.autograd.Function):
    """Forward kernel; backward kernel on the saved input (the JAX custom VJP
    ``_inlr_fwd``/``_inlr_bwd`` keeps ``x`` alone as its residual)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, eps: float, slope: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.eps, ctx.slope = eps, slope
        return _forward(x, eps, slope)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return instance_norm_leaky_relu_backward(x, g, ctx.eps, ctx.slope), None, None


def instance_norm_leaky_relu(x: torch.Tensor, eps: float = 1e-5,
                             slope: float = 0.01) -> torch.Tensor:
    """Fused InstanceNorm(affine=False) + LeakyReLU over NCHW input.

    CPU tensor → :func:`instance_norm_leaky_relu_reference`. CUDA tensor →
    the CUDA kernel (f32 or bf16, contiguous), counted in
    ``instance_norm_leaky_relu.launches``. When a gradient is needed the call
    goes through a ``torch.autograd.Function`` whose backward is
    :func:`instance_norm_leaky_relu_backward` (kernel or plain twin, by the
    same device rule)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instance_norm_leaky_relu: unsupported device {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        return _InstanceNormLeakyReLU.apply(x, eps, slope)
    return _forward(x, eps, slope)


instance_norm_leaky_relu.launches = 0
instance_norm_leaky_relu_backward.launches = 0
