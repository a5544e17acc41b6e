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
fallback from a failed launch to the plain version, nor to another variant.

Each launch follows a plan (:func:`_plan`) decided on the host before it
from the number of planes, H·W, the type and the pointers' alignment: the
``subwarp`` variant for planes of at most 256 elements, the register-
``resident`` one up to 128 KB a plane (one block per plane, or a
thread-block cluster where one block cannot hold the plane), and the
``streaming`` one, the first design, for larger, misaligned or ragged
planes.

The forward is also the custom operator ``mtbc_torch::instance_norm_leaky_relu``
(``torch.library``: CUDA implementation the kernel, CPU implementation the
plain twin, a fake implementation for tracing, and the backward kernel as its
autograd formula), so ``torch.export`` keeps it as one node of an exported
program (``serve/export.py``). Eager calls go through the
``torch.autograd.Function``, because the operator's dispatch made the
host-bound batch-2 training step slower on an H100 by a median 4.0 % (0.5
to 4.5 % over three runs of ``chip_smoke.py`` phase 7, the two in turns);
a call made while
``torch.export`` traces goes through the operator. Both reach the one
:func:`_forward` / :func:`_backward` pair, which counts the launches.

Split statistics (a spatial partition, :mod:`..parallel.spatial`): when a
plane's rows are spread over the ranks of a ``space`` group, four more
entry points of the same source compute the norm from partial sums, each
beside its plain twin and with its own launch counter:
:func:`instance_norm_split_sums` (a plane part's Σx, then, given the
combined Σx, its Σ(x − mean)²: two passes, as the fused kernel),
:func:`instance_norm_leaky_relu_split_apply`,
:func:`instance_norm_leaky_relu_split_backward_sums` (Σdxhat, Σdxhat·xhat)
and :func:`instance_norm_leaky_relu_split_backward_apply`. The group adds
the parts of all its ranks in rank order (``space.sum_partials``), so every
rank gets the same bits. The autograd function takes the group; without one
it is the fused path above, launch for launch. The forward saves ``x`` and
the two combined f32 sums per plane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_task_breast_cancer_tpu_torch.ops import _build
from multi_task_breast_cancer_tpu_torch.ops.launches import counted

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


class NormPlan(NamedTuple):
    """How one launch covers its planes (see ``csrc/instance_norm_leaky_relu.cu``)."""

    variant: str    # "subwarp", "resident" or "streaming"
    cluster: int    # blocks per plane (a thread-block cluster when > 1)
    threads: int    # threads per block
    vectors: int    # 16-byte vectors per thread and input (0: streaming)
    group: int      # threads that share one plane
    elements: int   # elements of the plane each thread holds (or visits)
    blocks: int     # grid size


_VARIANT_CODES = {"streaming": 0, "subwarp": 1, "resident": 2}
_MAX_THREADS = 256         # the kernels' __launch_bounds__
_MAX_VECTORS = 4           # register array per thread and input, resident
_MIN_THREADS = 64          # a block keeps two warps at least
_MAX_CLUSTER = 8           # the portable cluster size
_SUBWARP_MAX_HW = 256      # elements; a 32-lane group holds it in ≤ 2 vectors


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def streaming_plan(planes: int, hw: int) -> NormPlan:
    """The first design: one block of whole warps (≤ 256 threads) per plane."""
    threads = _MAX_THREADS if hw >= _MAX_THREADS else _round_up(hw, 32)
    return NormPlan("streaming", 1, threads, 0, threads, -(-hw // threads), planes)


def _plan(planes: int, hw: int, dtype: torch.dtype, aligned: bool,
          sms: int = _build.H100_SMS) -> NormPlan:
    """The launch plan for ``planes`` planes of ``hw`` elements of ``dtype``.

    ``aligned``: every pointer of the launch is 16-byte aligned. The vector
    variants need that and whole 16-byte vectors per plane (4 f32 or 8
    bf16); otherwise, and for planes above 128 KB (more than ``_MAX_CLUSTER``
    blocks of ``_MAX_THREADS`` threads hold at ``_MAX_VECTORS`` vectors
    each), the streaming design.

    Planes of at most 256 elements go to a group of 1-32 lanes each; a block
    of 64-256 threads holds many, fewer threads where the blocks would not
    reach two per SM (``sms``). Larger planes go to one block each, and to a
    cluster only when one block of 256 threads cannot hold the plane at 4
    vectors a thread (the 128² levels): on an H100 a cluster costs more than
    the idle SMs it would fill (``norm_plan_sweep.py``, ``PERF.md``). A
    plane that needs a cluster is split further, up to 8 blocks, while the
    planes give fewer than two blocks per SM. A thread holds 4 vectors where that leaves the
    block 64 threads or more, else 2 or 1."""
    width = 16 // dtype.itemsize
    if not aligned or hw % width:
        return streaming_plan(planes, hw)
    nvec = hw // width
    if hw <= _SUBWARP_MAX_HW:
        group = min(32, 1 << (nvec - 1).bit_length())
        vectors = -(-nvec // group)
        threads = _MAX_THREADS
        while threads > _MIN_THREADS and -(-planes * group // threads) < 2 * sms:
            threads //= 2
        return NormPlan("subwarp", 1, threads, vectors, group, vectors * width,
                        -(-planes * group // threads))
    per_block = _MAX_THREADS * _MAX_VECTORS
    k = 1
    while k < _MAX_CLUSTER and nvec > k * per_block:
        k *= 2
    if nvec > k * per_block:
        return streaming_plan(planes, hw)
    while 1 < k < _MAX_CLUSTER and planes * k < 2 * sms:
        k *= 2
    vectors = _MAX_VECTORS
    while vectors > 1 and -(-nvec // (k * vectors)) < _MIN_THREADS:
        vectors //= 2
    threads = _round_up(-(-nvec // (k * vectors)), 32)
    return NormPlan("resident", k, threads, vectors, threads * k, vectors * width,
                    planes * k)


def plan_for(*tensors: torch.Tensor) -> NormPlan:
    """The plan a launch over these NCHW CUDA tensors (inputs and output,
    one shape) takes: alignment read from their pointers, SMs from their
    card."""
    n, c, h, w = tensors[0].shape
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return _plan(n * c, h * w, tensors[0].dtype, aligned,
                 _build.sm_count(tensors[0].device.index or 0))


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NCHW, got shape {tuple(x.shape)}")
    if x.dtype not in _build.DTYPE_SUFFIXES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (float32, bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be NCHW-contiguous")


def _launch(fn, inputs, out: torch.Tensor, eps: float, slope: float,
            plan: NormPlan | None) -> None:
    """Launch ``fn``'s kernel (``fn.__name__``) over ``inputs`` into ``out``
    under ``plan`` (default :func:`plan_for`), counted in ``fn.launches``.
    An empty batch (a data-mesh rank's empty shard) has no plane: nothing is
    launched or counted, and ``out`` stays empty."""
    if out.numel() == 0:
        return
    plan = plan or plan_for(*inputs, out)
    n, c, h, w = out.shape
    _build.launch(_SOURCE, fn.__name__, out.device, *inputs, out, n * c, h * w, float(eps),
                  float(slope), _build.STREAM, _VARIANT_CODES[plan.variant], plan.cluster,
                  plan.threads, plan.vectors, plan.group, dtype=out.dtype, counter=fn,
                  plan=plan)


def empty_launch(device: torch.device) -> None:
    """One launch of the library's empty kernel (the launch floor), uncounted."""
    _build.launch(_SOURCE, "instance_norm_leaky_relu_empty", device, _build.STREAM)


def _forward(x: torch.Tensor, eps: float, slope: float,
             plan: NormPlan | None = None) -> torch.Tensor:
    """The forward on ``x``'s device; ``plan`` overrides :func:`plan_for`
    (to time the streaming design beside the one the plan picks)."""
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_reference(x, eps, slope)
    _check_cuda_input(x, "instance_norm_leaky_relu")
    y = torch.empty_like(x)
    _launch(instance_norm_leaky_relu, (x,), y, eps, slope, plan)
    return y


def _backward(x: torch.Tensor, g: torch.Tensor, eps: float, slope: float,
              plan: NormPlan | None = None) -> torch.Tensor:
    """The backward on ``x``'s device; ``plan`` as in :func:`_forward`."""
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"instance_norm_leaky_relu_backward: gradient "
                         f"{tuple(g.shape)} {g.dtype} {g.device} does not match "
                         f"input {tuple(x.shape)} {x.dtype} {x.device}")
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_backward_reference(x, g, eps, slope)
    _check_cuda_input(x, "instance_norm_leaky_relu_backward")
    g = g.contiguous(memory_format=torch.contiguous_format)
    dx = torch.empty_like(x)
    _launch(instance_norm_leaky_relu_backward, (x, g), dx, eps, slope, plan)
    return dx


@counted
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
    return _backward(x, g, eps, slope)


class _InstanceNormLeakyReLU(torch.autograd.Function):
    """Forward kernel; backward kernel on the saved input (the JAX custom VJP
    ``_inlr_fwd``/``_inlr_bwd`` keeps ``x`` alone as its residual). With a
    ``space`` group: :func:`split_forward` / :func:`split_backward`, saving
    ``x`` and the two combined sums per plane."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, eps: float, slope: float, space=None) -> torch.Tensor:
        ctx.eps, ctx.slope, ctx.space = eps, slope, space
        if space is None:
            ctx.save_for_backward(x)
            return _forward(x, eps, slope)
        y, sums, sq = split_forward(x, eps, slope, space)
        ctx.save_for_backward(x, sums, sq)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        if ctx.space is None:
            (x,) = ctx.saved_tensors
            return instance_norm_leaky_relu_backward(x, g, ctx.eps, ctx.slope), None, None, None
        x, sums, sq = ctx.saved_tensors
        return split_backward(x, g, sums, sq, ctx.eps, ctx.slope, ctx.space), None, None, None


@torch.library.custom_op("mtbc_torch::instance_norm_leaky_relu", mutates_args=(),
                         device_types=("cpu", "cuda"))
def instance_norm_leaky_relu_op(x: torch.Tensor, eps: float, slope: float) -> torch.Tensor:
    """The forward as a custom operator, :func:`_forward`: on CUDA the
    kernel, on the CPU the plain twin."""
    return _forward(x, eps, slope)


@instance_norm_leaky_relu_op.register_fake
def _(x: torch.Tensor, eps: float, slope: float) -> torch.Tensor:
    return torch.empty_like(x)


def _op_setup_context(ctx, inputs, output) -> None:
    x, ctx.eps, ctx.slope = inputs
    ctx.save_for_backward(x)


def _op_backward(ctx, g: torch.Tensor):
    (x,) = ctx.saved_tensors
    return _backward(x, g, ctx.eps, ctx.slope), None, None


instance_norm_leaky_relu_op.register_autograd(_op_backward, setup_context=_op_setup_context)


@counted
def instance_norm_leaky_relu(x: torch.Tensor, eps: float = 1e-5,
                             slope: float = 0.01, space=None) -> torch.Tensor:
    """Fused InstanceNorm(affine=False) + LeakyReLU over NCHW input.

    CPU tensor → :func:`instance_norm_leaky_relu_reference`. CUDA tensor →
    the CUDA kernel (f32 or bf16, contiguous), counted in
    ``instance_norm_leaky_relu.launches``. When a gradient is needed the call
    goes through a ``torch.autograd.Function`` whose backward is
    :func:`instance_norm_leaky_relu_backward` (kernel or plain twin, by the
    same device rule). Under ``torch.export`` the call is the custom operator
    :func:`instance_norm_leaky_relu_op`, which a traced program keeps as one
    node. ``space`` (a :class:`~..parallel.spatial.Space`): ``x`` holds this
    rank's rows of every plane and the split-statistics entry points run
    instead (:func:`split_forward`); an exported program has no ``space``
    group (``NotImplementedError``)."""
    if torch.compiler.is_exporting():
        if space is not None:
            raise NotImplementedError(
                "instance_norm_leaky_relu: torch.export under spatial partitioning: an "
                "exported program has no space group; export without one")
        return instance_norm_leaky_relu_op(x, eps, slope)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"instance_norm_leaky_relu: unsupported device {x.device}")
    if x.requires_grad and torch.is_grad_enabled():
        return _InstanceNormLeakyReLU.apply(x, eps, slope, space)
    if space is not None:
        return split_forward(x, eps, slope, space)[0]
    return _forward(x, eps, slope)


# ---------------------------------------------------------------------------
# split statistics: a plane's rows in parts (the ranks of a ``space`` group)
# ---------------------------------------------------------------------------


def instance_norm_split_sums_reference(x: torch.Tensor, total: int,
                                       sums: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of the split-sums kernel: per (n, c) plane part of NCHW
    ``x``, Σx over its rows; given ``sums`` (the whole planes' combined Σx
    of ``total`` elements each), Σ(x − mean)² with ``mean = sums / total``.
    (N, C) in f32 (f64 for f64 input)."""
    xf = x.to(_compute_dtype(x))
    if sums is None:
        return xf.sum(dim=(2, 3))
    d = xf - (sums / total)[:, :, None, None]
    return (d * d).sum(dim=(2, 3))


def _split_statistics(x: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
                      total: int, eps: float):
    xf = x.to(_compute_dtype(x))
    mean = (sums / total)[:, :, None, None]
    rstd = torch.rsqrt(sq / total + eps)[:, :, None, None]
    return (xf - mean) * rstd, rstd


def instance_norm_leaky_relu_split_apply_reference(
        x: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor, total: int,
        eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """Plain twin of the split apply: ``LeakyReLU((x − mean)·rsqrt(var +
    eps))`` from the combined sums (mean ``sums/total``, var ``sq/total``),
    in f32, cast to ``x``'s dtype."""
    xhat, _ = _split_statistics(x, sums, sq, total, eps)
    return torch.where(xhat >= 0, xhat, slope * xhat).to(x.dtype)


def instance_norm_leaky_relu_split_backward_sums_reference(
        x: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
        total: int, eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """Plain twin of the split backward sums: per plane part (Σdxhat,
    Σdxhat·xhat), ``dxhat`` the gradient after the LeakyReLU; (N, C, 2)."""
    xhat, _ = _split_statistics(x, sums, sq, total, eps)
    gf = g.to(xhat.dtype)
    dxhat = torch.where(xhat >= 0, gf, slope * gf)
    return torch.stack([dxhat.sum(dim=(2, 3)), (dxhat * xhat).sum(dim=(2, 3))], dim=-1)


def instance_norm_leaky_relu_split_backward_apply_reference(
        x: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
        gsums: torch.Tensor, total: int, eps: float = 1e-5,
        slope: float = 0.01) -> torch.Tensor:
    """Plain twin of the split backward apply: ``rstd·(dxhat − G1/total −
    xhat·G2/total)`` from the combined backward sums ``gsums`` (N, C, 2)."""
    xhat, rstd = _split_statistics(x, sums, sq, total, eps)
    gf = g.to(xhat.dtype)
    dxhat = torch.where(xhat >= 0, gf, slope * gf)
    m1 = (gsums[..., 0] / total)[:, :, None, None]
    m2 = (gsums[..., 1] / total)[:, :, None, None]
    return (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)


def _planes(x: torch.Tensor):
    """(planes, elements a plane) of this part of NCHW ``x``: the split
    entries' two sizes."""
    n, c, h, w = x.shape
    return n * c, h * w


def _check_split_inputs(what: str, x: torch.Tensor, *stats: torch.Tensor,
                        g: torch.Tensor | None = None) -> None:
    _check_cuda_input(x, what)
    if g is not None and (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
                          or not g.is_contiguous()):
        raise ValueError(f"{what}: gradient {tuple(g.shape)} {g.dtype} {g.device} does not "
                         f"match input {tuple(x.shape)} {x.dtype} {x.device}, or is not "
                         "NCHW-contiguous")
    for t in stats:
        if t is not None and (t.device != x.device or t.dtype != torch.float32
                              or not t.is_contiguous() or t.shape[:2] != x.shape[:2]):
            raise ValueError(f"{what}: statistics must be contiguous f32 (N, C[, 2]) on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} {t.device}")


@counted
def instance_norm_split_sums(x: torch.Tensor, total: int,
                             sums: torch.Tensor | None = None) -> torch.Tensor:
    """A plane part's Σx (``sums`` None) or Σ(x − mean)² (``sums``: the
    combined Σx of the whole planes of ``total`` elements); (N, C) f32. CPU
    tensor → :func:`instance_norm_split_sums_reference`; CUDA tensor → the
    kernel, counted in ``instance_norm_split_sums.launches``."""
    if x.device.type == "cpu":
        return instance_norm_split_sums_reference(x, total, sums)
    _check_split_inputs("instance_norm_split_sums", x, sums)
    part = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    if x.numel():
        _build.launch(_SOURCE, "instance_norm_split_sums", x.device, x, sums, part,
                      *_planes(x), total, _build.STREAM, dtype=x.dtype,
                      counter=instance_norm_split_sums)
    return part


@counted
def instance_norm_leaky_relu_split_apply(x: torch.Tensor, sums: torch.Tensor,
                                         sq: torch.Tensor, total: int, eps: float = 1e-5,
                                         slope: float = 0.01) -> torch.Tensor:
    """Normalise and LeakyReLU a plane part from the combined sums; CPU →
    its plain twin, CUDA → the kernel (counted)."""
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_split_apply_reference(x, sums, sq, total, eps, slope)
    _check_split_inputs("instance_norm_leaky_relu_split_apply", x, sums, sq)
    y = torch.empty_like(x)
    if x.numel():
        _build.launch(_SOURCE, "instance_norm_leaky_relu_split_apply", x.device, x, sums, sq,
                      y, *_planes(x), total, float(eps), float(slope), _build.STREAM,
                      dtype=x.dtype, counter=instance_norm_leaky_relu_split_apply)
    return y


@counted
def instance_norm_leaky_relu_split_backward_sums(
        x: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
        total: int, eps: float = 1e-5, slope: float = 0.01) -> torch.Tensor:
    """A plane part's (Σdxhat, Σdxhat·xhat), (N, C, 2) f32; CPU → its plain
    twin, CUDA → the kernel (counted)."""
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_split_backward_sums_reference(
            x, g, sums, sq, total, eps, slope)
    _check_split_inputs("instance_norm_leaky_relu_split_backward_sums", x, sums, sq, g=g)
    part = torch.empty(x.shape[:2] + (2,), dtype=torch.float32, device=x.device)
    if x.numel():
        _build.launch(_SOURCE, "instance_norm_leaky_relu_split_backward_sums", x.device, x, g,
                      sums, sq, part, *_planes(x), total, float(eps), float(slope),
                      _build.STREAM, dtype=x.dtype,
                      counter=instance_norm_leaky_relu_split_backward_sums)
    return part


@counted
def instance_norm_leaky_relu_split_backward_apply(
        x: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
        gsums: torch.Tensor, total: int, eps: float = 1e-5,
        slope: float = 0.01) -> torch.Tensor:
    """A plane part's input gradient from the combined backward sums
    ``gsums``; CPU → its plain twin, CUDA → the kernel (counted)."""
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_split_backward_apply_reference(
            x, g, sums, sq, gsums, total, eps, slope)
    _check_split_inputs("instance_norm_leaky_relu_split_backward_apply", x, sums, sq,
                        gsums, g=g)
    dx = torch.empty_like(x)
    if x.numel():
        _build.launch(_SOURCE, "instance_norm_leaky_relu_split_backward_apply", x.device, x, g,
                      sums, sq, gsums, dx, *_planes(x), total, float(eps), float(slope),
                      _build.STREAM, dtype=x.dtype,
                      counter=instance_norm_leaky_relu_split_backward_apply)
    return dx


def split_forward(x: torch.Tensor, eps: float, slope: float, space):
    """The norm of this rank's rows of each plane, the parts combined by
    ``space.sum_partials`` over ``space.size`` equal parts: (y, Σx, Σ(x −
    mean)²). An empty batch launches nothing and joins no collective (every
    rank of its group has none)."""
    total = x.shape[2] * space.size * x.shape[3]
    if x.shape[0] == 0:
        empty = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
        return torch.empty_like(x), empty, empty
    sums = space.sum_partials(instance_norm_split_sums(x, total))
    sq = space.sum_partials(instance_norm_split_sums(x, total, sums))
    return instance_norm_leaky_relu_split_apply(x, sums, sq, total, eps, slope), sums, sq


def split_backward(x: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, sq: torch.Tensor,
                   eps: float, slope: float, space) -> torch.Tensor:
    """The input gradient of :func:`split_forward` on this rank's rows."""
    if x.shape[0] == 0:
        return torch.empty_like(x)
    total = x.shape[2] * space.size * x.shape[3]
    g = g.contiguous(memory_format=torch.contiguous_format)
    gsums = space.sum_partials(
        instance_norm_leaky_relu_split_backward_sums(x, g, sums, sq, total, eps, slope))
    return instance_norm_leaky_relu_split_backward_apply(x, g, sums, sq, gsums, total,
                                                         eps, slope)
