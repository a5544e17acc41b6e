"""Fast augmentation: joint flips + 3-shear (Paeth) nearest rotation of the
packed fold stack, one hand-written CUDA kernel per training step (twin of
``multi_task_breast_cancer_tpu/ops/fast_augment.py``,
``training.fast_augmentation``, on by default).

The hflip → vflip → rotate pipeline canonicalises into

    G1 → T → G2 → T → G3 → T^(q mod 2)

where each ``G`` is a row-wise gather ``out[y, x] = src[y, idx_k[y, x]]`` with
zero fill for an index outside ``[0, S)`` and ``T`` a transpose; flips and
quadrant rotations fold into the gather indices exactly. The rotation is
resampled once per shear, so pixels near a boundary may land one position
from the exact single-gather rotation (:mod:`..data.augment`, PARITY D13).

Data layout, as in the JAX package: the fold's (N, H, W, C)
[masks | image] stack is packed once per fold into (N, P, S, S) int32 planes
(:func:`pack_channels`): f32 bitcasts each channel to its own plane, bf16
packs channel pairs into one int32; H×W sits centred in the square canvas S
of :func:`plan_canvas` (kept identical to the JAX plan, so both paths resample
the same canvas and agree bit for bit).

Executors: :func:`reference_pipeline` (plain PyTorch, the staged gathers) and
:func:`fast_augment` (the CUDA kernel ``csrc/fast_augment.cu`` on CUDA
tensors, the plain twin on CPU tensors). The kernel composes the three
stages into one gather per output pixel (see the source), which is pure
integer indexing and therefore bit-identical to the staged executor.

Draws are ``(fh, fv, angle)`` per sample from an explicit ``torch.Generator``
(:func:`draw_flips_and_angles`); JAX's key splits cannot be reproduced, so the
tests feed the same draws to both packages.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.ops import _build

_LANE = 128  # the JAX kernel's lane width: kept so both packages plan one canvas


# ---------------------------------------------------------------------------
# channel packing (2 × bf16 → int32, or 1 × f32 → int32)
# ---------------------------------------------------------------------------


def pack_bf16x2(stack: torch.Tensor) -> torch.Tensor:
    """(..., 2) → (...) int32 holding ``(u16(ch0) << 16) | u16(ch1)`` of the
    bf16 values. Computed in int32 arithmetic: the signed high half times
    2^16 is exactly the bit pattern, and cannot overflow."""
    bits = stack.to(torch.bfloat16).contiguous().view(torch.int16).to(torch.int32)
    return bits[..., 0] * 65536 + (bits[..., 1] & 0xFFFF)


def unpack_bf16x2(packed: torch.Tensor) -> torch.Tensor:
    """(...) int32 → (..., 2) bf16."""
    hi = packed >> 16                         # arithmetic: already in int16 range
    lo = packed & 0xFFFF
    lo = lo - (lo >= 32768).to(torch.int32) * 65536
    halves = torch.stack([hi, lo], dim=-1).to(torch.int16)
    return halves.view(torch.bfloat16)


class AugFormat(NamedTuple):
    """Static descriptor of a packed augmentation stack."""
    n_channels: int    # original channel count C
    n_planes: int      # int32 planes per sample P
    dtype: str         # 'bfloat16' | 'float32'
    height: int        # original H
    width: int         # original W
    canvas: int        # padded square side S


def plan_canvas(h: int, w: int) -> int:
    """Smallest square canvas the JAX kernel accepts for an H×W image with
    integral centred margins: the next multiple of 8 up to 128, else the next
    multiple of 128 (H and W even; :func:`pack_channels` pads odd dims)."""
    m = max(h, w, 8)
    if m <= _LANE:
        return -(-m // 8) * 8
    return -(-m // _LANE) * _LANE


def pack_channels(stack: torch.Tensor, compute_dtype: str
                  ) -> Tuple[torch.Tensor, AugFormat]:
    """(N, H, W, C) float stack → ((N, P, S, S) int32 planes, AugFormat).

    bf16: channel pairs per int32 (odd C zero-padded); f32: one channel per
    plane (bitcast). The image sits centred in the S×S canvas with zero
    margins (zero bits decode to 0.0). Odd H/W get one bottom/right zero row
    or column first, as in the JAX package (a ≤1-px shift of the centre,
    joint for masks and image); :func:`unpack_channels` crops the original
    H×W back out."""
    n, h, w, c = stack.shape
    ph, pw = h + (h % 2), w + (w % 2)
    if (ph, pw) != (h, w):
        stack = F.pad(stack, (0, 0, 0, pw - w, 0, ph - h))
    s = plan_canvas(ph, pw)
    if compute_dtype == "bfloat16":
        x = stack.to(torch.bfloat16)
        if c % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        planes = pack_bf16x2(x.reshape(*x.shape[:-1], -1, 2))
    elif compute_dtype == "float32":
        planes = stack.to(torch.float32).contiguous().view(torch.int32)
    else:
        raise ValueError(f"unsupported compute_dtype {compute_dtype!r}")
    planes = planes.permute(0, 3, 1, 2)            # (N, P, PH, PW)
    oy, ox = (s - ph) // 2, (s - pw) // 2
    planes = F.pad(planes, (ox, s - pw - ox, oy, s - ph - oy))
    planes = planes.contiguous(memory_format=torch.contiguous_format)
    fmt = AugFormat(n_channels=c, n_planes=planes.shape[1], dtype=compute_dtype,
                    height=h, width=w, canvas=s)
    return planes, fmt


def unpack_channels_nchw(out: torch.Tensor, fmt: AugFormat) -> torch.Tensor:
    """(B, P, S, S) int32 → (B, C, H, W) in the compute dtype: centred crop
    and channel unpacking, the inverse of :func:`pack_channels`. A view of
    ``out`` where it can be (f32); call ``.contiguous()`` before a kernel."""
    oy = (fmt.canvas - fmt.height) // 2
    ox = (fmt.canvas - fmt.width) // 2
    out = out[:, :, oy:oy + fmt.height, ox:ox + fmt.width]
    if fmt.dtype == "bfloat16":
        chans = unpack_bf16x2(out.permute(0, 2, 3, 1))            # (B,H,W,P,2)
        chans = chans.reshape(*chans.shape[:3], 2 * fmt.n_planes)
        return chans[..., :fmt.n_channels].permute(0, 3, 1, 2)
    return out.view(torch.float32)


def unpack_channels(out: torch.Tensor, fmt: AugFormat) -> torch.Tensor:
    """(B, P, S, S) int32 kernel output → (B, H, W, C) in the compute dtype
    (the JAX package's layout)."""
    return unpack_channels_nchw(out, fmt).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# per-sample draws and pipeline parameters
# ---------------------------------------------------------------------------


def draw_flips_and_angles(generator: torch.Generator, shape, *, p_hflip: float,
                          p_vflip: float, max_angle: float
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample ``(fh, fv, angle)``: flips with probabilities ``p_hflip`` /
    ``p_vflip``, angle uniform in ``[-max_angle, max_angle)`` (torchvision
    ``RandomRotation(max_angle)``), drawn on the generator's device."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    u = torch.rand(*shape, 3, generator=generator, device=generator.device)
    angle = (2.0 * u[..., 2] - 1.0) * max_angle
    return u[..., 0] < p_hflip, u[..., 1] < p_vflip, angle


def _fold_pre_L(cond, d, c, s, w):
    return (torch.where(cond, -d, d), torch.where(cond, w - 1 - c, c),
            torch.where(cond[:, None], -s, s))


def _fold_post_L(cond, d, c, s, w):
    return (torch.where(cond, -d, d), torch.where(cond, c + d * (w - 1), c), s)


def _relabel_rows(cond, s):
    return torch.where(cond[:, None], s.flip(-1), s)


def pipeline_params_from_draws(fh: torch.Tensor, fv: torch.Tensor,
                               angle: torch.Tensor, w: int,
                               device: Optional[Union[str, torch.device]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold per-sample flips and angles into the pipeline's gather indices:
    ``(idx (B, 3, W, W) int32, t1 (B,) int32)``, the JAX function's
    arithmetic in f32 step for step (round half to even, ``remainder`` for
    ``jnp.mod``).

    The per-sample shifts are computed on the draws' device (the CPU in the
    Engine, so the card and the CPU get the same integers from the same
    draws); ``idx`` is expanded on ``device`` (default: the draws')."""
    angle = angle.to(torch.float32)
    c_mid = (w - 1) / 2.0
    ang = torch.remainder(angle + 180.0, 360.0) - 180.0
    qf = torch.round(ang / 90.0)
    phi = ang - 90.0 * qf
    q = torch.remainder(qf.to(torch.int32), 4)
    a = torch.tan(torch.deg2rad(phi) / 2.0)
    bsh = -torch.sin(torch.deg2rad(phi))

    y = torch.arange(w, dtype=torch.float32, device=angle.device) - c_mid
    s1 = -torch.round(a[:, None] * y[None, :]).to(torch.int32)   # (B, W)
    s2 = -torch.round(bsh[:, None] * y[None, :]).to(torch.int32)
    s3 = s1
    ones = torch.ones_like(q)
    d1 = d2 = d3 = ones
    c1 = c2 = c3 = torch.zeros_like(q)

    # flips (applied before the shears)
    d1, c1, s1 = _fold_pre_L(fh, d1, c1, s1, w)
    s1 = _relabel_rows(fv, s1)
    d2, c2, s2 = _fold_pre_L(fv, d2, c2, s2, w)

    # quadrant rotations (applied after the shears), unrolled
    step1 = q >= 1
    d3, c3, s3 = _fold_post_L(step1, d3, c3, s3, w)
    step2 = q >= 2
    s3 = _relabel_rows(step2, s3)
    d2, c2, s2 = _fold_post_L(step2, d2, c2, s2, w)
    step3 = q >= 3
    d3, c3, s3 = _fold_post_L(step3, d3, c3, s3, w)
    t1 = torch.remainder(q, 2).to(torch.int32)

    dev = angle.device if device is None else torch.device(device)
    d = torch.stack([d1, d2, d3], dim=1).to(dev)[:, :, None, None]   # (B,3,1,1)
    c = torch.stack([c1, c2, c3], dim=1).to(dev)[:, :, None, None]
    s = torch.stack([s1, s2, s3], dim=1).to(dev)[:, :, :, None]      # (B,3,W,1)
    iota_x = torch.arange(w, dtype=torch.int32, device=dev)
    idx = d * iota_x + c + s                                          # (B,3,W,W)
    return idx.to(torch.int32), t1.to(dev)


def build_pipeline_params(generator: torch.Generator, b: int, w: int, *,
                          p_hflip: float, p_vflip: float, max_angle: float,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``b`` samples' flips and angles from ``generator`` and fold them
    into ``(idx, t1)`` (:func:`pipeline_params_from_draws`)."""
    fh, fv, angle = draw_flips_and_angles(generator, b, p_hflip=p_hflip,
                                          p_vflip=p_vflip, max_angle=max_angle)
    return pipeline_params_from_draws(fh, fv, angle, w, device)


# ---------------------------------------------------------------------------
# executors: the plain staged pipeline and the CUDA kernel
# ---------------------------------------------------------------------------


def _gather_stage(x: torch.Tensor, idx: torch.Tensor, w: int) -> torch.Tensor:
    ok = (idx >= 0) & (idx < w)
    out = torch.gather(x, -1, idx.clamp(0, w - 1).to(torch.int64))
    return torch.where(ok, out, torch.zeros_like(out))


def reference_pipeline(planes: torch.Tensor, idx: torch.Tensor,
                       t1: torch.Tensor) -> torch.Tensor:
    """Plain executor of the fixed pipeline: planes (B, W, W), idx
    (B, 3, W, W), t1 (B,) — three staged gathers with transposes."""
    w = planes.shape[-1]
    x = _gather_stage(planes, idx[:, 0], w)
    x = x.transpose(-1, -2)
    x = _gather_stage(x, idx[:, 1], w)
    x = x.transpose(-1, -2)
    x = _gather_stage(x, idx[:, 2], w)
    return torch.where((t1 > 0)[:, None, None], x.transpose(-1, -2), x)


def fast_augment_reference(packed: torch.Tensor, batch_idx: torch.Tensor,
                           idx: torch.Tensor, t1: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel: rows ``batch_idx`` of the (N, P, S, S)
    stack, then :func:`reference_pipeline` on every plane with its sample's
    parameters. Returns (B, P, S, S) int32."""
    planes = packed.index_select(0, batch_idx.to(torch.int64))
    return torch.stack([reference_pipeline(planes[:, p], idx, t1)
                        for p in range(planes.shape[1])], dim=1)


def _entry():
    fn = _build.library("fast_augment").fast_augment_i32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fast_augment(packed: torch.Tensor, batch_idx: torch.Tensor, idx: torch.Tensor,
                 t1: torch.Tensor) -> torch.Tensor:
    """Batch selection + the joint flip/rotate pipeline on packed planes:
    ``packed`` (N, P, S, S) int32, ``batch_idx`` (B,), ``idx`` (B, 3, S, S)
    int32, ``t1`` (B,) → (B, P, S, S) int32.

    CPU tensors → :func:`fast_augment_reference`. CUDA tensors → the kernel
    ``csrc/fast_augment.cu`` (one launch for all B·P planes), counted in
    ``fast_augment.launches``. ``batch_idx`` must lie in ``[0, N)``: the
    values are not read back from the card, and the kernel writes zeros for
    a row outside it."""
    if packed.dim() != 4 or packed.shape[-1] != packed.shape[-2]:
        raise ValueError(f"fast_augment: packed must be (N, P, S, S), got {tuple(packed.shape)}")
    n, p, s, _ = packed.shape
    b = batch_idx.shape[0]
    if tuple(idx.shape) != (b, 3, s, s) or tuple(t1.shape) != (b,):
        raise ValueError(f"fast_augment: idx {tuple(idx.shape)} / t1 {tuple(t1.shape)} "
                         f"do not match batch {b} and canvas {s}")
    if packed.device.type == "cpu":
        return fast_augment_reference(packed, batch_idx, idx, t1)
    if packed.device.type != "cuda":
        raise ValueError(f"fast_augment: unsupported device {packed.device}")
    tensors = [packed, batch_idx, idx, t1]
    if any(t.device != packed.device for t in tensors):
        raise ValueError("fast_augment: all inputs must be on one device")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("fast_augment: packed, batch_idx, idx and t1 must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fast_augment: inputs must be contiguous")
    out = torch.empty((b, p, s, s), dtype=torch.int32, device=packed.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(packed.device):
        err = _entry()(packed.data_ptr(), batch_idx.data_ptr(), idx.data_ptr(),
                       t1.data_ptr(), out.data_ptr(), n, b, p, s,
                       torch.cuda.current_stream(packed.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_augment: CUDA launch failed with error {err} "
                           f"at packed {tuple(packed.shape)}, batch {b}")
    fast_augment.launches += 1
    return out


fast_augment.launches = 0


def fast_joint_transform(packed: torch.Tensor, batch_idx: torch.Tensor,
                         draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                         fmt: AugFormat) -> torch.Tensor:
    """Batch selection + joint flips/rotation on the (N, P, S, S) packed fold
    stack of :func:`pack_channels`, with the per-sample ``draws = (fh, fv,
    angle)`` (:func:`draw_flips_and_angles`): the cropped (B, H, W, C) batch
    in the compute dtype (the JAX layout). The single-device path only: the
    JAX mesh branch has no counterpart here yet."""
    idx, t1 = pipeline_params_from_draws(*draws, packed.shape[-1], packed.device)
    out = fast_augment(packed, batch_idx.to(device=packed.device, dtype=torch.int32),
                       idx, t1)
    return unpack_channels(out, fmt)
