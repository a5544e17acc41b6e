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

The index planes are affine, ``idx_k[y, x] = d_k·x + c_k + s_k[y]``: the
draws fold into :class:`PipelineFactors` (3·(S+2)+1 integers per sample,
:func:`pipeline_factors_from_draws`), and the JAX package's (B, 3, S, S)
planes are their expansion (:func:`expand_factors`).

Executors: :func:`reference_pipeline` (plain PyTorch, the staged gathers on
the expanded planes) and :func:`fast_augment` (the CUDA kernel
``csrc/fast_augment.cu`` on CUDA tensors, the plain twin on CPU tensors).
The kernel takes the factors and composes the three stages into one gather
per output pixel (see the source), which is pure integer indexing and
therefore bit-identical to the staged executor. Its launch plan
(:func:`_plan`) is decided on the host from B·P, S and the card's SM count.
Both executors return a (B, P, S, S) view of plane-major (P, B, S, S)
storage, so a one-channel slice of the batch is an NCHW tensor as it is.

Draws are ``(fh, fv, angle)`` per sample from an explicit ``torch.Generator``
(:func:`draw_flips_and_angles`); JAX's key splits cannot be reproduced, so the
tests feed the same draws to both packages.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.ops import _build
from multi_task_breast_cancer_tpu_torch.ops.launches import counted

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
    and channel unpacking, the inverse of :func:`pack_channels`.

    f32: a view of ``out``. bf16: one copy. Each int32 holds channel ``2p``
    in its high half and ``2p + 1`` in its low half, so on a little-endian
    device the int32 planes read as bf16 are (low, high) pairs: every channel
    is a strided view, and one ``torch.stack`` writes them out channel-major,
    (C, B, H, W) storage returned as a (B, C, H, W) view, so a one-channel
    slice of the batch has exact NCHW strides (as the f32 planes do)."""
    oy = (fmt.canvas - fmt.height) // 2
    ox = (fmt.canvas - fmt.width) // 2
    out = out[:, :, oy:oy + fmt.height, ox:ox + fmt.width]
    if fmt.dtype == "bfloat16":
        pairs = out.view(torch.bfloat16).unflatten(-1, (fmt.width, 2))  # (B,P,H,W,2)
        chans = [pairs[:, c // 2, :, :, 1 - c % 2] for c in range(fmt.n_channels)]
        return torch.stack(chans, dim=0).transpose(0, 1)
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


class PipelineFactors(NamedTuple):
    """The pipeline's gather indices in factored form: stage ``k``'s index
    plane is ``idx_k[y, x] = d[k] * x + c[k] + s[k, y]`` (:func:`expand_factors`)."""
    d: torch.Tensor    # (..., 3) int32: each stage's slope, ±1
    c: torch.Tensor    # (..., 3) int32: each stage's offset
    s: torch.Tensor    # (..., 3, S) int32: each stage's shift per row
    t1: torch.Tensor   # (...,) int32: 1 where the final transpose applies


def pipeline_factors_from_draws(fh: torch.Tensor, fv: torch.Tensor,
                                angle: torch.Tensor, w: int,
                                device: Optional[Union[str, torch.device]] = None
                                ) -> PipelineFactors:
    """Fold per-sample flips and angles into the pipeline's gather factors
    (:class:`PipelineFactors`, 3·(W+2)+1 integers per sample), the JAX
    function's arithmetic in f32 step for step (round half to even,
    ``remainder`` for ``jnp.mod``).

    The factors are computed on the draws' device (the CPU in the Engine, so
    the card and the CPU get the same integers from the same draws) and then
    moved to ``device`` (default: the draws')."""
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
    return PipelineFactors(*(t.to(device=dev, dtype=torch.int32) for t in (
        torch.stack([d1, d2, d3], dim=1), torch.stack([c1, c2, c3], dim=1),
        torch.stack([s1, s2, s3], dim=1), t1)))


def expand_factors(factors: PipelineFactors) -> Tuple[torch.Tensor, torch.Tensor]:
    """The factors as the staged pipeline's index planes: ``(idx (..., 3, W,
    W) int32, t1)`` with ``idx = d·iota + c + s`` (the JAX package's form)."""
    d, c, s, t1 = factors
    iota_x = torch.arange(s.shape[-1], dtype=torch.int32, device=s.device)
    idx = d[..., None, None] * iota_x + c[..., None, None] + s[..., None]
    return idx.to(torch.int32), t1


def pipeline_params_from_draws(fh: torch.Tensor, fv: torch.Tensor,
                               angle: torch.Tensor, w: int,
                               device: Optional[Union[str, torch.device]] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX function's output: ``(idx (B, 3, W, W) int32, t1 (B,) int32)``,
    the expansion (:func:`expand_factors`) of
    :func:`pipeline_factors_from_draws`, on ``device``."""
    return expand_factors(pipeline_factors_from_draws(fh, fv, angle, w, device))


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
                           factors: PipelineFactors) -> torch.Tensor:
    """Plain twin of the kernel: rows ``batch_idx`` of the (N, P, S, S)
    stack, then :func:`reference_pipeline` on every plane with its sample's
    index planes (the factors expanded, :func:`expand_factors`). Returns
    (B, P, S, S) int32, a view of plane-major (P, B, S, S) storage, as the
    kernel does."""
    idx, t1 = expand_factors(factors)
    planes = packed.index_select(0, batch_idx.to(torch.int64))
    return torch.stack([reference_pipeline(planes[:, p], idx, t1)
                        for p in range(planes.shape[1])], dim=0).transpose(0, 1)


class AugPlan(NamedTuple):
    """How one launch covers its B·P planes (see ``csrc/fast_augment.cu``)."""

    variant: str    # "staged" or "direct"
    split: int      # blocks per plane
    threads: int    # threads per block
    blocks: int     # grid size
    smem: int       # dynamic shared memory per block, bytes


_VARIANT_CODES = {"staged": 0, "direct": 1}
_CHUNK = 128             # output pixels of a row segment, a warp's step
_PAD = 4                 # words of padding per staged row
_MAX_SMEM = 232448       # shared memory one block may use on an H100
_MAX_THREADS = 1024      # the kernel's __launch_bounds__
_DIRECT_THREADS = 256    # direct gathers: many small blocks (measured on an H100)


def _smem_bytes(variant: str, s: int) -> int:
    """The kernel's dynamic shared memory for one block: the plane it
    stages (staged: S rows at S + 4 words) and the three s vectors."""
    held = {"staged": s, "direct": 0}[variant]
    pitch = s if variant == "direct" else s + _PAD
    return 4 * (held * pitch + 3 * s)


def _units(s: int) -> int:
    """Row segments of up to 128 pixels per plane: a warp computes one at a
    time."""
    return s * -(-s // _CHUNK)


def make_plan(variant: str, split: int, b: int, planes: int, s: int,
              threads: Optional[int] = None) -> AugPlan:
    """The plan of ``variant`` with ``split`` blocks per plane: by default as
    many warps as the block's share of row segments needs, at most 32."""
    threads = threads or min(_MAX_THREADS, 32 * -(-_units(s) // split))
    return AugPlan(variant, split, threads, b * planes * split, _smem_bytes(variant, s))


def _plan(b: int, planes: int, s: int, sms: int = _build.H100_SMS) -> AugPlan:
    """The launch plan for ``b`` samples of ``planes`` S×S planes, chosen by
    timing every plan on an H100 (``chip_smoke.py`` phase 6, ``PERF.md``).

    A plane that one block can hold in shared memory (S ≤ 128) is staged
    there, one block of up to 32 warps per plane; where the planes would
    leave most SMs (``sms``) idle, the output of each plane is split over up
    to 8 blocks (B·P = 4 at the training step's batch of 2: 8 blocks). A
    larger plane is gathered directly from device memory by blocks of 8
    warps, up to 32 per plane and 8 per SM."""
    split = 1
    if _smem_bytes("staged", s) <= _MAX_SMEM:
        while split < 8 and split * 2 <= _units(s) and b * planes * split * 8 <= sms:
            split *= 2
        return make_plan("staged", split, b, planes, s)
    while split < 32 and split * 2 <= _units(s) and b * planes * split * 2 <= 8 * sms:
        split *= 2
    return make_plan("direct", split, b, planes, s, _DIRECT_THREADS)


def candidate_plans(b: int, planes: int, s: int) -> list:
    """Every plan the kernel takes at this shape, the plan of :func:`_plan`
    among them: staged (where the plane fits) and direct, 1-32 blocks per
    plane (at most one per row segment), with as many warps as the block's
    segments need or 8."""
    units = _units(s)
    plans = [make_plan(v, k, b, planes, s, threads) for v in ("staged", "direct")
             for k in (1, 2, 4, 8, 16, 32) if k <= units for threads in (None, _DIRECT_THREADS)]
    return list(dict.fromkeys(pl for pl in plans if pl.smem <= _MAX_SMEM
                              and pl.threads <= 32 * -(-units // pl.split)))


def plan_for(packed: torch.Tensor, b: int) -> AugPlan:
    """The plan a launch over ``b`` samples of this (N, P, S, S) CUDA stack
    takes: SMs from its card."""
    _, p, s, _ = packed.shape
    return _plan(b, p, s, _build.sm_count(packed.device.index or 0))


def _check_factors(factors, b: int, s: int) -> PipelineFactors:
    factors = PipelineFactors(*factors)
    want = {"d": (b, 3), "c": (b, 3), "s": (b, 3, s), "t1": (b,)}
    got = {k: tuple(v.shape) for k, v in factors._asdict().items()}
    if got != want:
        raise ValueError(f"fast_augment: factors {got} do not match batch {b} and "
                         f"canvas {s} (want {want})")
    return factors


@counted
def fast_augment(packed: torch.Tensor, batch_idx: torch.Tensor, factors: PipelineFactors,
                 plan: Optional[AugPlan] = None) -> torch.Tensor:
    """Batch selection + the joint flip/rotate pipeline on packed planes:
    ``packed`` (N, P, S, S) int32, ``batch_idx`` (B,) int32, ``factors``
    (:class:`PipelineFactors` of B samples) → (B, P, S, S) int32, a view of
    plane-major (P, B, S, S) storage: ``out[:, p]`` is contiguous, so a
    one-channel slice of the batch has exact NCHW strides.

    CPU tensors → :func:`fast_augment_reference`. CUDA tensors → the kernel
    ``csrc/fast_augment.cu`` (one launch for all B·P planes) under ``plan``
    (default :func:`plan_for`), counted in ``fast_augment.launches``; a plan
    the kernel does not take raises. ``batch_idx`` must lie in ``[0, N)``:
    the values are not read back from the card, and the kernel writes zeros
    for a row outside it."""
    if packed.dim() != 4 or packed.shape[-1] != packed.shape[-2]:
        raise ValueError(f"fast_augment: packed must be (N, P, S, S), got {tuple(packed.shape)}")
    n, p, s, _ = packed.shape
    b = batch_idx.shape[0]
    factors = _check_factors(factors, b, s)
    if packed.device.type == "cpu":
        return fast_augment_reference(packed, batch_idx, factors)
    if packed.device.type != "cuda":
        raise ValueError(f"fast_augment: unsupported device {packed.device}")
    tensors = [packed, batch_idx, *factors]
    if any(t.device != packed.device for t in tensors):
        raise ValueError("fast_augment: all inputs must be on one device")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("fast_augment: packed, batch_idx and the factors must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fast_augment: inputs must be contiguous")
    out = torch.empty((p, b, s, s), dtype=torch.int32, device=packed.device)
    if out.numel() == 0:
        return out.transpose(0, 1)
    plan = plan or plan_for(packed, b)
    _build.launch("fast_augment", "fast_augment_i32", packed.device, packed, batch_idx,
                  *factors, out, n, b, p, s, _build.STREAM, _VARIANT_CODES[plan.variant],
                  plan.split, plan.threads, counter=fast_augment, plan=plan)
    return out.transpose(0, 1)


def fast_joint_transform(packed: torch.Tensor, batch_idx: torch.Tensor,
                         draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                         fmt: AugFormat, mesh=None) -> torch.Tensor:
    """Batch selection + joint flips/rotation on the (N, P, S, S) packed fold
    stack of :func:`pack_channels`, with the per-sample ``draws = (fh, fv,
    angle)`` (:func:`draw_flips_and_angles`) of the B rows ``batch_idx``: the
    cropped (B, H, W, C) batch in the compute dtype (the JAX layout).

    Under a data ``mesh`` (:class:`~..parallel.mesh.DataMesh`; the JAX
    ``shard_map`` branch) the draws are the global batch's, made once; this
    rank launches the kernel on its own ``mesh.shard(B)`` rows only and
    returns those (B / n, H, W, C) rows, bit-identical to the same rows of
    the single-device batch. B must divide evenly over the ranks of the
    ``data`` axis: under a ``(data × space)`` mesh every rank of a ``space``
    group gets its data shard's whole planes, as in JAX."""
    if mesh is not None:
        b, n_data = batch_idx.shape[0], mesh.data.world_size
        if b % n_data:
            raise ValueError(f"fast_augmentation under a data mesh needs batch_size ({b}) "
                             f"divisible by the {n_data} ranks of its data axis")
        shard = mesh.shard(b)
        batch_idx, draws = batch_idx[shard], tuple(d[shard] for d in draws)
    factors = pipeline_factors_from_draws(*draws, packed.shape[-1], packed.device)
    out = fast_augment(packed, batch_idx.to(device=packed.device, dtype=torch.int32),
                       factors)
    return unpack_channels(out, fmt)
