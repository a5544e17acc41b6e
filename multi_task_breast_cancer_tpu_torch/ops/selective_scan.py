"""Mamba's selective scan as one hand-written CUDA kernel forward and two
backward, beside its plain PyTorch twin.

The function (``mamba_ssm``'s ``selective_scan_fn`` with ``delta_softplus``
and ``z`` given; Gu & Dao 2023, Algorithm 2), per sample and channel ``d`` of
``d_inner`` over the ``L`` steps, with ``N = 16`` states::

    delta_l = softplus(dhat_l + delta_bias[d])
    h_l     = exp(delta_l · A[d]) ⊙ h_{l−1} + delta_l · u_l · B_l,   h_{−1} = 0
    y_l     = h_l · C_l + D[d] · u_l
    out_l   = y_l · SiLU(z_l)

Layout: channels last. ``u``, ``dhat`` (the step before its bias and
softplus), ``z`` and the output are ``(batch, L, d_inner)``; ``B`` and ``C``
are ``(batch, L, N)``; ``A`` is ``(d_inner, N)``; ``D`` and ``delta_bias``
are ``(d_inner,)``. On the card each of ``u``, ``dhat``, ``z``, ``B`` and
``C`` may be a view whose rows are evenly spaced (a slice of the layer's
projections): it is read in place, and ``B`` and ``C`` are read as one row
where ``C`` continues ``B``'s.

Dispatch is by what the input shows and nothing else, as
:mod:`.layer_norm`'s: a tensor off the card, an f64 tensor, or a call while
``torch.compile`` or ``torch.export`` traces takes the plain twin
(:func:`selective_scan_reference`, the recurrence step by step); a CUDA
tensor in f32 launches the kernel or raises (no bf16 build: U-Mamba's layer
runs its state-space model in f32). There is no fallback from a failed
launch. Calls that need a gradient go through a ``torch.autograd.Function``
whose forward saves every state for the backward.

Launches, each counted where it launches (:mod:`.launches`): the forward
(:func:`selective_scan`, one a layer), the backward's reverse scan with the
per-block partials (:func:`selective_scan_backward`) and their fixed-order
sums (:func:`selective_scan_reduce`): 6, 6 and 6 a U-Mamba_Enc training
step, 6 forwards a validation pass. The CUDA source is
``csrc/selective_scan.cu``; both scans cut each sequence into segments along
L, joined by their decay and end state, as :func:`scan_plan` lays them out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.ops import _build
from multi_task_breast_cancer_tpu_torch.ops.launches import counted

_SOURCE = "selective_scan"
D_STATE = 16  # the kernel's states a channel
LANES = 32    # the kernel's channels a warp: d_inner is a multiple of it
WARPS = 8     # a block's warps at most, one segment each
# clusters of each size an H100 SXM holds at once at one block an SM, largest
# size first, up to 16 blocks (Hopper's non-portable largest), by
# cudaOccupancyMaxActiveClusters of both kernels at 8 warps: its GPCs hold
# fewer than 132 / size
H100_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}
MIN_STEPS = 16    # a segment's fewest steps: shorter, the join costs more than it saves


class ScanPlan(NamedTuple):
    """How both scan kernels lay a scan on the card: each of the ``batch ·
    d_inner / 32`` chain groups (32 channels of a sample) takes a cluster of
    ``cluster`` blocks of ``warps`` warps, a warp one segment of ``steps``
    steps (the last ones may fall short or be empty)."""

    cluster: int
    warps: int
    steps: int
    blocks: int  # of the launch: at 8 warps one an SM, by their shared memory
    chains: int  # independent chains the forward runs: groups × segments

    @property
    def segments(self) -> int:
        return self.cluster * self.warps


def scan_plan(batch: int, dn: int, steps: int) -> ScanPlan:
    """The launch plan of a scan of ``batch`` × ``steps`` rows of ``dn``
    channels, from those shapes alone: up to :data:`WARPS` segments a block
    of at least :data:`MIN_STEPS` steps, and the most blocks a cluster (a
    size of :data:`H100_CLUSTERS`) at which an H100 holds every chain
    group's cluster at once, so that no cluster waits for a second wave."""
    groups = batch * (dn // LANES)
    most = max(1, steps // MIN_STEPS)  # segments of MIN_STEPS the sequence holds
    warps = min(WARPS, most)
    cluster = next(size for size, at_once in H100_CLUSTERS.items()
                   if size * warps <= most and (groups <= at_once or size == 1))
    seg = max(1, -(-steps // (cluster * warps)))
    return ScanPlan(cluster, warps, seg, groups * cluster, groups * cluster * warps)


def selective_scan_reference(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                             z: torch.Tensor, delta_bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the forward kernel: the recurrence one step at a
    time, each step one ``addcmul`` over (batch, d_inner, N); autograd's
    gradient through it."""
    dt = F.softplus(delta + delta_bias)
    decay = torch.exp(dt[..., None] * A)           # (batch, L, d_inner, N)
    push = (dt * u)[..., None] * B[:, :, None, :]  # (batch, L, d_inner, N)
    h = decay.new_zeros(decay.shape[:1] + decay.shape[2:])
    states = []
    for step in range(u.shape[1]):
        h = torch.addcmul(push[:, step], decay[:, step], h)
        states.append(h)
    hs = torch.stack(states, dim=1) if states else decay
    y = (hs * C[:, :, None, :]).sum(dim=-1) + D * u
    return y * F.silu(z)


def _plain(u: torch.Tensor) -> bool:
    """Whether a call on ``u`` takes the plain twin: off the card, f64, or
    inside a trace."""
    return (u.device.type != "cuda" or u.dtype == torch.float64
            or torch.compiler.is_compiling() or torch.compiler.is_exporting())


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------


def _rows(t: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``t`` (batch, L, W) and its row stride, where its rows are
    unit-strided and evenly spaced with each sample's L rows in a run (a
    slice of a contiguous tensor's last axis); else a contiguous copy."""
    n, steps, _ = t.shape
    row = t.stride(1)
    if (t.stride(2) == 1 or t.shape[2] == 1) and row >= t.shape[2] and (
            n == 1 or t.stride(0) == steps * row):
        return t, row
    t = t.contiguous()
    return t, t.stride(1)


def _bc_rows(B: torch.Tensor, C: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """One (batch, L, 2N) row source of [B | C]: ``B`` itself where ``C``
    continues each of its rows, else the two concatenated."""
    if (B.stride() == C.stride() and B.stride(2) == 1
            and C.data_ptr() == B.data_ptr() + B.shape[2] * B.element_size()):
        bc = B.as_strided((B.shape[0], B.shape[1], 2 * B.shape[2]), B.stride())
        return _rows(bc)
    return _rows(torch.cat([B, C], dim=-1))


def _check_cuda(u: torch.Tensor, A: torch.Tensor, *others: torch.Tensor) -> None:
    if u.dtype != torch.float32:
        raise TypeError(f"selective_scan: dtype {u.dtype} not supported on the card "
                        "(float32; float64 takes the plain twin)")
    if u.dim() != 3:
        raise ValueError(f"selective_scan: expected (batch, L, d_inner) rows, got "
                         f"{tuple(u.shape)}")
    batch, steps, dn = u.shape
    if dn % LANES or A.shape != (dn, D_STATE):
        raise ValueError(f"selective_scan: the kernel takes d_inner a multiple of {LANES} "
                         f"and {D_STATE} states, got A {tuple(A.shape)} for d_inner {dn}")
    for t in (A, *others):
        if t.dtype != u.dtype or t.device != u.device:
            raise ValueError(f"selective_scan: {tuple(t.shape)} {t.dtype} {t.device} does "
                             f"not match u's {u.dtype} {u.device}")


def _forward(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, D: torch.Tensor, z: torch.Tensor, delta_bias: torch.Tensor,
             save: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, states) on the card: one launch of the forward kernel; the
    states ``(batch, L, N, d_inner)`` where ``save``, else None."""
    _check_cuda(u, A, delta, B, C, D, z, delta_bias)
    batch, steps, dn = u.shape
    out = torch.empty((batch, steps, dn), dtype=u.dtype, device=u.device)
    states = (torch.empty((batch, steps, D_STATE, dn), dtype=u.dtype, device=u.device)
              if save else None)
    if out.numel():
        (u, su), (delta, sd), (z, sz), (bc, sbc) = (_rows(u), _rows(delta), _rows(z),
                                                    _bc_rows(B, C))
        plan = scan_plan(batch, dn, steps)
        _build.launch(_SOURCE, "selective_scan_forward", u.device, u, delta, z, bc,
                      A.contiguous(), D.contiguous(), delta_bias.contiguous(), out, states,
                      batch, steps, dn, su, sd, sz, sbc, plan.cluster, plan.warps, plan.steps,
                      _build.STREAM, dtype=u.dtype, counter=selective_scan, plan=plan)
    return out, states


@counted
def selective_scan_reduce(part_bc: torch.Tensor, part_a: torch.Tensor, part_d: torch.Tensor,
                          part_bias: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dB, dC, dA, dD, ddelta_bias) from the backward kernel's partials:
    ``part_bc`` (groups, batch, L, 2N) added over the channel groups,
    ``part_a`` (parts, d_inner, N), ``part_d`` and ``part_bias`` (parts,
    d_inner) over their parts (each sample's cluster blocks), each in order;
    counted in ``selective_scan_reduce.launches``."""
    groups, batch, steps, _ = part_bc.shape
    parts, dn = part_a.shape[:2]
    dbc = part_bc.new_empty((batch, steps, 2 * D_STATE))
    dA = part_a.new_empty((dn, D_STATE))
    dD, dbias = part_d.new_empty(dn), part_d.new_empty(dn)
    _build.launch(_SOURCE, "selective_scan_reduce", part_bc.device, part_bc, part_a, part_d,
                  part_bias, dbc, dA, dD, dbias, groups, parts, batch, steps, dn,
                  _build.STREAM, dtype=part_bc.dtype, counter=selective_scan_reduce)
    return dbc[..., :D_STATE], dbc[..., D_STATE:], dA, dD, dbias


@counted
def selective_scan_backward(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                            z: torch.Tensor, delta_bias: torch.Tensor,
                            states: Optional[torch.Tensor],
                            dout: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(du, ddelta, dA, dB, dC, dD, dz, ddelta_bias) of
    :func:`selective_scan` on the card from its inputs, the states its
    forward saved and the output's gradient ``dout``: one launch of the
    reverse scan (counted in ``selective_scan_backward.launches``), then
    :func:`selective_scan_reduce`. Off the card the gradient is autograd's
    through :func:`selective_scan_reference`."""
    _check_cuda(u, A, delta, B, C, D, z, delta_bias, dout)
    batch, steps, dn = u.shape
    if not u.numel():
        zeros = torch.zeros_like
        return (zeros(u), zeros(u), zeros(A), zeros(B), zeros(C), zeros(D), zeros(u),
                zeros(D))
    (u, su), (delta, sd), (z, sz), (bc, sbc), (dout, sg) = (
        _rows(u), _rows(delta), _rows(z), _bc_rows(B, C), _rows(dout))
    du, ddelta, dz = (torch.empty((batch, steps, dn), dtype=u.dtype, device=u.device)
                      for _ in range(3))
    plan = scan_plan(batch, dn, steps)
    parts = batch * plan.cluster
    part_bc = u.new_empty((dn // LANES, batch, steps, 2 * D_STATE))
    part_a = u.new_empty((parts, dn, D_STATE))
    part_d, part_bias = u.new_empty((parts, dn)), u.new_empty((parts, dn))
    _build.launch(_SOURCE, "selective_scan_backward", u.device, u, delta, z, bc,
                  A.contiguous(), D.contiguous(), delta_bias.contiguous(), dout, states, du,
                  ddelta, dz, part_bc, part_a, part_d, part_bias, batch, steps, dn, su, sd,
                  sz, sbc, sg, plan.cluster, plan.warps, plan.steps, _build.STREAM,
                  dtype=u.dtype, counter=selective_scan_backward, plan=plan)
    dB, dC, dA, dD, dbias = selective_scan_reduce(part_bc, part_a, part_d, part_bias)
    return du, ddelta, dA, dB, dC, dD, dz, dbias


def occupancy(plan: ScanPlan, device) -> dict:
    """What ``device``'s card makes of ``plan``: the blocks of each scan
    kernel an SM holds at once, the clusters of the plan's size the card
    holds at once (``cudaOccupancyMaxActiveClusters``) and each kernel's
    dynamic shared memory a block."""
    out = torch.zeros(6, dtype=torch.int32)
    _build.launch(_SOURCE, "selective_scan_occupancy", device, plan.cluster, plan.warps, out,
                  _build.STREAM)
    blocks, clusters, shared = out.view(3, 2).tolist()
    return {kernel: {"blocks_per_sm": blocks[i], "clusters": clusters[i],
                     "shared_bytes": shared[i]}
            for i, kernel in enumerate(("forward", "backward"))}


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, saving its inputs and every state; the backward
    kernels on them."""

    @staticmethod
    def forward(ctx, u, delta, A, B, C, D, z, delta_bias):
        out, states = _forward(u, delta, A, B, C, D, z, delta_bias, save=True)
        ctx.save_for_backward(u, delta, A, B, C, D, z, delta_bias, states)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout: torch.Tensor):
        u, delta, A, B, C, D, z, delta_bias, states = ctx.saved_tensors
        return selective_scan_backward(u, delta, A, B, C, D, z, delta_bias, states, dout)


@counted
def selective_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                   delta_bias: torch.Tensor) -> torch.Tensor:
    """The selective scan of ``u`` (batch, L, d_inner) with step ``delta``
    before its bias and softplus, state matrix ``A`` (d_inner, N), input
    and output projections ``B``, ``C`` (batch, L, N), skip ``D``, gate
    ``z`` and ``delta_bias``; the gated output (batch, L, d_inner).

    Off the card, in f64 or inside a trace: :func:`selective_scan_reference`.
    A CUDA tensor in f32 (every input of its dtype and device, d_inner a
    multiple of 32, N = 16): the forward kernel, counted in
    ``selective_scan.launches``, through a ``torch.autograd.Function`` when
    a gradient is needed."""
    if _plain(u):
        return selective_scan_reference(u, delta, A, B, C, D, z, delta_bias)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (u, delta, A, B, C, D, z, delta_bias)):
        return _SelectiveScan.apply(u, delta, A, B, C, D, z, delta_bias)
    return _forward(u, delta, A, B, C, D, z, delta_bias, save=False)[0]
