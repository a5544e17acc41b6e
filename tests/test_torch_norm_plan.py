"""The fused norm kernels' launch plan and their arithmetic, on the CPU.

``hopper_kernels._plan`` decides every launch of
``csrc/instance_norm_leaky_relu.cu`` on the host. Here it is checked at every
site of the flagship MTnnUNet (batches 1, 2 and 64, f32 and bf16) and at the
shapes that must take the streaming design. Two numpy emulations follow the
CUDA source step by step:

- the vectorised index mapping (which block, thread and slot holds which
  16-byte vector of which plane): every element is held exactly once;
- the float32 reduction order (each thread's elements in slot order, the
  butterfly within a warp or group, the warps in order, the cluster's ranks
  in order), forward and backward, held within 1e-5 of the JAX Pallas
  kernels in interpret mode on the same numpy inputs. The emulation rounds
  op by op in f32; the card may fuse a multiply-add into one FMA, a rounding
  and not an order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

# (C, H, W): sites — the 25 norm sites of one MTnnUNet forward at 128²
FLAGSHIP_SITES = {
    (32, 128, 128): 3, (16, 128, 128): 1, (64, 64, 64): 2, (32, 64, 64): 2,
    (128, 32, 32): 2, (64, 32, 32): 2, (256, 16, 16): 2, (128, 16, 16): 2,
    (320, 8, 8): 4, (256, 8, 8): 2, (512, 8, 8): 1, (320, 4, 4): 2,
}
WIDTH = {torch.float32: 4, torch.bfloat16: 8}   # elements per 16-byte vector
VECTOR_BUDGET = {"subwarp": 2, "resident": 4}   # vectors per thread and input


def test_flagship_sites_are_the_models():
    from multi_task_breast_cancer_tpu_torch.models.blocks import ConvInNormLeReLU
    from multi_task_breast_cancer_tpu_torch.models.registry import init_multitask_model

    model = init_multitask_model("MTnnUNet", generator=torch.Generator().manual_seed(0))
    seen = {}

    def hook(_m, _i, out):
        key = tuple(out.shape[1:])
        seen[key] = seen.get(key, 0) + 1

    for m in model.modules():
        if isinstance(m, ConvInNormLeReLU):
            m.register_forward_hook(hook)
    with torch.inference_mode():
        model.eval()(torch.zeros(1, 1, 128, 128))
    assert seen == FLAGSHIP_SITES and sum(seen.values()) == 25


def _check_plan_invariants(plan, planes, hw, dtype):
    width = WIDTH[dtype]
    assert plan.cluster in (1, 2, 4, 8)
    assert plan.blocks % plan.cluster == 0
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    # the threads that share a plane hold (or visit) all of it
    assert plan.group * plan.elements >= hw
    if plan.variant == "streaming":
        assert plan.cluster == 1 and plan.blocks == planes and plan.vectors == 0
        return
    nvec = hw // width
    assert hw % width == 0
    assert 1 <= plan.vectors <= VECTOR_BUDGET[plan.variant]
    assert plan.elements == plan.vectors * width
    if plan.variant == "subwarp":
        assert plan.cluster == 1 and plan.group in (1, 2, 4, 8, 16, 32)
        assert plan.blocks == -(-planes * plan.group // plan.threads)
        assert plan.group * (plan.vectors - 1) < nvec  # no slot wholly idle
    else:
        assert plan.variant == "resident"
        assert plan.group == plan.threads * plan.cluster
        assert plan.blocks == planes * plan.cluster
        assert (plan.cluster - 1) * plan.threads * plan.vectors < nvec  # no idle rank


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [1, 2, 64])
@pytest.mark.parametrize("site", sorted(FLAGSHIP_SITES, key=lambda s: -s[1]),
                         ids=lambda s: f"C{s[0]}-{s[1]}x{s[2]}")
def test_plan_at_flagship_site(site, batch, dtype):
    c, h, w = site
    planes, hw = batch * c, h * w
    plan = hk._plan(planes, hw, dtype, aligned=True)
    _check_plan_invariants(plan, planes, hw, dtype)
    assert plan.variant == ("subwarp" if hw <= 256 else "resident")
    if plan.variant == "resident":
        # a cluster only where one block of 256 threads cannot hold the plane
        # at 4 vectors a thread: the 128² levels (64 KB f32, 32 KB bf16)
        fits_one_block = hw // WIDTH[dtype] <= 256 * VECTOR_BUDGET["resident"]
        assert (plan.cluster == 1) == fits_one_block
        assert (plan.cluster > 1) == (h == 128)
        assert plan.threads >= 64
        if batch <= 2 and h == 128:
            assert plan.cluster == 8  # few planes: spread over the card


@pytest.mark.parametrize("planes,hw,dtype,aligned,variant,cluster", [
    (2, 256 * 256, torch.float32, True, "streaming", 1),   # 256 KB planes
    (128, 256 * 256, torch.float32, True, "streaming", 1),
    (2, 256 * 256, torch.bfloat16, True, "resident", 8),   # 128 KB: still in registers
    (2, 7 * 9, torch.float32, True, "streaming", 1),       # H·W not whole vectors
    (2, 7 * 9, torch.bfloat16, True, "streaming", 1),
    (64, 128 * 128, torch.float32, False, "streaming", 1),  # misaligned pointer
    (640, 16, torch.bfloat16, False, "streaming", 1),
    (3, 8, torch.bfloat16, True, "subwarp", 1),            # one vector, a group of one lane
])
def test_plan_edge_cases(planes, hw, dtype, aligned, variant, cluster):
    plan = hk._plan(planes, hw, dtype, aligned)
    _check_plan_invariants(plan, planes, hw, dtype)
    assert (plan.variant, plan.cluster) == (variant, cluster)


def test_plan_uses_the_cards_sm_count():
    """Fewer SMs need fewer blocks: the split follows the card it is given."""
    many = hk._plan(64, 128 * 128, torch.float32, True, sms=132)
    few = hk._plan(64, 128 * 128, torch.float32, True, sms=16)
    assert (many.cluster, few.cluster) == (8, 4)
    assert hk._plan(64, 128 * 128, torch.float32, True) == many


def test_streaming_plan_is_the_first_design():
    assert hk.streaming_plan(5, 16) == hk.NormPlan("streaming", 1, 32, 0, 32, 1, 5)
    assert hk.streaming_plan(5, 16384).threads == 256


# ---------------------------------------------------------------------------
# Index mapping, as the kernels compute it.

def _grid_ownership(plan, planes, hw, width):
    """Flat element index (plane·H·W + offset) held by every (block, thread,
    slot, element) of the launch; -1 where the slot is masked or the thread
    serves no plane."""
    nvec = hw // width
    t = np.arange(plan.threads)[None, :, None]
    s = np.arange(plan.vectors)[None, None, :]
    if plan.variant == "resident":
        b = np.arange(planes * plan.cluster)[:, None, None]
        plane = b // plan.cluster
        rank = b - plane * plan.cluster
        j = rank * plan.vectors * plan.threads + s * plan.threads + t
    else:
        blocks = -(-planes * plan.group // plan.threads)
        gt = np.arange(blocks)[:, None, None] * plan.threads + t
        plane = gt // plan.group
        j = s * plan.group + (gt & (plan.group - 1))
    ok = (plane < planes) & (j < nvec)
    idx = (plane * hw + j * width)[..., None] + np.arange(width)
    return np.where(ok[..., None], idx, -1)


@pytest.mark.parametrize("hw,plan_planes", [
    (16, 640), (64, 640), (256, 512), (16, 40960), (64, 131072),   # subwarp
    (272, 64), (576, 64), (1024, 256), (4096, 128),                # resident, one block
    (8192, 2048), (16384, 2048), (16384, 64),                      # f32: clusters of 2, 4, 8
    (256 * 256 // 2, 2),                                           # bf16 128 KB planes
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_every_element_is_held_exactly_once(hw, plan_planes, dtype):
    """The plan is made for ``plan_planes`` planes (its cluster, threads and
    vectors follow from that count); its mapping is emulated over 3 planes
    (odd, so a subwarp block ends with dead threads)."""
    plan = hk._plan(plan_planes, hw, dtype, aligned=True)
    assert plan.variant != "streaming"
    planes = 3
    owned = _grid_ownership(plan, planes, hw, WIDTH[dtype]).ravel()
    counts = np.bincount(owned[owned >= 0], minlength=planes * hw)
    assert counts.shape == (planes * hw,) and (counts == 1).all()


# ---------------------------------------------------------------------------
# Reduction order, as the kernels compute it, in float32.

F32 = np.float32


def _butterfly(a, width):
    """``group_sum``: xor-shuffle steps width/2 … 1 over the last axis."""
    lanes = np.arange(a.shape[-1])
    off = width // 2
    while off:
        a = a + a[..., lanes ^ off]
        off //= 2
    return a


def _in_order(a):
    """``lane_order_sum``: a[..., 0] + a[..., 1] + … left to right."""
    t = a[..., 0]
    for r in range(1, a.shape[-1]):
        t = t + a[..., r]
    return t


class _Emulated:
    """One plan's per-plane mapping and reductions over (planes, H·W) f32."""

    def __init__(self, plan, hw, width=4):
        nvec = hw // width
        s = np.arange(plan.vectors)
        if plan.variant == "resident":
            rank = np.arange(plan.cluster)[:, None, None]
            t = np.arange(plan.threads)[None, :, None]
            j = (rank * plan.vectors * plan.threads + s * plan.threads + t)
            j = j.reshape(plan.cluster * plan.threads, plan.vectors)
        else:
            j = s[None, :] * plan.group + np.arange(plan.group)[:, None]
        self.plan = plan
        idx = (j * width)[..., None] + np.arange(width)        # (threads, V, width)
        self.valid = np.broadcast_to((j < nvec)[..., None], idx.shape).reshape(len(j), -1)
        self.idx = np.where(self.valid, idx.reshape(len(j), -1), 0)

    def gather(self, a):
        return a[:, self.idx]                                   # (planes, threads, E)

    def thread_sums(self, vals):
        acc = np.zeros(vals.shape[:2], F32)
        for e in range(vals.shape[2]):                          # slot-major, in order
            acc = np.where(self.valid[:, e], acc + vals[:, :, e], acc)
        return acc

    def total(self, vals):
        acc = self.thread_sums(vals)
        p = self.plan
        if p.variant == "subwarp":
            return _butterfly(acc, p.group)[:, 0]
        warps = acc.reshape(acc.shape[0], p.cluster, p.threads // 32, 32)
        blocks = _in_order(_butterfly(warps, 32)[..., 0])      # (planes, cluster)
        return _in_order(blocks)


def _statistics(em, x, eps):
    inv = F32(1) / F32(x.shape[1])
    xv = em.gather(x)
    mean = em.total(xv) * inv
    d = xv - mean[:, None, None]
    rstd = F32(1) / np.sqrt(em.total(d * d) * inv + F32(eps))
    return xv, mean, rstd, inv


def _emulated_forward(plan, x, eps, slope):
    em = _Emulated(plan, x.shape[1])
    _, mean, rstd, _ = _statistics(em, x, eps)
    xhat = (x - mean[:, None]) * rstd[:, None]
    return np.where(xhat >= 0, xhat, F32(slope) * xhat)


def _emulated_backward(plan, x, g, eps, slope):
    em = _Emulated(plan, x.shape[1])
    xv, mean, rstd, inv = _statistics(em, x, eps)
    xh = (xv - mean[:, None, None]) * rstd[:, None, None]
    gv = em.gather(g)
    dxh = np.where(xh >= 0, gv, F32(slope) * gv)
    m1 = em.total(dxh) * inv
    m2 = em.total(dxh * xh) * inv
    xhat = (x - mean[:, None]) * rstd[:, None]
    dxhat = np.where(xhat >= 0, g, F32(slope) * g)
    return rstd[:, None] * (dxhat - m1[:, None] - xhat * m2[:, None])


def _kink_free(rng, shape):
    """NHWC planes of 5 ± 2·(|N(0,1)| + 0.1) in ± pairs: no normalised value
    within ~0.05 of the LeakyReLU's kink, where two summation orders may
    choose different gradient branches."""
    b, h, w, c = shape
    a = np.abs(rng.standard_normal((b, c, h * w // 2))) + 0.1
    z = np.concatenate([a, -a], axis=2)
    z = np.take_along_axis(z, rng.random((b, c, h * w)).argsort(axis=2), axis=2)
    return (5 + 2 * z).reshape(b, c, h, w).transpose(0, 2, 3, 1).astype(np.float32)


def _planes(a):
    """NHWC -> (N·C, H·W)."""
    b, h, w, c = a.shape
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2)).reshape(b * c, h * w)


# (NHWC shape, planes the plan is made for): subwarp groups of 4, 16 and 32
# lanes; one resident block of 64 and 256 threads; clusters of 2, 4 and 8
# blocks (64×128 planes at batch-64-like counts, 128² at batch 64 and at
# batch 2)
EMULATED = [
    ((2, 4, 4, 8), 640), ((2, 8, 8, 8), 640), ((1, 16, 16, 8), 256),
    ((1, 32, 32, 4), 128), ((1, 64, 64, 2), 64), ((1, 64, 128, 2), 2048),
    ((1, 128, 128, 2), 2048), ((1, 128, 128, 2), 64),
]


def _emulated_ids(case):
    (b, h, w, c), planes = case
    plan = hk._plan(planes, h * w, torch.float32, True)
    return f"{h}x{w}-{plan.variant}-k{plan.cluster}-t{plan.threads}-v{plan.vectors}"


@pytest.mark.parametrize("case", EMULATED, ids=_emulated_ids)
def test_emulated_forward_matches_jax_pallas(case):
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import pallas_kernels as pk

    shape, plan_planes = case
    plan = hk._plan(plan_planes, shape[1] * shape[2], torch.float32, True)
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 5).astype(np.float32)
    want = np.asarray(pk.instance_norm_leaky_relu(jnp.asarray(x), 1e-5, 0.01, True))
    got = _emulated_forward(plan, _planes(x), 1e-5, 0.01)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _planes(want), rtol=0, atol=1e-5)
    plain = hk.instance_norm_leaky_relu_reference(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got, plain.reshape(got.shape).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", EMULATED, ids=_emulated_ids)
def test_emulated_backward_matches_jax_pallas_vjp(case):
    import jax
    import jax.numpy as jnp

    from multi_task_breast_cancer_tpu.ops import pallas_kernels as pk

    shape, plan_planes = case
    plan = hk._plan(plan_planes, shape[1] * shape[2], torch.float32, True)
    rng = np.random.default_rng(sum(shape) + 1)
    x = _kink_free(rng, shape)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: pk.instance_norm_leaky_relu(a, 1e-5, 0.01, True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    got = _emulated_backward(plan, _planes(x), _planes(g), 1e-5, 0.01)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _planes(np.asarray(want)), rtol=0, atol=1e-5)
