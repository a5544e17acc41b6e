"""The port's affine InstanceNorm epilogue kernels
(``ops/instance_norm_affine.py``, ``csrc/instance_norm_affine.cu``) and their
plain twins, at SwinUNETR's UNETR norm sites.

On the CPU:

- the plain twin is ``models/blocks.py::InstanceNorm(affine=True)``, then
  the residual add, then ``F.leaky_relu``, bit for bit, forward and
  gradients, for the three site shapes (``norm1``: activation; ``norm2``:
  residual and activation; ``norm_skip``: neither), in f32, bf16 and f64;
  ``UnetrBasicBlock`` gives its former forward's bits and gradients;
- the ``torch.autograd.Function``'s backward, through the plain twins on the
  CPU (the backward's plain reference writes out the kernels' arithmetic),
  matches autograd of the plain twin: f64 to 1e-12 of each gradient's
  largest magnitude, f32 to 1e-5;
- CPU and f64 calls launch nothing; under a ``space`` group the block keeps
  the module's path; the block's parameter names; the 26 sites a 128²
  forward calls, and their launch plans.

On the card (``-m cuda``), at every one of SwinUNETR's 26 sites at 128²,
batch 2 and 64, f32 and bf16: the output bit for bit against the module's
epilogue in torch on the kernel's saved statistics; the statistics and the
output against the plain twin (f32: 1e-5 of the scale, the same arithmetic
summed in another order; bf16: four bf16 ulps of the terms of the epilogue,
since a normalised value on a rounding edge, its product and each sum after
it may each round the other way once), and the three
gradients and the residual's against the backward's plain reference on the
kernel's own output and statistics (a gradient of the twin itself would
differ wherever the two forwards put an element on either side of the
LeakyReLU's kink); two backward runs bit for bit; the refusals; and a
graphed SwinUNETR Engine counting 26 forward, 26 backward and 26
parameter-gradient launches a step and 26 forwards a validation pass.

This file imports nothing of JAX: its card tests run where JAX is absent.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_task_breast_cancer_tpu_torch.models import blocks, swin_unetr
from multi_task_breast_cancer_tpu_torch.ops import instance_norm_affine as A
from multi_task_breast_cancer_tpu_torch.ops import launches
from multi_task_breast_cancer_tpu_torch.parallel import spatial

COUNTERS = (A.instance_norm_affine, A.instance_norm_affine_backward,
            A.instance_norm_affine_param_grad)
SLOPE = 0.01
# the three shapes of a UNETR block's norm sites: (residual, activation)
KINDS = {"norm1": (False, True), "norm2": (True, True), "norm_skip": (False, False)}
# SwinUNETR's 26 sites at 128² (feature 24): (block, channels, side, kind)
SITES = [(block, c, side, kind)
         for block, c, side, kinds in (
             ("encoder0", 24, 128, ("norm1", "norm2", "norm_skip")),
             ("encoder1", 24, 64, ("norm1", "norm2")),
             ("encoder2", 48, 32, ("norm1", "norm2")),
             ("encoder3", 96, 16, ("norm1", "norm2")),
             ("encoder10", 384, 4, ("norm1", "norm2")),
             ("decoder5", 192, 8, ("norm1", "norm2", "norm_skip")),
             ("decoder4", 96, 16, ("norm1", "norm2", "norm_skip")),
             ("decoder3", 48, 32, ("norm1", "norm2", "norm_skip")),
             ("decoder2", 24, 64, ("norm1", "norm2", "norm_skip")),
             ("decoder1", 24, 128, ("norm1", "norm2", "norm_skip")))
         for kind in kinds]


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(n, c, side, kind, dtype, device="cpu", seed=0):
    """Planes offset by 5 with a spread of 2, random scale and bias, a random
    residual (where the site has one) and output gradient."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    x = randn(n, c, side, side) * 2 + 5
    scale, bias = randn(c), randn(c)
    residual = randn(n, c, side, side) if KINDS[kind][0] else None
    dy = randn(n, c, side, side)
    return tuple(None if t is None else t.to(dtype) for t in (x, scale, bias, residual, dy))


def _slope(kind):
    return SLOPE if KINDS[kind][1] else None


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_twin_is_the_module_epilogue_bit_for_bit(kind, dtype):
    x, scale, bias, residual, dy = _inputs(2, 6, 8, kind, dtype)
    norm = blocks.InstanceNorm(6, affine=True).to(dtype)
    with torch.no_grad():
        norm.scale.copy_(scale)
        norm.bias.copy_(bias)
    leaves = [t.clone().requires_grad_() for t in (x, residual) if t is not None]
    twins = [t.clone().requires_grad_() for t in (x, residual) if t is not None]
    want = norm(leaves[0])
    if residual is not None:
        want = want + leaves[1]
    if _slope(kind) is not None:
        want = F.leaky_relu(want, SLOPE)
    got = A.instance_norm_affine(twins[0], norm.scale, norm.bias, norm.eps,
                                 twins[1] if residual is not None else None, _slope(kind))
    assert got.dtype == dtype and torch.equal(got, want)
    params = [norm.scale, norm.bias]
    ga = torch.autograd.grad(got, twins + params, dy)
    gb = torch.autograd.grad(want, leaves + params, dy)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


@pytest.mark.parametrize("cin,cout", [(1, 24), (24, 24)], ids=["projected_skip", "identity"])
def test_unetr_block_gives_its_former_forward_bit_for_bit(cin, cout):
    """``UnetrBasicBlock`` on the CPU against its forward as it read before
    the kernels (module norms, ``+ skip``, ``F.leaky_relu``): output and
    every gradient equal."""
    torch.manual_seed(0)
    blk = swin_unetr.UnetrBasicBlock(cin, cout)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if "norm" in name:
                p.normal_()
    x = torch.randn(2, cin, 16, 16, requires_grad=True)

    def former(x):
        y = F.leaky_relu(blk.norm1(swin_unetr._conv(blk.conv1, x)), 0.01)
        y = blk.norm2(swin_unetr._conv(blk.conv2, y))
        skip = x if blk.conv_skip is None else blk.norm_skip(swin_unetr._conv(blk.conv_skip, x))
        return F.leaky_relu(y + skip, 0.01)

    got, want = blk(x), former(x)
    assert torch.equal(got, want)
    leaves = [x, *blk.parameters()]
    dy = torch.randn_like(got)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad(got, leaves, dy),
                                                 torch.autograd.grad(want, leaves, dy)))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_function_backward_matches_autograd_of_the_plain_twin(kind, dtype, tol):
    """The Function's forward (on the CPU the plain twins) equals the twin;
    its backward, :func:`instance_norm_affine_backward_reference` (dx,
    dresidual, dscale, dbias as the kernels compute them), matches autograd
    of the twin."""
    x, scale, bias, residual, dy = _inputs(2, 6, 8, kind, dtype, seed=3)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias, residual) if t is not None]
    twins = [t.clone().requires_grad_() for t in (x, scale, bias, residual) if t is not None]
    res = (lambda ts: ts[3] if residual is not None else None)
    y = A._InstanceNormAffine.apply(*leaves[:3], res(leaves), 1e-5, _slope(kind))
    want_y = A.instance_norm_affine_reference(*twins[:3], 1e-5, res(twins), _slope(kind))
    assert torch.equal(y, want_y)
    got = torch.autograd.grad(y, leaves, dy)
    want = torch.autograd.grad(want_y, twins, dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= tol
    if residual is not None:
        assert torch.equal(got[3], torch.where(y > 0, dy, dy * SLOPE))


def test_statistics_reference_is_the_modules_mean_and_rstd():
    x, *_ = _inputs(2, 6, 8, "norm1", torch.float32)
    stats = A.instance_norm_affine_statistics_reference(x)
    assert stats.shape == (2, 6, 2) and stats.dtype == torch.float32
    centered = x - x.mean(dim=(2, 3), keepdim=True)
    rstd = torch.rsqrt((centered * centered).mean(dim=(2, 3)) + 1e-5)
    assert torch.equal(stats[..., 0], x.mean(dim=(2, 3))) and torch.equal(stats[..., 1], rstd)
    assert A.instance_norm_affine_statistics_reference(x.bfloat16()).dtype == torch.float32
    assert A.instance_norm_affine_statistics_reference(x.double()).dtype == torch.float64


def test_cpu_and_f64_calls_launch_nothing():
    before = launches.snapshot()
    for dtype in (torch.float32, torch.float64):
        for kind in KINDS:
            x, scale, bias, residual, dy = _inputs(2, 6, 8, kind, dtype)
            x.requires_grad_()
            y = A.instance_norm_affine(x, scale, bias, 1e-5, residual, _slope(kind))
            y.backward(dy)
            A.instance_norm_affine_backward(
                x.detach(), y.detach(), dy, scale,
                A.instance_norm_affine_statistics_reference(x.detach()), _slope(kind),
                residual is not None)
    assert not {fn for fn in launches.since(before) if fn in COUNTERS}


class _OneRank(spatial.Space):
    """A ``space`` group of this process alone: its sums need no collective."""

    def gather(self, t):
        return [t.contiguous()]


def test_space_group_keeps_the_modules_path(monkeypatch):
    """Under a ``space`` group a norm site runs the module (split sums over
    the group) and torch's add and activation, and never the op."""
    def refused(*args, **kwargs):
        raise AssertionError("the op ran under a space group")

    blk = swin_unetr.UnetrBasicBlock(4, 6)
    x, _, _, residual, _ = _inputs(2, 6, 8, "norm2", torch.float32)
    with spatial.partitioned(_OneRank(size=1, index=0, ranks=(0,))):
        monkeypatch.setattr(swin_unetr, "instance_norm_affine", refused)
        got = swin_unetr._norm_epilogue(blk.norm2, x, residual=residual, slope=SLOPE)
        want = F.leaky_relu(blk.norm2(x) + residual, SLOPE)
        assert torch.equal(got, want)
        assert torch.equal(swin_unetr._norm_epilogue(blk.norm_skip, x), blk.norm_skip(x))


def test_sample_stride_reads_channel_slices_in_place():
    """A contiguous gradient and a channel slice of one (``torch.cat``'s
    backward) go to the kernel as they are; other layouts are copied."""
    whole = torch.zeros(2, 40, 8, 8)
    assert A._sample_stride(whole) == 40 * 64
    assert A._sample_stride(whole[:, 16:]) == 40 * 64
    assert A._sample_stride(whole[:1, 16:]) == 24 * 64
    assert A._sample_stride(whole.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)) is None
    assert A._sample_stride(whole[:, :, :4]) is None
    assert A._sample_stride(torch.zeros(2, 3, 1, 3)[:, 1:]) is None  # samples 9 floats apart


def test_unetr_block_parameter_names_unchanged():
    """The JAX weight bridge maps ``norm1``/``norm2``/``norm_skip``'s
    ``scale`` and ``bias`` by these names."""
    assert [n for n, _ in swin_unetr.UnetrBasicBlock(1, 24).named_parameters()] == [
        "conv1.weight", "norm1.scale", "norm1.bias", "conv2.weight", "norm2.scale",
        "norm2.bias", "conv_skip.weight", "norm_skip.scale", "norm_skip.bias"]
    assert [n for n, _ in swin_unetr.UnetrBasicBlock(24, 24).named_parameters()] == [
        "conv1.weight", "norm1.scale", "norm1.bias", "conv2.weight", "norm2.scale",
        "norm2.bias"]


def test_a_128_forward_calls_the_op_at_the_26_sites(monkeypatch):
    """The registry's SwinUNETR at 128²: one call a site, with the shapes
    of :data:`SITES`."""
    from multi_task_breast_cancer_tpu_torch.models import registry
    seen = Counter()
    op = A.instance_norm_affine

    def recorded(x, scale, bias, eps, residual=None, slope=None):
        seen[(x.shape[1], x.shape[2], residual is not None, slope is not None)] += 1
        return op(x, scale, bias, eps, residual, slope)

    monkeypatch.setattr(swin_unetr, "instance_norm_affine", recorded)
    model = registry.init_segmentation_model("SwinUNETR", size=128)
    with torch.inference_mode():
        model(torch.zeros(1, 1, 128, 128))
    assert seen == Counter((c, side, *KINDS[kind]) for _, c, side, kind in SITES)
    assert sum(seen.values()) == 26


def test_plans_at_swinunetr_sites():
    """Groups of 4-32 lanes for the 4²-16² planes (several planes a warp),
    clusters for the 32²-128² planes that fill the card at batch 2, a
    128² plane in registers; planes that are not whole vectors refused."""
    plans = {(c, side): A._plan(2 * c, side * side, torch.float32)
             for _, c, side, _ in SITES}
    assert {k: (p.variant, p.group, p.vectors) for k, p in plans.items()
            if p.variant == "group"} == {(384, 4): ("group", 4, 1), (192, 8): ("group", 16, 1),
                                         (96, 16): ("group", 32, 2)}
    for (c, side), p in plans.items():
        nvec = side * side // 4
        if p.variant == "group":
            assert p.group * p.vectors >= nvec and 32 % p.group == 0
            assert p.blocks * p.threads >= 2 * c * p.group
        else:
            assert p.cluster in (1, 2, 4, 8) and p.blocks == 2 * c * p.cluster
            assert p.cluster * p.threads * p.vectors >= nvec and p.threads % 32 == 0
            assert 2 * c * p.cluster >= 2 * 132 or p.cluster == 8
    assert plans[(24, 128)] == A.InstanceNormPlan("cluster", 8, 128, 4, 1, 384)
    assert A._plan(1536, 128 * 128, torch.float32).cluster == 4   # batch 64
    assert A._plan(2, 512 * 512, torch.float32)[:4] == ("cluster", 8, 256, 4)  # tiles
    assert A._plan(48, 16, torch.bfloat16)[:5] == ("group", 1, 64, 1, 2)
    with pytest.raises(ValueError, match="whole 16-byte"):
        A._plan(4, 9, torch.float32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a); the kernels have no CPU mode")


def _bf16_ulps(*terms: torch.Tensor) -> torch.Tensor:
    """Four bf16 ulps (2^-6 of the magnitude) of the summed magnitudes of an
    epilogue's ``terms``: the normalised value, its product with the scale
    and each sum after it may each round the other way once."""
    return 2.0 ** -6 * sum(t.float().abs() for t in terms)


def _epilogue(x, stats, scale, bias, residual, slope):
    """The module's epilogue in torch on the kernel's own statistics: the
    kernel's output bit for bit, as it rounds where torch's operations do."""
    xhat = ((x.float() - stats[..., 0, None, None]) * stats[..., 1, None, None]).to(x.dtype)
    y = xhat * scale[:, None, None] + bias[:, None, None]
    if residual is not None:
        y = y + residual
    return y if slope is None else F.leaky_relu(y, slope)


def _close(got: torch.Tensor, want: torch.Tensor, scale, slack=None) -> bool:
    err = (got.float() - want.float()).abs()
    bound = 1e-5 * scale
    if got.dtype == torch.bfloat16:
        bound = bound + (_bf16_ulps(want) if slack is None else slack)
    return bool((err <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,c,side,kind", SITES,
                         ids=[f"{b}.{k}" for b, _, _, k in SITES])
def test_cuda_kernels_match_the_plain_twin_at_swinunetr_sites(block, c, side, kind, dtype,
                                                              batch):
    _cuda_or_skip()
    x, scale, bias, residual, dy = _inputs(batch, c, side, kind, dtype, "cuda", seed=c + side)
    slope = _slope(kind)
    before = launches.snapshot()
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias, residual) if t is not None]
    y = A.instance_norm_affine(*leaves[:3], 1e-5, leaves[3] if residual is not None else None,
                               slope)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert {fn: n for fn, n in launches.since(before).items() if fn in COUNTERS} == {
        A.instance_norm_affine: 1, A.instance_norm_affine_backward: 1,
        A.instance_norm_affine_param_grad: 1}
    want_y = A.instance_norm_affine_reference(x, scale, bias, 1e-5, residual, slope)
    stats = A._forward(x, scale, bias, 1e-5, residual, slope)[1]
    want_stats = A.instance_norm_affine_statistics_reference(x)
    assert _close(stats[..., 0], want_stats[..., 0], want_stats[..., 0].abs().max().item())
    assert _close(stats[..., 1], want_stats[..., 1], want_stats[..., 1].abs().max().item())
    assert y.dtype == dtype and y.shape == x.shape
    assert torch.equal(y, _epilogue(x, stats, scale, bias, residual, slope))
    xhat = ((x.float() - want_stats[..., :1, None]) * want_stats[..., 1:, None]).to(dtype)
    terms = [xhat * scale[:, None, None], bias[:, None, None].expand_as(x)]
    terms += [] if residual is None else [residual]
    assert _close(y, want_y, max(1.0, want_y.float().abs().max().item()), _bf16_ulps(*terms))
    # the gradients against the backward's reference on the kernel's own
    # output and statistics
    want = A.instance_norm_affine_backward_reference(x, y.detach(), dy, scale, stats, slope,
                                                     residual is not None)
    dx, dscale, dbias = got[:3]
    assert _close(dx, want[0], want[0].float().abs().max().item())
    if residual is not None:
        assert torch.equal(got[3], want[1])
    dpre = want[1] if residual is not None else (
        dy if slope is None else torch.where(y.detach() > 0, dy, dy * slope))
    sums = [(dpre * xhat).float().abs().sum(dim=(0, 2, 3)), dpre.float().abs().sum(dim=(0, 2, 3))]
    for g_, w, s in zip((dscale, dbias), want[2:], sums):
        assert g_.dtype == dtype and _close(g_, w, s.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_repeats_bit_for_bit(dtype):
    """A fixed order for every sum, and no atomics: two runs equal."""
    _cuda_or_skip()
    for _, c, side, kind in SITES:
        x, scale, bias, residual, dy = _inputs(2, c, side, kind, dtype, "cuda", seed=c)
        slope = _slope(kind)
        y, stats = A._forward(x, scale, bias, 1e-5, residual, slope)
        first = A.instance_norm_affine_backward(x, y, dy, scale, stats, slope, True)
        second = A.instance_norm_affine_backward(x, y, dy, scale, stats, slope, True)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (c, side, kind)
        assert torch.equal(y, A._forward(x, scale, bias, 1e-5, residual, slope)[0])


@pytest.mark.cuda
def test_cuda_channel_slice_gradient_is_read_in_place():
    """The gradient ``torch.cat``'s backward hands a concatenated block: the
    same bits as its contiguous copy."""
    _cuda_or_skip()
    x, scale, bias, _, _ = _inputs(2, 24, 64, "norm1", torch.float32, "cuda")
    y, stats = A._forward(x, scale, bias, 1e-5, None, SLOPE)
    whole = torch.randn(2, 48, 64, 64, device="cuda")
    dy = whole[:, 24:]
    assert not dy.is_contiguous() and A._sample_stride(dy) == 48 * 64 * 64
    got = A.instance_norm_affine_backward(x, y, dy, scale, stats, SLOPE)
    want = A.instance_norm_affine_backward(x, y, dy.contiguous(), scale, stats, SLOPE)
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_tiled_planes_and_refusals():
    """A 512² plane (walked in tiles) against the twin; f16, a mismatched
    residual and a misaligned view are refused, never sent to the twin."""
    _cuda_or_skip()
    x, scale, bias, residual, _ = _inputs(2, 2, 512, "norm2", torch.float32, "cuda")
    assert A.plan_for(x).vectors * A.plan_for(x).threads * 8 < 512 * 512 // 4
    y = A.instance_norm_affine(x, scale, bias, 1e-5, residual, SLOPE)
    want = A.instance_norm_affine_reference(x, scale, bias, 1e-5, residual, SLOPE)
    assert _close(y, want, want.abs().max().item())
    with pytest.raises(TypeError, match="dtype"):
        A.instance_norm_affine(x.half(), scale.half(), bias.half())
    with pytest.raises(ValueError, match="does not match"):
        A.instance_norm_affine(x, scale, bias, 1e-5, residual[:, :1], SLOPE)
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.randn(2 * 24 * 64 + 1, device="cuda")[1:].view(2, 24, 8, 8)
        A.instance_norm_affine(flat, torch.ones(24, device="cuda"),
                               torch.zeros(24, device="cuda"))


@pytest.mark.cuda
def test_cuda_graphed_swinunetr_counts_26_launches_each_way_a_step():
    """Three one-step epochs of a graphed SwinUNETR Engine (eager, capture,
    replay) at batch 2 and 128², then a validation pass of 8 rows: 26
    forward, 26 backward and 26 parameter-gradient launches a step, 26
    forwards a validation pass (the whole split in one batch)."""
    _cuda_or_skip()
    from benchmark import data as D
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    from multi_task_breast_cancer_tpu_torch.models import registry
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
    model = registry.init_segmentation_model("SwinUNETR", size=128)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(D.seeded_state(torch, shapes, 2 ** 31 + 9, "cpu"))
    engine = Engine(model, EngineConfig(task="segmentation", batch_size=2,
                                        fast_augmentation=True), device="cuda")
    assert engine.graphed
    state = create_train_state(engine.model, "Adam", 1e-4)
    rng = np.random.default_rng(4)
    images, masks = zip(*[D.hard_image(rng, 128, ("benign", "malignant")[i % 2])
                          for i in range(8)])
    data = engine.device_data(ArrayDataset(
        images=np.stack(images)[..., None].astype(np.float32),
        masks=np.stack(masks)[..., None].astype(np.float32),
        labels=(np.arange(8) % 2).astype(np.int32), patient_ids=np.arange(8),
        class_names=["benign"] * 8, tumor_pixels=np.stack(masks).reshape(8, -1).sum(1)))
    for k in range(3):
        before = launches.snapshot()
        engine.train_epoch(state, data, np.array([2 * k, 2 * k + 1]),
                           torch.Generator().manual_seed(k))
        grown = launches.since(before)
        assert [grown.get(fn, 0) for fn in COUNTERS] == [26, 26, 26], (k, grown)
    before = launches.snapshot()
    engine.eval_epoch(state, data)
    grown = launches.since(before)
    assert [grown.get(fn, 0) for fn in COUNTERS] == [26, 0, 0], grown
