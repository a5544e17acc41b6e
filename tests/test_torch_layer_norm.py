"""The port's LayerNorm kernels (``ops/layer_norm.py``, ``csrc/layer_norm.cu``)
and their plain twins.

On the CPU:

- the plain twin is the formula ``models/blocks.py::LayerNorm`` ran before
  the kernels, bit for bit, forward and gradients, in f32 and f64, with
  constant rows where E[x²] − E[x]² rounds below 0 and the clamp is active;
- the saved statistics flag those rows (a negative rstd);
- the ``torch.autograd.Function``'s backward, through the plain twins on the
  CPU, matches autograd of the plain twin, the clamp's rows included: f64
  to 1e-12 of each gradient's largest magnitude, f32 to 1e-5 (the same
  arithmetic summed in another order);
- CPU and f64 calls launch nothing; the launch plans at SwinUNETR's widths.

On the card (``-m cuda``), at the 8 (rows, C) pairs of SwinUNETR's 20 sites
at batch 2 and 128², f32 and bf16: the forward, the saved statistics and
all three gradients against the plain twin on the card. f32: 1e-5 of the
output's scale (y; the inputs' offset of 5 costs the fast variance about
three bits), of dx's largest magnitude, and, for dscale and dbias, of the
column's sum of absolute terms: the same f32 arithmetic summed in another
order (and fused multiply-adds). bf16: one bf16 ulp (2^-7) of the value
beside that, against the plain twin run in f32 on the same values and
rounded once, as the kernels compute in f32 and round once (autograd of the
twin in bf16 rounds each of dx's two paths, through the statistics and
direct, before adding them, up to two ulps more). Two backward runs equal
bit for bit; a permuted input; the clamp's rows given explicitly; and a
graphed SwinUNETR Engine counting 20 forward, 20 backward and 20
parameter-gradient launches a step and 20 forwards a validation pass.

This file imports nothing of JAX: its card tests run where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.models import blocks
from multi_task_breast_cancer_tpu_torch.ops import launches
from multi_task_breast_cancer_tpu_torch.ops import layer_norm as L

COUNTERS = (L.layer_norm, L.layer_norm_backward, L.layer_norm_param_grad)
# (rows, C) of SwinUNETR's LayerNorm sites at batch 2 and 128²: the blocks'
# norm1/norm2 of stages 0-3, then the four merges
SWIN_SITES = [(8192, 24), (2048, 48), (512, 96), (128, 192),
              (2048, 96), (512, 192), (128, 384), (32, 768)]


def _parent_formula(x, scale, bias, eps=1e-6):
    """``blocks.LayerNorm.forward`` as it read before the kernels:
    ``_fast_stats`` then ``_f32_normalize(..., channels_last=True)``."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(dt)
    mean = xf.mean(dim=(-1,), keepdim=True)
    var = ((xf * xf).mean(dim=(-1,), keepdim=True) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + eps) * scale.to(dt).reshape((-1,))
    return ((x.to(dt) - mean) * mul + bias.to(dt).reshape((-1,))).to(x.dtype)


def _inputs(rows, c, dtype, device="cpu", seed=0):
    """Rows offset by 5 with a spread of 2, random scale and bias, a random
    output gradient; on the CPU rows 1 and 3 are constant: 0.7 (the clamp is
    active in f32 over 24 channels) and 0.1 (a tiny positive variance)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, c, generator=g, device=device) * 2 + 5
    if device == "cpu":
        x[1], x[3] = 0.7, 0.1
    scale = torch.randn(c, generator=g, device=device)
    bias = torch.randn(c, generator=g, device=device)
    dy = torch.randn(rows, c, generator=g, device=device)
    return x.to(dtype), scale.to(dtype), bias.to(dtype), dy.to(dtype)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_twin_is_the_parent_formula_bit_for_bit(dtype):
    x, scale, bias, dy = _inputs(6, 24, dtype)
    assert L.layer_norm_statistics_reference(x)[1, 1] < 0 or dtype == torch.float64
    m = blocks.LayerNorm(24).to(dtype)
    with torch.no_grad():
        m.scale.copy_(scale)
        m.bias.copy_(bias)
    xa = x.clone().requires_grad_()
    xb = x.clone().requires_grad_()
    got = m(xa)
    want = _parent_formula(xb, m.scale, m.bias)
    assert torch.equal(got, want)
    assert torch.equal(L.layer_norm_reference(x, scale, bias), want.detach())
    ga = torch.autograd.grad(got, [xa, m.scale, m.bias], dy)
    gb = torch.autograd.grad(want, [xb, m.scale, m.bias], dy)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))


def test_statistics_flag_the_clamped_rows():
    x, *_ = _inputs(6, 24, torch.float32)
    stats = L.layer_norm_statistics_reference(x)
    assert stats.shape == (6, 2) and stats.dtype == torch.float32
    raw = (x * x).mean(-1) - x.mean(-1) ** 2
    assert torch.equal(stats[:, 1] < 0, raw < 0) and bool((raw < 0).any())
    assert torch.equal(stats[:, 0], x.mean(-1))
    assert torch.allclose(stats[1, 1], torch.tensor(-1e3), rtol=1e-6)  # −rsqrt(0 + eps)
    assert L.layer_norm_statistics_reference(x.double()).dtype == torch.float64


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape", [(6, 24), (2, 4, 4, 48)], ids=["rows", "tokens"])
def test_function_backward_matches_autograd_of_the_plain_twin(dtype, tol, shape):
    x, scale, bias, dy = _inputs(int(np.prod(shape[:-1])), shape[-1], dtype)
    x, dy = x.reshape(shape), dy.reshape(shape)
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y = L._LayerNorm.apply(*leaves, 1e-6)
    got = torch.autograd.grad(y, leaves, dy)
    twins = [t.clone().requires_grad_() for t in (x, scale, bias)]
    want_y = L.layer_norm_reference(*twins)
    want = torch.autograd.grad(want_y, twins, dy)
    assert torch.equal(y, want_y)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= tol
    # the clamp's row: its gradient has no variance term (torch's clamp
    # passes none below 0), as the formula drops it
    flat = x.reshape(-1, shape[-1])
    if dtype == torch.float32 and shape == (6, 24):
        assert L.layer_norm_statistics_reference(flat)[1, 1] < 0


def test_cpu_and_f64_calls_launch_nothing():
    before = launches.snapshot()
    for dtype in (torch.float32, torch.float64):
        x, scale, bias, dy = _inputs(6, 24, dtype)
        x.requires_grad_()
        y = L.layer_norm(x, scale, bias)
        y.backward(dy)
        L.layer_norm_backward(x.detach(), dy, scale, L.layer_norm_statistics_reference(x))
    assert not {fn for fn in launches.since(before) if fn in COUNTERS}


def test_plans_at_swinunetr_widths():
    """One warp, or a group of 4-16 lanes, a row in 16-byte chunks; the
    backward's partials at most 8 blocks per SM; rows that are not whole
    chunks, or too wide for the registers, refused."""
    plans = {(rows, c): L._plan(rows, c, torch.float32) for rows, c in SWIN_SITES}
    assert [(p.group, p.vectors) for p in plans.values()] == [
        (8, 1), (16, 1), (32, 1), (32, 2), (32, 1), (32, 2), (32, 4), (32, 8)]
    for (rows, c), p in plans.items():
        assert p.group * p.vectors * 4 >= c
        assert p.blocks * p.threads >= rows * p.group and p.parts <= 8 * 132
        assert p.threads // p.group * c * 4 <= 48 * 1024
    assert L._plan(8192, 24, torch.bfloat16)[:2] == (4, 1)
    assert L._plan(10 ** 6, 24, torch.float32).parts == 8 * 132
    with pytest.raises(ValueError, match="whole 16-byte"):
        L._plan(100, 12, torch.bfloat16)
    with pytest.raises(ValueError, match="wider"):
        L._plan(4, 2048, torch.float32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a); the kernels have no CPU mode")


def _close(got: torch.Tensor, want: torch.Tensor, scale) -> bool:
    """f32: within 1e-5 of ``scale``; bf16: one bf16 ulp of the value
    beside that."""
    err = (got.float() - want.float()).abs()
    bound = 1e-5 * scale
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.float().abs()
    return bool((err <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", SWIN_SITES, ids=lambda v: str(v))
def test_cuda_kernels_match_the_plain_twin_at_swinunetr_sites(dtype, rows, c):
    _cuda_or_skip()
    x, scale, bias, dy = _inputs(rows, c, dtype, "cuda", seed=rows + c)
    x = x.reshape(2, rows // 2, c)  # a batch of 2 images' tokens
    dy = dy.reshape(x.shape)
    before = launches.snapshot()
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    y = L.layer_norm(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert {fn: n for fn, n in launches.since(before).items() if fn in COUNTERS} == {
        L.layer_norm: 1, L.layer_norm_backward: 1, L.layer_norm_param_grad: 1}
    # the plain twin in f32 on the same values, each result rounded once to
    # the working type, as the kernels round (for bf16, autograd of the
    # twin itself casts each of dx's two paths to bf16 before adding them)
    twins = [t.float().requires_grad_() for t in (x, scale, bias)]
    want_y = L.layer_norm_reference(*twins)
    want = [w.to(dtype) for w in torch.autograd.grad(want_y, twins, dy.float())]
    want_y = want_y.to(dtype)
    assert y.dtype == dtype and y.shape == x.shape
    assert _close(y, want_y, max(1.0, want_y.float().abs().max().item()))
    stats = L._forward(x, scale, bias, 1e-6)[1]
    want_stats = L.layer_norm_statistics_reference(x)
    assert _close(stats[..., 0], want_stats[..., 0], want_stats[..., 0].abs().max().item())
    assert _close(stats[..., 1], want_stats[..., 1], want_stats[..., 1].abs().max().item())
    dx, dscale, dbias = got
    assert _close(dx, want[0], want[0].float().abs().max().item())
    xhat = (x.float() - want_stats[..., :1]) * want_stats[..., 1:].abs()
    terms = (dy.float() * xhat).abs().reshape(-1, c).sum(0)
    assert dscale.dtype == dtype and _close(dscale, want[1], terms.max().item())
    assert _close(dbias, want[2], dy.float().abs().reshape(-1, c).sum(0).max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_repeats_bit_for_bit(dtype):
    """A fixed order for every sum, and no atomics: two runs equal."""
    _cuda_or_skip()
    for rows, c in SWIN_SITES:
        x, scale, bias, dy = _inputs(rows, c, dtype, "cuda", seed=c)
        stats = L._forward(x, scale, bias, 1e-6)[1]
        first = L.layer_norm_backward(x, dy, scale, stats)
        second = L.layer_norm_backward(x, dy, scale, stats)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), (rows, c)


@pytest.mark.cuda
def test_cuda_clamped_rows_drop_the_variance_term():
    """Rows whose saved rstd is negative (the clamp was active) against the
    backward's plain twin on the same statistics."""
    _cuda_or_skip()
    x, scale, bias, dy = _inputs(512, 96, torch.float32, "cuda", seed=3)
    stats = L._forward(x, scale, bias, 1e-6)[1]
    stats[::3, 1] = -stats[::3, 1]
    got = L.layer_norm_backward(x, dy, scale, stats)
    want = L.layer_norm_backward_reference(x, dy, scale, stats)
    assert _close(got[0], want[0], want[0].abs().max().item())
    kept = L.layer_norm_backward_reference(x, dy, scale, stats.abs())[0]
    assert not torch.allclose(got[0][::3], kept[::3])
    assert torch.equal(got[0][1::3], L.layer_norm_backward(x, dy, scale, stats.abs())[0][1::3])


@pytest.mark.cuda
def test_cuda_permuted_input_and_refusals():
    """The patch embedding's NCHW output seen as NHWC is copied once and
    normalised as its contiguous twin; f16, mismatched parameters and a
    misaligned view are refused, never sent to the plain twin."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(1)
    nchw = torch.randn(2, 24, 64, 64, generator=g, device="cuda")
    scale, bias = torch.randn(24, device="cuda"), torch.randn(24, device="cuda")
    tokens = nchw.permute(0, 2, 3, 1)
    assert not tokens.is_contiguous()
    leaf = tokens.detach().requires_grad_()
    y = L.layer_norm(leaf, scale, bias)
    y.backward(torch.ones_like(y))
    assert torch.equal(y, L.layer_norm(tokens.contiguous(), scale, bias))
    assert leaf.grad.shape == tokens.shape
    with pytest.raises(TypeError, match="dtype"):
        L.layer_norm(tokens.half(), scale.half(), bias.half())
    with pytest.raises(ValueError, match="parameter"):
        L.layer_norm(tokens.contiguous(), scale.double(), bias)
    with pytest.raises(ValueError, match="16-byte boundary"):
        L.layer_norm(torch.randn(24 * 8 + 1, device="cuda")[1:].view(8, 24), scale, bias)


@pytest.mark.cuda
def test_cuda_graphed_swinunetr_counts_20_launches_each_way_a_step():
    """Three one-step epochs of a graphed SwinUNETR Engine (eager, capture,
    replay) at batch 2 and 128², then a validation pass of 8 rows: 20
    forward, 20 backward and 20 parameter-gradient launches a step, 20
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
        assert [grown.get(fn, 0) for fn in COUNTERS] == [20, 20, 20], (k, grown)
    before = launches.snapshot()
    engine.eval_epoch(state, data)
    grown = launches.since(before)
    assert [grown.get(fn, 0) for fn in COUNTERS] == [20, 0, 0], grown
