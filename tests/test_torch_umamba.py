"""The port's U-Mamba_Enc (``models/umamba.py``) and its selective scan
(``ops/selective_scan.py``), held to the recurrence step by step and to the
benchmark's plain reference (``benchmark/reference/umamba.py``) on seeded
weights (``benchmark/data.seeded_state``).

- the scan's plain twin against Algorithm 2 written out in mamba's (batch,
  d_inner, L) layout, in f64; ``gradcheck`` of the scan and of a Mamba
  layer in each token layout, f64;
- the registry's model at 32² and narrow widths (three stages of patch
  tokens, two of channel tokens) against the reference: the forward in f64
  and f32, and one Engine training step's gradients (DICE on the step's
  augmented rows), held to the reference's in f64;
- the registry: a port-only architecture, every convolution counted,
  ``space`` refused; the spans and the ``umamba.scan_elements`` counter;
- the scan's launch plan along L (``scan_plan``) at the six sites and the
  ``umamba.scan_segments`` counter it feeds;
- on the card (``-m cuda``): the kernel at the six sites of a 128² forward
  at batch 2 and at the edges of its segments against the plain twin, two
  launches at the first site bit for bit, a graphed Engine equal to an
  eager one bit for bit, two graphed runs equal, and the counters (6 / 6 /
  6 launches a step, 6 a validation pass, 65,536,000 scan elements and
  2,368 scan segments a forward).

This file imports nothing of JAX: its card tests run where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import data as D, umamba_counts
from benchmark.reference import train as R, umamba as RU
from multi_task_breast_cancer_tpu_torch.models import blocks, registry, umamba
from multi_task_breast_cancer_tpu_torch.ops import _build, launches, selective_scan as S
from multi_task_breast_cancer_tpu_torch.parallel import spatial
from multi_task_breast_cancer_tpu_torch.utils import profiling

NARROW = [4, 8, 16, 32, 32]  # at 32²: stages 0-2 patch tokens, 3-4 channel tokens
SIZE = 32
COUNTERS = (S.selective_scan, S.selective_scan_backward, S.selective_scan_reduce)
SITES = [(64, 16384), (128, 4096), (256, 1024), (512, 256), (128, 512), (32, 512)]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scan_inputs(batch=2, steps=7, dn=4, n=16, rank=2, dtype=torch.float64, device="cpu",
                 seed=0):
    """The scan's inputs as the layer makes them: z a slice of the input
    projection's output, B and C neighbouring slices of x_proj's."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, dtype=dtype, device=device) * scale

    xz = rnd(batch, steps, 2 * dn, scale=1.5)
    xd = rnd(batch, steps, rank + 2 * n, scale=1.5)
    return dict(u=F.silu(xz[..., :dn]).contiguous(), delta=rnd(batch, steps, dn, scale=1.5),
                A=-torch.exp(rnd(dn, n, scale=0.35)), B=xd[..., rank:rank + n],
                C=xd[..., rank + n:], D=rnd(dn, scale=0.5), z=xz[..., dn:],
                delta_bias=rnd(dn, scale=0.5))


def _algorithm2(u, delta, A, B, C, D, z, delta_bias):
    """mamba_ssm's ``selective_scan_ref`` (delta_softplus, z given) in its
    own (batch, d_inner, L) layout."""
    u, delta, z = (t.transpose(1, 2) for t in (u, delta, z))
    B, C = B.transpose(1, 2), C.transpose(1, 2)
    delta = F.softplus(delta + delta_bias[..., None])
    decay = torch.exp(torch.einsum("bdl,dn->bdln", delta, A))
    push = torch.einsum("bdl,bnl,bdl->bdln", delta, B, u)
    x = u.new_zeros(u.shape[0], u.shape[1], A.shape[1])
    ys = []
    for i in range(u.shape[2]):
        x = decay[:, :, i] * x + push[:, :, i]
        ys.append(torch.einsum("bdn,bn->bd", x, C[:, :, i]))
    out = torch.stack(ys, dim=2) + u * D[:, None]
    return (out * F.silu(z)).transpose(1, 2)


def test_plain_scan_is_the_recurrence_step_by_step():
    ins = _scan_inputs()
    torch.testing.assert_close(S.selective_scan(**ins), _algorithm2(**ins), rtol=1e-12,
                               atol=1e-12)


def test_scan_gradcheck_in_f64():
    ins = {k: v.detach().clone().requires_grad_()
           for k, v in _scan_inputs(batch=1, steps=5, dn=2, n=3).items()}
    names = ["u", "delta", "A", "B", "C", "D", "z", "delta_bias"]
    assert torch.autograd.gradcheck(lambda *t: S.selective_scan(*t),
                                    [ins[k] for k in names])


@pytest.mark.parametrize("channel_token", [False, True])
def test_mamba_layer_gradcheck_in_both_token_layouts(channel_token):
    """A layer of 4 channels on a 3×2 plane: patch tokens (6 tokens of
    width 4) or channel tokens (4 tokens of width 6)."""
    torch.manual_seed(0)
    layer = umamba.MambaLayer(6 if channel_token else 4, channel_token).double()
    registry.init_weights(layer, torch.Generator().manual_seed(0))
    umamba.init_ssm(layer, torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, 3, 2, dtype=torch.float64, requires_grad=True)
    params = [p for p in layer.parameters()]
    assert torch.autograd.gradcheck(
        lambda x, *p: torch.func.functional_call(
            layer, dict(zip([n for n, _ in layer.named_parameters()], p)), (x,)),
        [x, *params])


# ---------------------------------------------------------------------------
# the model against the plain reference
# ---------------------------------------------------------------------------


def _pair(dtype=torch.float32, seed=7):
    port = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    ref = RU.UMambaEnc(widths=NARROW, size=SIZE)
    shapes = {n: tuple(t.shape) for n, t in port.state_dict().items()}
    assert shapes == {n: tuple(t.shape) for n, t in ref.state_dict().items()}
    state = D.seeded_state(torch, shapes, seed, "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port.to(dtype), ref.to(dtype)


def _scans(n=2, dtype=torch.float32):
    rng = np.random.default_rng(0)
    images, masks = zip(*[D.hard_image(rng, SIZE, ("benign", "malignant")[i % 2])
                          for i in range(n)])
    return (torch.from_numpy(np.stack(images)[:, None]).to(dtype),
            torch.from_numpy(np.stack(masks)[:, None]).to(dtype))


def _sites(widths=umamba.WIDTHS, size=128) -> list:
    """(d_inner, L) of each scan of a forward, read on the reference."""
    cfg = {"size": size, "channels": 1, "reference_kwargs": {"widths": list(widths)}}
    return [(dn, steps) for dn, steps, _ in umamba_counts.scan_sites(torch, cfg)]


def test_narrow_model_has_both_token_layouts():
    assert umamba.channel_tokens(NARROW, SIZE) == [False, False, False, True, True]
    assert umamba.channel_tokens() == [False, False, False, True, True, True]
    assert _sites() == SITES
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    assert [(2 * layer.norm.scale.shape[0], layer.channel_token)
            for layer in model.encoder.mamba_layers] == [
        (2 * 4, False), (2 * 8, False), (2 * 16, False), (2 * 16, True), (2 * 4, True)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
def test_forward_matches_the_reference(dtype, tol):
    """The forward within ``tol`` of the output's largest magnitude: f64
    leaves no room for a difference of arithmetic (measured ~5e-14); f32
    differs by the LayerNorm's statistics (E[x²] − E[x]² against torch's
    two passes) and the sums' orders, amplified by the seeded weights'
    activations of ~10³ (measured ~5e-5)."""
    port, ref = _pair(dtype)
    x, _ = _scans(dtype=dtype)
    with torch.no_grad():
        got, want = port(x), ref(x)
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def _leaf_gaps(names, got, want) -> dict:
    """Each leaf's gap over its own norm or the median leaf's, whichever is
    larger (the conv biases before an InstanceNorm have a zero gradient but
    for rounding)."""
    median = float(torch.stack([w.norm() for w in want]).median())
    return {n: float((g - w).norm()) / max(float(w.norm()), median)
            for n, g, w in zip(names, got, want)}


def test_engine_step_gradients_are_the_references(monkeypatch):
    """One training step of the port's Engine (f32, fast augmentation,
    DICE): its gradient is autograd's of the DICE loss of the port's model
    on the step's own augmented rows, and that gradient is the reference's
    on the same rows in f64 (every leaf within 1e-8). The first pair shares
    the f32 arithmetic but for the loss's order: every leaf within 1e-3
    (measured ≤ 3e-7 but on the conv biases before an InstanceNorm, whose
    exact gradient is zero: ≤ 2.8e-4 of the median leaf, rounding)."""
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
    port, ref = _pair()
    images, masks = _scans(4)
    rows = []
    real = Engine._augmented_batch

    def recording(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        rows.append(tuple(t.detach().clone() for t in out))
        return out

    monkeypatch.setattr(Engine, "_augmented_batch", recording)
    engine = Engine(port, EngineConfig(task="segmentation", batch_size=2,
                                       fast_augmentation=True), device="cpu")
    state = create_train_state(engine.model, "Adam", 1e-4)
    data = engine.device_data(ArrayDataset(
        images=images[:, 0, ..., None].numpy(), masks=masks[:, 0, ..., None].numpy(),
        labels=np.array([0, 1, 0, 1], np.int32), patient_ids=np.arange(4),
        class_names=["benign", "malignant"] * 2,
        tumor_pixels=masks.reshape(4, -1).sum(1).numpy()))
    start = {k: v.clone() for k, v in engine.model.state_dict().items()}
    engine.train_epoch(state, data, np.array([1, 2]), torch.Generator().manual_seed(3))
    stepped = [p.grad.detach().clone() for p in engine.model.parameters()]
    (x, m), = rows
    assert not torch.equal(x, images[1:3])  # the rows were augmented
    port.load_state_dict(start)
    own = torch.autograd.grad(R.dice(port(x), m), list(port.parameters()))
    names = [n for n, _ in port.named_parameters()]
    gaps = _leaf_gaps(names, stepped, own)
    assert max(gaps.values()) <= 1e-3, sorted(gaps.items(), key=lambda t: -t[1])[:3]
    port, ref = port.double(), ref.double()
    ref.load_state_dict({k: v.double() for k, v in start.items()})
    got = torch.autograd.grad(R.dice(port(x.double()), m.double()), list(port.parameters()))
    want = torch.autograd.grad(R.dice(ref(x.double()), m.double()), list(ref.parameters()))
    gaps = _leaf_gaps(names, got, want)
    assert max(gaps.values()) <= 1e-8, sorted(gaps.items(), key=lambda t: -t[1])[:3]


# ---------------------------------------------------------------------------
# the registry, the counted convolutions and the space refusal
# ---------------------------------------------------------------------------


def test_a_port_only_architecture_beside_the_jax_twinned_zoo():
    assert registry.PORT_ONLY_SEGMENTATION_ARCHS == ("UMambaEnc",)
    assert "UMambaEnc" not in registry.SEGMENTATION_ARCHS
    model = registry.init_segmentation_model("UMambaEnc", size=128)
    assert registry.count_parameters(model) == 39_730_657
    with pytest.raises(ValueError, match="UMambaEnc"):
        registry.init_segmentation_model("UMambaEnd")


def test_every_convolution_counts_its_cudnn_problem():
    """As the JAX-twinned zoo's case (``test_torch_spatial_zoo``): every
    2-D convolution module derives from the counted classes; the Mamba
    layers' causal conv1d is shifted multiply-adds, no convolution module."""
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    convs = {name: m for name, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d))}
    assert len(convs) == 5 * (1 + 5 + 4) + 4 + 1  # 5 a stage: stem, encoder, decoder
    assert [(name, type(m).__name__) for name, m in convs.items()
            if not isinstance(m, (blocks.CountedConv2d, blocks.CountedConvTranspose2d))] == []


def test_space_partitioning_is_refused():
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    with pytest.raises(NotImplementedError, match="space group"):
        spatial.row_multiple(model)
    with spatial.partitioned(object()), pytest.raises(NotImplementedError, match="space group"):
        model.encoder.mamba_layers[0](torch.zeros(1, 4, 32, 32))


def test_other_sides_are_refused():
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    with pytest.raises(ValueError, match="built for 32"):
        model(torch.zeros(1, 1, 64, 64))


def test_cpu_calls_launch_nothing():
    before = launches.snapshot()
    ins = {k: v.detach().clone().requires_grad_() for k, v in _scan_inputs().items()}
    S.selective_scan(**ins).sum().backward()
    S.selective_scan(**{k: v.float() for k, v in _scan_inputs().items()})
    assert launches.since(before) == {}


# ---------------------------------------------------------------------------
# spans and the counter
# ---------------------------------------------------------------------------


def _elements() -> int:
    return profiling.counters().get("umamba.scan_elements", 0)


def test_scan_elements_count_per_forward():
    """Σ batch · d_inner · L · N over the scans of a forward, eager or not."""
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    per_image = sum(dn * steps * 16 for dn, steps in _sites(NARROW, SIZE))
    before = _elements()
    with torch.no_grad():
        model(torch.zeros(2, 1, SIZE, SIZE))
    assert _elements() - before == 2 * per_image
    assert sum(dn * steps * 16 for dn, steps in SITES) == 32_768_000


def test_each_span_appears_per_forward_under_recording():
    model = registry.init_segmentation_model("UMambaEnc", size=SIZE, nnunet_widths=NARROW)
    with profiling.recording() as rec, torch.no_grad():
        model(torch.zeros(1, 1, SIZE, SIZE))
        model(torch.zeros(1, 1, SIZE, SIZE))
    spans = rec.export()
    names = [s["name"] for s in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "umamba.mamba": 10, "umamba.scan": 10, "umamba.decoder": 2}
    for s in spans:
        if s["name"] == "umamba.scan":
            assert spans[s["parent"]]["name"] == "umamba.mamba"


def test_scan_plan_splits_every_published_site_along_l():
    """At batch 2 every site runs 8 segments a block and at least 16 steps a
    segment, the segments cover L, no launch asks for more blocks than an
    H100 has SMs, and every site's clusters fit on the card at once (no
    second wave); the first site (4 chain groups of 16,384 steps) runs 4
    clusters of 16 blocks, so 64 SMs, where one warp a chain group ran 4."""
    plans = [S.scan_plan(2, dn, steps) for dn, steps in SITES]
    for (dn, steps), plan in zip(SITES, plans):
        groups = 2 * dn // S.LANES
        assert plan.warps == S.WARPS and plan.steps >= S.MIN_STEPS, (dn, steps, plan)
        assert plan.segments * plan.steps >= steps
        assert plan.blocks == groups * plan.cluster <= _build.H100_SMS
        assert groups <= S.H100_CLUSTERS[plan.cluster], (dn, steps, plan)
        assert plan.chains == plan.blocks * plan.warps
    assert plans[0] == S.ScanPlan(cluster=16, warps=8, steps=128, blocks=64, chains=512)
    assert [p.cluster for p in plans] == [16, 8, 4, 2, 4, 4]
    assert [p.chains for p in plans] == [512, 512, 512, 512, 256, 64]
    assert sum(2 * dn // S.LANES for dn, _ in SITES) == 70  # one chain a warp, before


@pytest.mark.parametrize("batch,dn,steps", [(1, 32, 1), (2, 64, 15), (2, 64, 17),
                                            (1, 64, 2047), (1, 64, 2049), (3, 96, 1000),
                                            (2, 32, 512), (200, 32, 64)])
def test_scan_plan_covers_the_sequence(batch, dn, steps):
    """Any shape: a cluster of 1-16 blocks that the card holds as many of at
    once as the shape has chain groups (or of one block), at most 8 warps a
    block, the segments cover L and none but the last ones is short or
    empty; a sequence shorter than two segments' worth is one segment."""
    plan = S.scan_plan(batch, dn, steps)
    assert plan.cluster in S.H100_CLUSTERS and 1 <= plan.warps <= S.WARPS
    assert plan.cluster == 1 or batch * dn // S.LANES <= S.H100_CLUSTERS[plan.cluster]
    assert plan.segments * plan.steps >= steps
    assert plan.steps >= min(steps, S.MIN_STEPS)
    if steps < 2 * S.MIN_STEPS:
        assert plan.segments == 1 and plan.steps == steps
    assert plan.chains == batch * dn // S.LANES * plan.segments


def test_scan_segments_count_per_forward():
    """``umamba.scan_segments`` adds each scan's planned chains: 2,368 a
    128² forward at batch 2 (the model on the meta device, its scans
    stubbed: the count is the plan's, read from the shapes)."""
    model = registry.init_segmentation_model("UMambaEnc", size=128).to("meta")
    seen = []

    def stub(u, *args):
        seen.append((u.shape[2], u.shape[1]))
        return torch.empty_like(u)

    op, umamba.selective_scan = umamba.selective_scan, stub
    before = profiling.counters().get("umamba.scan_segments", 0)
    try:
        with torch.no_grad():
            model(torch.zeros(2, 1, 128, 128, device="meta"))
    finally:
        umamba.selective_scan = op
    assert seen == SITES
    grown = profiling.counters().get("umamba.scan_segments", 0) - before
    assert grown == sum(S.scan_plan(2, dn, steps).chains for dn, steps in SITES) == 2368


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the selective scan kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dn,steps", SITES)
def test_cuda_kernel_matches_the_twin_at_the_published_sites(dn, steps):
    """Each scan of a 128² forward at batch 2, in f32 on the card, against
    the plain twin in f64 on the same inputs, its gradients autograd's: the
    output and every gradient within 2e-5 of its largest magnitude (the f32
    chain of up to 16,384 steps; measured ≤ 3.3e-6 with one warp along the
    whole of L, ≤ 3.7e-7 with the segments joined)."""
    _cuda_or_skip()
    _assert_matches_the_twin(_scan_inputs(batch=2, steps=steps, dn=dn, rank=-(-dn // 32),
                                          dtype=torch.float32, device="cuda",
                                          seed=dn + steps))


_NAMES = ["u", "delta", "A", "B", "C", "D", "z", "delta_bias"]


def _kernel_and_grads(ins: dict) -> list:
    """The kernel's output and its eight gradients (through the autograd
    Function) for a seeded output gradient."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in ins.items()}
    out = S.selective_scan(**leaves)
    dout = torch.randn(out.shape, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    return [out.detach(), *torch.autograd.grad(out, [leaves[k] for k in _NAMES], dout)], dout


def _assert_matches_the_twin(ins: dict) -> None:
    """The output and every gradient within 2e-5 of its largest magnitude
    of the plain twin's in f64 on the same inputs."""
    got, dout = _kernel_and_grads(ins)
    d64 = [ins[k].detach().double().requires_grad_() for k in _NAMES]
    want_out = S.selective_scan_reference(*d64)
    want = [want_out.detach(), *torch.autograd.grad(want_out, d64, dout.double())]
    for name, g, w in zip(["out", *_NAMES], got, want):
        assert float((g.double() - w).abs().max()) <= 2e-5 * float(w.abs().max()), name


@pytest.mark.cuda
@pytest.mark.parametrize("batch,dn,steps,bias", [
    (2, 32, 1, None),       # one step
    (2, 64, 15, None),      # one below a segment's fewest steps: one short segment
    (2, 64, 17, None),      # one above, over two staged chunks
    (1, 64, 2047, None),    # 8 blocks of 8 segments of 32 steps: the last one short
    (1, 64, 2049, None),    # 16 blocks of 8 segments of 17 steps, the last 7 empty
    (3, 96, 1000, None),    # L not a multiple of the 16-step chunk, 3 chain groups
    (1, 64, 4096, -12.0),   # a step of ~6e-6: the decay across a segment stays near 1
    (1, 64, 4096, 12.0),    # a step of ~12: the decay across a segment underflows to 0
])
def test_cuda_kernel_matches_the_twin_at_the_segments_edges(batch, dn, steps, bias):
    """The join of the segments along L at its edges, batch 1 included,
    held as the published sites are."""
    _cuda_or_skip()
    ins = _scan_inputs(batch=batch, steps=steps, dn=dn, rank=-(-dn // 32),
                       dtype=torch.float32, device="cuda", seed=batch + dn + steps)
    if bias is not None:
        ins["delta_bias"] = torch.full_like(ins["delta_bias"], bias)
    _assert_matches_the_twin(ins)


@pytest.mark.cuda
def test_cuda_kernel_repeats_bit_for_bit_at_the_first_site():
    """Two launches at the first site's shape (batch 2, d_inner 64, 16,384
    steps: 4 clusters of 16 blocks joined in a fixed order): the same bits
    in the output and every gradient."""
    _cuda_or_skip()
    ins = _scan_inputs(batch=2, steps=16384, dn=64, rank=2, dtype=torch.float32,
                       device="cuda", seed=3)
    first, _ = _kernel_and_grads(ins)
    second, _ = _kernel_and_grads(ins)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _engine(graphed: bool, seed: int = 2 ** 31 + 11):
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
    model = registry.init_segmentation_model("UMambaEnc", size=128)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(D.seeded_state(torch, shapes, seed, "cpu"))
    engine = Engine(model, EngineConfig(task="segmentation", batch_size=2,
                                        fast_augmentation=True), device="cuda",
                    cuda_graphs=graphed)
    assert engine.graphed == graphed
    state = create_train_state(engine.model, "Adam", 1e-4)
    rng = np.random.default_rng(5)
    images, masks = zip(*[D.hard_image(rng, 128, ("benign", "malignant")[i % 2])
                          for i in range(8)])
    data = engine.device_data(ArrayDataset(
        images=np.stack(images)[..., None].astype(np.float32),
        masks=np.stack(masks)[..., None].astype(np.float32),
        labels=(np.arange(8) % 2).astype(np.int32), patient_ids=np.arange(8),
        class_names=["benign"] * 8, tumor_pixels=np.stack(masks).reshape(8, -1).sum(1)))
    return engine, state, data


def _segments() -> int:
    return profiling.counters().get("umamba.scan_segments", 0)


def _steps(graphed: bool, steps: int = 3) -> list:
    """``steps`` one-step epochs (graphed: the first eager, the second
    captured, the rest replayed): every leaf after each step, the launch
    counters' and the scan-element and scan-segment counters' growth, then
    a validation pass's launches."""
    engine, state, data = _engine(graphed)
    out = []
    for k in range(steps):
        before, elements, segments = launches.snapshot(), _elements(), _segments()
        engine.train_epoch(state, data, np.array([2 * k, 2 * k + 1]),
                           torch.Generator().manual_seed(k))
        grown = launches.since(before)
        out.append(([p.detach().cpu().clone() for p in engine.model.parameters()],
                    [grown.get(fn, 0) for fn in COUNTERS],
                    (_elements() - elements, _segments() - segments)))
    before = launches.snapshot()
    engine.eval_epoch(state, data)
    grown = launches.since(before)
    return out, [grown.get(fn, 0) for fn in COUNTERS]


@pytest.mark.cuda
def test_cuda_graphed_steps_equal_eager_steps_and_repeat_bit_for_bit():
    """Three steps of a graphed Engine, a second graphed run and an eager
    one from the same weights, rows and draws: every leaf equal bit for bit
    after each step. The counters: 6 forward, 6 backward and 6 reduction
    launches a step (a replay counts its captured launches), 6 forwards a
    validation pass; 65,536,000 scan elements and 2,368 scan segments in
    the eager step, counted again by the capture's run, never by a
    replay."""
    _cuda_or_skip()
    graphed, graphed_val = _steps(True)
    again, _ = _steps(True)
    eager, eager_val = _steps(False)
    for k, ((g, n, e), (a, _, _), (p, m, _)) in enumerate(zip(graphed, again, eager)):
        assert all(torch.equal(x, y) for x, y in zip(g, a)), k
        assert all(torch.equal(x, y) for x, y in zip(g, p)), k
        assert n == m == [6, 6, 6], (k, n, m)
    assert graphed_val == eager_val == [6, 0, 0]
    assert [e for _, _, e in eager] == [(65_536_000, 2368)] * 3
    assert graphed[0][2] == graphed[1][2] == (65_536_000, 2368)
    assert graphed[2][2] == (0, 0)
