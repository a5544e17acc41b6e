"""The port's SwinUNETR held to the benchmark's plain reference
(``benchmark/reference/models.py::SwinUNETR``) on seeded weights
(``benchmark/data.seeded_state``), its spans and its counter.

- the registry's model (feature 24, depths 2-2-2-2, heads 3-6-12-24) at
  32² and 64² against the reference: the forward, and every leaf's
  gradient of a DICE loss, in f32 and in f64;
- the spans ``swin.attention``, ``swin.mlp``, ``swin.merge`` and
  ``swin.decoder`` and the counter ``swin.attention_windows`` (720 window ×
  head pairs per 128² image per forward), and a forward left unchanged
  while nothing records;
- on the card (``-m cuda``): two graphed Engine runs of the same steps on
  one seed give bit-equal gradients of every leaf.

This file imports nothing of JAX: its card test runs where JAX is absent.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import data as D
from benchmark.reference import models as RM, train as R
from multi_task_breast_cancer_tpu_torch.models import registry, swin_unetr
from multi_task_breast_cancer_tpu_torch.utils import profiling

FEATURES, DEPTHS, HEADS = 24, [2, 2, 2, 2], [3, 6, 12, 24]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _pair(size: int, dtype=torch.float32, seed: int = 7):
    """The registry's SwinUNETR and the reference, both on the seed's weights."""
    port = registry.init_segmentation_model("SwinUNETR", sequences=1, regions=1, size=size)
    ref = RM.build("SwinUNETR", in_channels=1, regions=1, feature_size=FEATURES,
                   depths=DEPTHS, heads=HEADS, size=size)
    shapes = {n: tuple(t.shape) for n, t in port.state_dict().items()}
    assert shapes == {n: tuple(t.shape) for n, t in ref.state_dict().items()}
    state = D.seeded_state(torch, shapes, seed, "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port.to(dtype), ref.to(dtype)


def _scans(size: int, dtype=torch.float32):
    """Two of the benchmark's synthetic scans (raw 0-255 intensities), their
    masks and labels."""
    rng = np.random.default_rng(0)
    images, masks = zip(*[D.hard_image(rng, size, c) for c in ("benign", "malignant")])
    return (torch.from_numpy(np.stack(images)[:, None]).to(dtype),
            torch.from_numpy(np.stack(masks)[:, None]).to(dtype), torch.tensor([0, 1]))


def _dice_grads(model, x, masks, labels):
    out = model(x)
    loss = R.loss("segmentation", out, masks, labels, 3, 0.35)
    return out.detach(), torch.autograd.grad(loss, list(model.parameters()))


@pytest.mark.parametrize("size", [32, 64])
def test_forward_and_dice_gradients_match_the_reference_in_f32(size):
    """f32: the forward within rtol 1e-4 (and 1e-4 of the output's largest
    magnitude, for elements near zero); every leaf's gradient within 1e-4
    of the whole gradient's norm. The measured gaps are ~4e-7 of the
    output's norm and ~2e-7 of the gradient's: a leaf whose gradient is
    zero in exact arithmetic but for the norm's eps (``encoder0.conv_skip``,
    a 1×1 conv of one channel before an instance norm) is only rounding, so
    it is held to the whole gradient's scale, as every leaf is."""
    port, ref = _pair(size)
    x, masks, labels = _scans(size)
    out_p, g_p = _dice_grads(port, x, masks, labels)
    out_r, g_r = _dice_grads(ref, x, masks, labels)
    torch.testing.assert_close(out_p, out_r, rtol=1e-4, atol=1e-4 * float(out_r.abs().max()))
    whole = torch.sqrt(sum((g.double() ** 2).sum() for g in g_r))
    names = [n for n, _ in port.named_parameters()]
    gaps = {n: float((a - b).double().norm() / whole) for n, a, b in zip(names, g_p, g_r)}
    assert max(gaps.values()) <= 1e-4, sorted(gaps.items(), key=lambda t: -t[1])[:3]


def test_forward_and_dice_gradients_match_the_reference_in_f64():
    """f64 leaves no room for rounding to hide a difference of arithmetic:
    the forward within 1e-9 of the output's scale, and every leaf's
    gradient within 1e-8 of its own norm (measured: 1e-11 for
    ``encoder0.conv_skip``, 1e-14 for the others)."""
    port, ref = _pair(32, torch.float64)
    x, masks, labels = _scans(32, torch.float64)
    out_p, g_p = _dice_grads(port, x, masks, labels)
    out_r, g_r = _dice_grads(ref, x, masks, labels)
    assert float((out_p - out_r).abs().max()) <= 1e-9 * float(out_r.abs().max())
    names = [n for n, _ in port.named_parameters()]
    gaps = {n: float((a - b).norm() / b.norm()) for n, a, b in zip(names, g_p, g_r)}
    assert max(gaps.values()) <= 1e-8, sorted(gaps.items(), key=lambda t: -t[1])[:3]


# ---------------------------------------------------------------------------
# spans and the counter
# ---------------------------------------------------------------------------


def _windows() -> int:
    return profiling.counters().get("swin.attention_windows", 0)


def test_attention_windows_count_720_per_128_image_per_forward():
    """(64·3 + 16·6 + 4·12 + 1·24) window × head pairs a block, two blocks a
    stage: 720 per 128² image, each forward, eager or not."""
    model = registry.init_segmentation_model("SwinUNETR", size=128)
    x = torch.zeros(2, 1, 128, 128)
    before = _windows()
    with torch.no_grad():
        model(x)
    assert _windows() - before == 2 * 720
    model(x[:1]).sum().backward()
    assert _windows() - before == 3 * 720


def test_each_span_appears_per_forward_under_recording():
    """Per forward: 8 attention calls, 8 MLPs (two blocks in each of four
    stages), 4 merges, and the UNETR conv blocks as two spans (``encoder0``
    before the stages, the rest after them). The attention and MLP spans
    lie inside no other span of the model."""
    model = registry.init_segmentation_model("SwinUNETR", size=32)
    with profiling.recording() as rec, torch.no_grad():
        model(torch.zeros(1, 1, 32, 32))
        model(torch.zeros(1, 1, 32, 32))
    spans = rec.export()
    names = [s["name"] for s in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "swin.attention": 16, "swin.mlp": 16, "swin.merge": 8, "swin.decoder": 4}
    assert all(s["parent"] is None and s["end_ns"] >= s["start_ns"] for s in spans)


def test_forward_unchanged_while_nothing_records():
    """Outside a recording each span is the shared no-op, and the forward
    with spans recorded equals the one without, bit for bit."""
    assert profiling.span("swin.attention") is profiling._NOOP
    port, _ = _pair(32)
    x, _, _ = _scans(32)
    with torch.no_grad():
        plain = port(x)
        with profiling.recording():
            recorded = port(x)
    assert torch.equal(plain, recorded)
    assert profiling.span("swin.mlp") is profiling._NOOP
    assert isinstance(port.stage0_block0.attn, swin_unetr.WindowAttention)


# ---------------------------------------------------------------------------
# the convolutions' deterministic path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv3x3", "patch_embed", "conv1x1", "deconv"])
def test_deterministic_conv_is_the_module_forward_and_its_gradients(kind):
    """``_DeterministicConv`` (the path of every convolution of the model on
    the card, where autograd's own backward would pick cuDNN's
    nondeterministic engines): its forward equals the module's bit for bit,
    and its input, weight and bias gradients are the module's within a few
    ulps of each gradient's scale. On the CPU both run the same kernels."""
    torch.manual_seed(0)
    conv = {"conv3x3": lambda: swin_unetr.Conv3x3(6, 8),
            "patch_embed": lambda: swin_unetr.LecunConv2d(1, 8, 2, stride=2),
            "conv1x1": lambda: swin_unetr.LecunConv2d(6, 8, 1, bias=False),
            "deconv": lambda: swin_unetr.deconv(6, 8, 2)}[kind]()
    x = torch.randn(2, conv.in_channels, 16, 16, requires_grad=True)
    g = torch.randn_like(conv(x))
    leaves = [x] + list(conv.parameters())
    plain = conv(x)
    plain_grads = torch.autograd.grad(plain, leaves, g)
    mine = swin_unetr._DeterministicConv.apply(
        x, conv.weight, conv.bias, tuple(conv.stride), tuple(conv.padding),
        isinstance(conv, torch.nn.ConvTranspose2d))
    mine_grads = torch.autograd.grad(mine, leaves, g)
    assert torch.equal(mine, plain)
    for a, b in zip(mine_grads, plain_grads):
        assert float((a - b).abs().max()) <= 4 * torch.finfo(b.dtype).eps * float(b.abs().max())


def test_deterministic_switch_is_put_back():
    """The switches hold inside the convolution only: every other model
    keeps the engines its own switches choose."""
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    for benchmark in (True, False):
        cudnn.benchmark = benchmark
        try:
            with swin_unetr._deterministic_cudnn():
                assert cudnn.deterministic and not cudnn.benchmark
            assert (cudnn.deterministic, cudnn.benchmark) == (before[0], benchmark)
            with pytest.raises(ZeroDivisionError), swin_unetr._deterministic_cudnn():
                1 / 0
            assert (cudnn.deterministic, cudnn.benchmark) == (before[0], benchmark)
        finally:
            cudnn.deterministic, cudnn.benchmark = before


def test_deterministic_switch_holds_across_threads():
    """Threads that enter and leave the switch at once (served replicas)
    each see it on inside, and leave the process's switches as they were."""
    import threading
    cudnn = torch.backends.cudnn
    before = cudnn.deterministic, cudnn.benchmark
    cudnn.benchmark = True
    seen = []

    def enter_and_leave():
        for _ in range(200):
            with swin_unetr._deterministic_cudnn():
                seen.append((cudnn.deterministic, cudnn.benchmark))

    try:
        threads = [threading.Thread(target=enter_and_leave) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert set(seen) == {(True, False)} and len(seen) == 800
        assert (cudnn.deterministic, cudnn.benchmark) == (before[0], True)
    finally:
        cudnn.deterministic, cudnn.benchmark = before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _graphed_runs(steps: int = 3) -> list:
    """``steps`` one-step epochs of a graphed Engine (the first eager, the
    second captured, the rest replayed) from the seed's weights and rows:
    every leaf's gradient after each step, and the attention counter's
    growth in each."""
    from multi_task_breast_cancer_tpu_torch.data.dataset import ArrayDataset
    from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
    from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
    model = registry.init_segmentation_model("SwinUNETR", size=128)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    model.load_state_dict(D.seeded_state(torch, shapes, 2 ** 31 + 5, "cpu"))
    engine = Engine(model, EngineConfig(task="segmentation", batch_size=2,
                                        fast_augmentation=True), device="cuda")
    assert engine.graphed
    state = create_train_state(engine.model, "Adam", 1e-4)
    rng = np.random.default_rng(3)
    images, masks = zip(*[D.hard_image(rng, 128, ("benign", "malignant")[i % 2])
                          for i in range(8)])
    data = engine.device_data(ArrayDataset(
        images=np.stack(images)[..., None].astype(np.float32),
        masks=np.stack(masks)[..., None].astype(np.float32),
        labels=(np.arange(8) % 2).astype(np.int32), patient_ids=np.arange(8),
        class_names=["benign"] * 8, tumor_pixels=np.stack(masks).reshape(8, -1).sum(1)))
    out = []
    for k in range(steps):
        before = _windows()
        engine.train_epoch(state, data, np.array([2 * k, 2 * k + 1]),
                           torch.Generator().manual_seed(k))
        out.append(([p.grad.detach().cpu().clone() for p in engine.model.parameters()],
                    _windows() - before))
    return out


@pytest.mark.cuda
def test_cuda_graphed_steps_give_bit_equal_gradients_twice():
    """Two runs of the same three graphed Engine steps on one seed, with the
    switches as the Engine leaves them for every model (``cudnn.benchmark``
    on, ``cudnn.deterministic`` off): every leaf's gradient equal bit for
    bit after each step. The attention counter grows in the eager step and
    in the capture (a warm-up and the captured run), never in a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic, cudnn.allow_tf32,
             matmul.allow_tf32)
    try:
        cudnn.deterministic = False
        first, second = _graphed_runs(), _graphed_runs()
        assert not cudnn.deterministic and cudnn.benchmark
    finally:
        (cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic, cudnn.allow_tf32,
         matmul.allow_tf32) = saved
    for k, ((g1, n1), (g2, n2)) in enumerate(zip(first, second)):
        unequal = [i for i, (a, b) in enumerate(zip(g1, g2)) if not torch.equal(a, b)]
        assert not unequal, (k, len(unequal))
        assert n1 == n2
    counts = [n for _, n in first]
    assert counts[0] == 2 * 720 and counts[2] == 0, counts
