"""The FLOP and byte counters kept with the benchmark, and the per-layer
readers on made-up records."""

import pytest
import torch

from benchmark import counters, harness


def test_mtnnunet_norm_sites_and_their_bounds_at_batch_2():
    sites = counters.norm_sites(torch, "MTnnUNet", {}, 128, 1)
    assert len(sites) == 25
    assert counters.norm_forward_bound_s(sites, 2) * 1e3 == pytest.approx(0.0161, abs=5e-5)
    assert counters.norm_backward_bound_s(sites, 2) * 1e3 == pytest.approx(0.0241, abs=5e-5)
    assert counters.norm_forward_bound_s(sites, 64) * 1e3 == pytest.approx(0.5149, abs=5e-5)
    assert counters.augment_bound_s(2, 2, 128) * 1e3 == pytest.approx(0.00016, abs=5e-6)


def test_swinunetr_has_no_fused_norm_site():
    assert counters.norm_sites(torch, "SwinUNETR", {}, 128, 1) == []


def test_the_forward_flops_of_one_conv_site_are_a_hand_count():
    from torch.utils.flop_counter import FlopCounterMode
    conv = torch.nn.Conv2d(32, 64, 3, padding=1, bias=False)
    with FlopCounterMode(display=False) as counter:
        conv(torch.zeros(1, 32, 128, 128))
    assert counter.get_total_flops() == 2 * 64 * 32 * 9 * 128 * 128


def test_the_deconv_heads_count_as_the_one_transposed_conv_the_port_runs():
    sites = counters.forward_flops(torch, "MTnnUNet", {"widths": [4, 8, 8, 16, 16]}, 32, 1)
    assert sites > 0
    from benchmark.reference import models
    head = models.DeconvHead(8, 1, 8)
    from torch.utils.flop_counter import FlopCounterMode
    models.DeconvHead.fused = True
    try:
        with FlopCounterMode(display=False) as counter:
            head(torch.zeros(1, 8, 4, 4, device="meta"))
    finally:
        models.DeconvHead.fused = False
    per_pixel_out = 2 * 8 * 1  # the fused kernel: 8 inputs to 1 region per output pixel
    assert counter.get_total_flops() >= per_pixel_out * 32 * 32
    assert counter.get_total_flops() < 2 * 8 * 8 * 32 * 32  # not the C→C deconv


def _record(**kw):
    sites = counters.norm_sites(torch, "MTnnUNet", {}, 128, 1)
    rec = {"kind": "train", "window_s": 2.0, "busy_s": 1.5, "steps": 10, "batch": 2,
           "images_trained": 20, "images_validated": 68, "forward_flops": 5e9,
           "peak_flops": 67e12, "norm_sites": sites, "aug_planes": 2, "canvas": 128,
           "kernels": {"void instance_norm_leaky_relu_fwd<float>": (0.01, 25 * 11),
                       "void instance_norm_leaky_relu_backward<float>": (0.01, 250),
                       "fast_augment_staged": (1e-4, 10), "conv": (1.0, 100)}}
    rec.update(kw)
    return rec


def test_readers_on_a_made_up_training_record():
    read = lambda name, rec: harness.metric_reader(name)(rec)  # noqa: E731
    rec = _record()
    assert read("device_idle_pct.train", rec) == pytest.approx(25.0)
    assert read("train_mfu", rec) == pytest.approx(100 * 5e9 * (60 + 68) / 2.0 / 67e12)
    sites = rec["norm_sites"]
    bound = (10 * (counters.norm_forward_bound_s(sites, 2) + counters.norm_backward_bound_s(sites, 2))
             + counters.norm_forward_bound_s(sites, 68))
    assert read("norm_roofline", rec) == pytest.approx(100 * bound / 0.02)
    assert read("augment_roofline", rec) == pytest.approx(
        100 * 10 * counters.augment_bound_s(2, 2, 128) / 1e-4)
    # launches that do not match the steps: nothing to read
    assert read("norm_roofline", _record(steps=9)) is None
    assert read("norm_roofline", _record(norm_sites=[])) is None
    assert read("device_idle_pct.serve", rec) is None


def test_readers_on_a_made_up_serving_record():
    read = lambda name, rec: harness.metric_reader(name)(rec)  # noqa: E731
    rec = {"kind": "serve", "window_s": 3.0, "busy_s": 0.6, "handler_ms": list(range(1, 101)),
           "stats_before": {"images": 10, "batches": 5}, "stats_after": {"images": 110, "batches": 30}}
    assert read("device_idle_pct.serve", rec) == pytest.approx(80.0)
    assert read("images_per_batch.serve", rec) == pytest.approx(4.0)
    assert read("handler_p95_ms.serve", rec) == pytest.approx(95.05)
    assert read("train_mfu", rec) is None
