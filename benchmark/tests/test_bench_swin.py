"""The SwinUNETR cell's counts: the attention sites read from the plain
reference, the softmax bounds, and ``window_softmax_roofline``'s reader on
made-up records."""

import pytest
import torch

from benchmark import counters, harness, swin_counts

SOFTMAX_FWD = "void (anonymous namespace)::softmax_warp_forward<float, float, float, 6>"
SOFTMAX_BWD = "void (anonymous namespace)::softmax_warp_backward<float, float, float, 6>"


def test_attention_sites_of_the_cell_are_the_windows_and_heads_of_each_block():
    sites = swin_counts.attention_sites(torch, harness.config("swinunetr"))
    assert sites == [(64, 3, 64)] * 2 + [(16, 6, 64)] * 2 + [(4, 12, 64)] * 2 + [(1, 24, 64)] * 2
    assert sum(w * h for w, h, _ in sites) == 720  # the port's swin.attention_windows per image


def test_a_stage_smaller_than_the_window_takes_its_grid():
    sites = swin_counts.attention_sites(torch, harness.config("swinunetr"), 32)
    assert sites[4:] == [(1, 12, 16)] * 2 + [(1, 24, 4)] * 2


def test_softmax_bounds_are_a_hand_count():
    """Stage 0 at batch 2: 2·64·3 windows × heads of 64×64 logits,
    4 bytes each, read and written once forward (2 tensors), three times
    backward; the bytes bound the time (5 and 4 operations an element at
    67 TFLOP/s lie below 8 and 12 bytes at 3.35 TB/s)."""
    numel = 2 * 64 * 3 * 64 * 64
    one = [(64, 3, 64)]
    assert swin_counts.softmax_forward_bound_s(one, 2) == pytest.approx(2 * 4 * numel / 3.35e12)
    assert swin_counts.softmax_backward_bound_s(one, 2) == pytest.approx(3 * 4 * numel / 3.35e12)
    sites = swin_counts.attention_sites(torch, harness.config("swinunetr"))
    elements = 2 * 720 * 64 * 64
    assert swin_counts.softmax_forward_bound_s(sites, 2) == pytest.approx(
        counters.bound_s(elements, 4, 2, 5))


def _record(steps=10, fwd=None, bwd=None, **kw):
    rec = {"kind": "train", "window_s": 2.0, "busy_s": 1.5, "steps": steps, "batch": 2,
           "images_trained": 2 * steps, "images_validated": 68, "canvas": 128,
           "norm_sites": [], "kernels": {
               SOFTMAX_FWD: (0.004, 8 * (steps + 1) if fwd is None else fwd),
               SOFTMAX_BWD: (0.006, 8 * steps if bwd is None else bwd),
               "sm80_xmma_fprop_implicit_gemm": (1.0, 100)}}
    rec.update(kw)
    return rec


def test_reader_divides_the_bound_of_every_launch_by_their_device_time():
    read = harness.metric_reader("window_softmax_roofline")
    sites = swin_counts.attention_sites(torch, harness.config("swinunetr"))
    bound = (10 * (swin_counts.softmax_forward_bound_s(sites, 2)
                   + swin_counts.softmax_backward_bound_s(sites, 2))
             + swin_counts.softmax_forward_bound_s(sites, 68))
    assert read(_record()) == pytest.approx(100 * bound / 0.010)


@pytest.mark.parametrize("counts", [{"fwd": 8 * 10}, {"bwd": 8 * 11},
                                    {"steps": 9, "fwd": 8 * 11, "bwd": 8 * 10},
                                    {"kernels": {"conv": (1.0, 5)}}, {"kind": "serve"}])
def test_reader_refuses_launch_counts_that_do_not_match_the_steps(counts):
    """Forward launches other than 8 per step and 8 for the validation, or
    backward launches other than 8 per step, or none: nothing to read."""
    assert harness.metric_reader("window_softmax_roofline")(_record(**counts)) is None
