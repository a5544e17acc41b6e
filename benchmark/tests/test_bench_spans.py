"""The port's spans on the device trace's clock (``benchmark/spans.py``): the
two-marker fit, the sorting of idle gaps, the replay alignment and the
set-up stretches, on a hand-built trace whose clock runs ahead of the
host's by a known offset and drift."""

import pytest

from benchmark import harness, spans, trace

OFFSET_US = 1_234_567.891
RATE = 1.000013e-3  # trace µs per host ns: the trace's clock drifts 13 ppm


def on_trace(ns: float) -> float:
    return OFFSET_US + RATE * ns


def _event(cat, name, start_ns, end_ns, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": on_trace(start_ns),
            "dur": on_trace(end_ns) - on_trace(start_ns), "args": {"correlation": corr}}


def _span(name, start_ns, end_ns, parent, depth):
    return {"name": name, "start_ns": start_ns, "end_ns": end_ns, "parent": parent,
            "depth": depth}


# host ns: (runtime call, its activity on the device); what ends each gap
LAUNCHES = [
    (("cudaLaunchKernel", 1_500, 2_500), ("kernel", "void spin_kernel(long)", 5_000, 6_000)),
    (("cudaMemcpyAsync", 50_000, 60_000), ("gpu_memcpy", "Memcpy HtoD", 150_000, 160_000)),
    (("cudaGraphLaunch", 130_000, 140_000), ("kernel", "conv_a", 160_000, 180_000)),
    (None, ("kernel", "conv_b", 190_000, 250_000)),  # the same graph's next node
    (("cudaGraphLaunch", 320_000, 330_000), ("kernel", "conv_c", 335_000, 450_000)),
    (("cudaLaunchKernel", 610_000, 615_000), ("kernel", "val_conv", 620_000, 650_000)),
    (("cudaMemcpyAsync", 710_000, 720_000), ("gpu_memcpy", "Memcpy DtoH", 730_000, 740_000)),
    (("cudaLaunchKernel", 1_140_000, 1_160_000),
     ("kernel", "void spin_kernel(long)", 1_300_000, 1_301_000)),
]
STAMPS = [(1_000, 3_000), (1_100_000, 1_200_000)]  # around each marker's launch
HOST = (10_000, 1_000_000)  # the host window device_idle_pct.train reads
SPANS = [
    _span("engine.epoch", 20_000, 900_000, None, 0),
    _span("engine.plan", 20_000, 100_000, 0, 1),
    _span("engine.steps", 100_000, 600_000, 0, 1),
    _span("engine.step", 110_000, 300_000, 2, 2),
    _span("graph.replay", 120_000, 200_000, 3, 3),
    _span("engine.step", 300_000, 500_000, 2, 2),
    _span("graph.replay", 310_000, 400_000, 5, 3),
    _span("engine.validation", 600_000, 700_000, 0, 1),
    _span("engine.fetch", 700_000, 800_000, 0, 1),
]
# idle host ns inside the window, by class, as built above
EXPECTED_NS = {"epoch_edges": (150_000 - 10_000) + (730_000 - 650_000),
               "device_side": 190_000 - 180_000,  # queued: the launch returned at 140,000
               "step_host": 335_000 - 250_000,  # late: the launch came at 320,000
               "validation": 620_000 - 450_000,
               "outside": 1_000_000 - 740_000}


def _raw():
    events = []
    corr = 0
    for call, activity in LAUNCHES:
        if call is not None:
            corr += 1
            events.append(_event("cuda_runtime", *call, corr))
        events.append(_event(*activity, corr))
    return {"traceEvents": events}


def test_a_drifting_clock_is_fitted_exactly_from_two_markers():
    raw = _raw()
    marks = spans.marker_calls(raw, spans.runtime_calls(raw))
    assert [name for *_, name in marks] == ["cudaLaunchKernel", "cudaLaunchKernel"]
    clock = spans.Clock(STAMPS, [(s, e) for s, e, _ in marks])
    assert clock.rate == pytest.approx(RATE, rel=1e-12)
    for ns in (0, 123_456, 10 ** 9, 3 * 10 ** 11):
        assert clock.at(ns) == pytest.approx(on_trace(ns), abs=1e-3)  # to the ns
    # each launch's runtime event lies inside its stamps, 0.5 µs from either end
    assert clock.slack_us == pytest.approx([0.5 * RATE * 1000, 40 * RATE * 1000], abs=1e-6)
    with pytest.raises(ValueError):
        spans.Clock(STAMPS[:1], [(s, e) for s, e, _ in marks])


def test_each_gap_goes_to_its_class_queued_late_validation_and_edges():
    found = spans.analyse(_raw(), STAMPS, HOST, SPANS)
    classes = found["idle_by_cause"]["classes"]
    assert list(classes) == list(spans.CLASSES)
    for name, ns in EXPECTED_NS.items():
        assert classes[name] == pytest.approx(ns * RATE / 1e6, abs=1e-12), name
    by_call = found["idle_by_cause"]["spans"]
    assert by_call["graph.replay"] == pytest.approx((10_000 + 85_000) * RATE / 1e6)
    assert by_call["engine.validation"] == pytest.approx(170_000 * RATE / 1e6)
    # where the host was when a gap opened: after a step's replay, still in
    # the step (the late launch's gap and validation's)
    assert found["idle_by_cause"]["host_at_open"]["engine.step"] == pytest.approx(
        (85_000 + 170_000) * RATE / 1e6)
    assert found["replay_alignment"] == {"replays": 2, "one_launch": 2}


def test_a_call_still_running_when_the_gap_opens_is_the_hosts():
    chain = ["graph.replay", "engine.step", "engine.steps", "engine.epoch"]
    assert spans.cause(chain, call_end=10.0, gap_start=10.0) == "device_side"
    assert spans.cause(chain, call_end=10.5, gap_start=10.0) == "step_host"
    assert spans.cause(["engine.validation", "engine.epoch"], 0.0, 1.0) == "validation"
    assert spans.cause(["engine.draws", "engine.plan", "engine.epoch"], 0.0, 1.0) == "epoch_edges"
    assert spans.cause(["engine.epoch"], 0.0, 1.0) == "outside"
    assert spans.cause([], 0.0, 1.0) == "outside"


def test_a_replay_span_without_its_launch_or_with_two_is_counted_out():
    raw = _raw()
    calls = spans.runtime_calls(raw)
    clock = spans.Clock(STAMPS, [(s, e) for s, e, _ in spans.marker_calls(raw, calls)])
    shifted = [dict(s) for s in SPANS]
    shifted[4].update(start_ns=141_000, end_ns=200_000)  # opens after its launch returned
    shifted[6].update(start_ns=100_000, end_ns=400_000)  # holds both launches
    assert spans.replay_alignment(spans._on_clock(shifted, clock), calls) == {
        "replays": 2, "one_launch": 0}


def test_the_five_shares_add_up_to_the_idle_reading_on_one_record():
    raw = _raw()
    parsed = trace.parse(raw)
    window_s = (HOST[1] - HOST[0]) / 1e9
    record = {"kind": "train", "window_s": window_s,
              "busy_s": trace.busy_us(parsed["events"]) / 1e6,
              "idle_by_cause": spans.analyse(raw, STAMPS, HOST, SPANS)["idle_by_cause"]}
    shares = spans.idle_shares(record)
    idle = harness.metric_reader("device_idle_pct.train")(record)
    # the busy and idle seconds are the trace's; the window the host's: the
    # two clocks part by the drift alone
    assert sum(shares.values()) == pytest.approx(idle, abs=100 * (RATE * 1000 - 1) + 1e-9)
    assert shares["step_host"] == pytest.approx(100 * 85_000 * RATE / 1e6 / window_s)
    assert spans.idle_shares({"kind": "train", "window_s": 1.0}) == {}
    assert spans.idle_shares({"kind": "serve", "window_s": 1.0, "idle_by_cause": {}}) == {}


def test_set_up_stretches_leave_out_a_kernel_build_inside_the_first_step():
    setup = [
        _span("engine.init", 0, 2_000_000_000, None, 0),
        _span("train.create_state", 2_000_000_000, 2_500_000_000, None, 0),
        _span("engine.device_data", 2_500_000_000, 5_000_000_000, None, 0),
        _span("engine.device_data", 5_000_000_000, 5_500_000_000, None, 0),
        _span("engine.epoch", 6_000_000_000, 16_000_000_000, None, 0),
        _span("engine.steps", 6_100_000_000, 15_000_000_000, 4, 1),
        _span("engine.step", 6_100_000_000, 15_000_000_000, 5, 2),
        _span("engine.warmup_step", 6_100_000_000, 15_000_000_000, 6, 3),
        _span("kernels.load", 6_200_000_000, 14_000_000_000, 7, 4),
        _span("kernels.build", 6_300_000_000, 13_300_000_000, 8, 5),
        _span("graph.capture", 17_000_000_000, 17_250_000_000, None, 0),
        _span("kernels.build", 20_000_000_000, 21_000_000_000, None, 0),  # outside both
    ]
    found = spans.setup_seconds(setup)
    assert found["setup_engine_data_s"] == pytest.approx(5.5)
    assert found["setup_first_steps_s"] == pytest.approx(8.9 - 7.0 + 0.25)
