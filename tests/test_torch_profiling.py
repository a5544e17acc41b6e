"""The port's spans and counters (``utils/profiling.py``) and where the
Engine, its captured step, set-up and the kernel loader open them.

A span is kept only inside ``recording()``; outside it (and outside
``profile_trace``) ``span()`` hands back one shared no-op. Counters always
count. On the CPU the Engine runs eagerly; its graphed path runs on
``test_torch_graphs``' stand-in capture.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu_torch.models import registry
from multi_task_breast_cancer_tpu_torch.ops import _build
from multi_task_breast_cancer_tpu_torch.train.loop import Engine, EngineConfig
from multi_task_breast_cancer_tpu_torch.train.state import create_train_state
from multi_task_breast_cancer_tpu_torch.utils import profiling as P
from test_torch_graphs import WIDTHS, _fold, _StandIn, one_torch_thread, stand_in  # noqa: F401

B = 2
SIZE = 32


def _names(spans):
    return [s["name"] for s in spans]


def _children(spans, parent):
    return [s["name"] for s in spans if s["parent"] == parent]


def test_spans_nest_with_parents_depths_and_self_time():
    with P.recording() as rec:
        with P.span("outer"):
            with P.span("a"):
                time.sleep(0.002)
            with P.span("b"):
                with P.span("c"):
                    time.sleep(0.002)
        with P.span("after"):
            pass
    spans = rec.export()
    assert _names(spans) == ["outer", "a", "b", "c", "after"]
    assert [s["parent"] for s in spans] == [None, 0, 0, 2, None]
    assert [s["depth"] for s in spans] == [0, 1, 1, 2, 0]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    own = P.self_ns(spans)
    dur = [s["end_ns"] - s["start_ns"] for s in spans]
    assert own[0] == dur[0] - dur[1] - dur[2] and own[2] == dur[2] - dur[3]
    assert own[1] == dur[1] and own[3] == dur[3] and own[3] >= 2_000_000
    assert all(o >= 0 for o in own)


def test_a_span_that_raises_is_closed_and_its_parent_goes_on():
    with P.recording() as rec:
        with P.span("outer"):
            with pytest.raises(ValueError):
                with P.span("fails"):
                    raise ValueError
            with P.span("next"):
                pass
    spans = rec.export()
    assert [s["parent"] for s in spans] == [None, 0, 0]
    assert all(s["end_ns"] is not None for s in spans)


def test_off_keeps_nothing_and_every_span_is_one_shared_no_op():
    assert not P._on
    first = P.span("engine.step")
    assert P.span("graph.replay") is first and P.span("anything") is first
    with first:
        with P.span("inner"):
            pass
    with P.recording() as rec:
        inside = P.span("kept")
        assert inside is not first
        with inside:
            pass
    assert P.span("engine.step") is first and not P._on
    assert _names(rec.export()) == ["kept"]
    with pytest.raises(RuntimeError):
        with P.recording():
            with P.recording():
                pass
    assert not P._on


def test_counters_always_count_and_are_read_as_copies():
    before = P.counters()
    P.count("test.things")
    P.count("test.things", 4)
    with P.recording():
        P.count("test.things")
    after = P.counters()
    assert after["test.things"] - before.get("test.things", 0) == 6
    after["test.things"] = -1
    assert P.counters()["test.things"] != -1


def test_step_timer_sums_are_unchanged_and_each_phase_is_a_span():
    timer = P.StepTimer()
    with P.recording() as rec:
        for _ in range(3):
            with timer("train"):
                time.sleep(0.005)
        with timer("eval"):
            time.sleep(0.005)
    assert timer.counts == {"train": 3, "eval": 1}
    s = timer.summary()
    assert set(s) == {"train", "eval"} and s["train"] >= 0.005 and s["eval"] >= 0.005
    spans = rec.export()
    assert _names(spans) == ["train", "train", "train", "eval"]
    spans_s = sum(x["end_ns"] - x["start_ns"] for x in spans[:3]) / 1e9
    assert spans_s <= timer.totals["train"] < spans_s + 0.005


def test_profile_trace_writes_each_span_as_an_annotation(tmp_path):
    path = tmp_path / "trace.json"
    with P.profile_trace(str(path)):
        with P.span("engine.epoch"):
            with P.span("engine.step"):
                torch.ones(8).sum()
    assert not P._on
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"engine.epoch", "engine.step"} <= names


def _engine(cuda_graphs_on_cpu: bool = False):
    model = registry.init_multitask_model("MTnnUNet", nnunet_widths=WIDTHS,
                                          generator=torch.Generator().manual_seed(3))
    engine = Engine(model, EngineConfig(task="multitask", batch_size=B,
                                        fast_augmentation=True), device="cpu")
    engine.graphed = cuda_graphs_on_cpu
    return engine


def _epochs(engine, valid, with_validation: bool = True):
    """Set-up and two epochs (padding steps where ``valid`` has zeros),
    recorded; returns (spans, counters' growth)."""
    before = P.counters()
    with P.recording() as rec:
        state = create_train_state(engine.model, "Adam", 1e-3)
        _StandIn.params = list(engine.model.parameters())
        train = engine.device_data(_fold(8, 5, SIZE))
        val = engine.device_data(_fold(4, 6, SIZE), for_training=False)
        for epoch in range(2):
            perm = np.random.default_rng(epoch).permutation(8)[:len(valid) * B]
            gen = torch.Generator().manual_seed(epoch)
            if with_validation:
                engine.train_and_eval_epoch(state, train, val, perm, gen, step_valid=valid)
            else:
                engine.train_epoch(state, train, perm, gen, step_valid=valid)
    grown = {k: v - before.get(k, 0) for k, v in P.counters().items()}
    return rec.export(), {k: v for k, v in grown.items() if v}


def test_eager_engine_spans_each_epoch_and_each_real_step():
    valid = np.array([1, 0, 1, 1], np.float32)  # one padding step between real ones
    engine = _engine()
    spans, grown = _epochs(engine, valid)
    top = [s for s in spans if s["parent"] is None]
    assert _names(top) == ["train.create_state", "engine.device_data", "engine.device_data",
                           "engine.epoch", "engine.epoch"]
    for epoch in (i for i, s in enumerate(spans) if s["name"] == "engine.epoch"):
        assert _children(spans, epoch) == ["engine.plan", "engine.steps", "engine.sums",
                                           "engine.validation", "engine.fetch"]
        assert _children(spans, epoch + 1) == ["engine.draws", "engine.graph_key"]
        steps = next(i for i, s in enumerate(spans)
                     if s["parent"] == epoch and s["name"] == "engine.steps")
        assert _children(spans, steps) == ["engine.step"] * 3  # none for the padding step
        for step in (i for i, s in enumerate(spans) if s["parent"] == steps):
            assert _children(spans, step) == ["engine.eager_step"]
    assert grown == {"engine.eager_steps": 6}
    # Engine.__init__ ran before the recording; a new Engine is one span
    with P.recording() as rec:
        _engine()
    assert _names(rec.export()) == ["engine.init"]


def test_train_epoch_alone_fetches_without_validation():
    spans, _ = _epochs(_engine(), np.ones(2, np.float32), with_validation=False)
    epoch = _names(spans).index("engine.epoch")
    assert _children(spans, epoch) == ["engine.plan", "engine.steps", "engine.sums",
                                       "engine.fetch"]


def test_graphed_engine_captures_once_and_replays_every_later_step(stand_in):
    valid = np.array([1, 1, 0, 1], np.float32)
    spans, grown = _epochs(_engine(cuda_graphs_on_cpu=True), valid)
    # 6 real steps: the first eager on the side stream, the second captures
    # and replays, every later one replays; padding steps do nothing
    assert grown == {"engine.eager_steps": 1, "graph.captures": 1, "graph.replays": 5}
    assert len(stand_in.made) == 1 and stand_in.made[0].replays == 5
    steps = [i for i, s in enumerate(spans) if s["name"] == "engine.step"]
    assert [_children(spans, i) for i in steps] == (
        [["engine.warmup_step"], ["graph.capture", "graph.replay"]] + [["graph.replay"]] * 4)


def test_the_kernel_loader_spans_a_load_and_the_build_inside_it(monkeypatch, tmp_path):
    """A library not loaded yet: one ``kernels.load`` with a ``kernels.build``
    child when the compiler runs; a second call is the loaded library."""
    fake_nvcc = tmp_path / "nvcc"
    fake_nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                         "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake_nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake_nvcc))
    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("loaded", path))
    before = P.counters()
    with P.recording() as rec:
        lib = _build.library("fast_augment")
        assert _build.library("fast_augment") is lib
    assert _names(rec.export()) == ["kernels.load", "kernels.build"]
    assert rec.export()[1]["parent"] == 0
    grown = {k: P.counters()[k] - before.get(k, 0) for k in ("kernels.loads", "kernels.builds")}
    assert grown == {"kernels.loads": 1, "kernels.builds": 1}
    # built already: a fresh process loads it without the compiler
    monkeypatch.setattr(_build, "_libraries", {})
    with P.recording() as rec:
        _build.library("fast_augment")
    assert _names(rec.export()) == ["kernels.load"]
