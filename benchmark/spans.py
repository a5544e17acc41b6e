"""The port's spans (``multi_task_breast_cancer_tpu_torch/utils/profiling.py``)
on the device trace's clock, and each idle gap of a profiled window put
down to the host work that caused it.

The program stamps its spans with ``time.perf_counter_ns``; the profiler's
trace has a clock of its own. The window's two marker kernels tie them:
the host reads ``perf_counter_ns`` just before and just after each marker's
launch, and the trace holds that launch as a ``cudaLaunchKernel`` runtime
event. The middle of each pair of stamps is matched with the middle of its
runtime event; the two markers give the offset and the rate of the map.

Each idle gap (as ``trace.idle_gaps`` walks them, clipped to the host
window whose share ``device_idle_pct.train`` reads) is ended by an
activity, launched by a runtime call. The innermost span around that call
sorts the gap:

- ``validation``: the call was made inside ``engine.validation``;
- ``device_side``: inside ``engine.steps``, and the call had returned
  before the gap opened: the work was queued, and the device itself left
  the gap (node-to-node or graph-to-graph latency);
- ``step_host``: inside ``engine.steps``, and the call was still to come or
  still running when the gap opened: the device waited for the host;
- ``epoch_edges``: inside ``engine.plan``, ``engine.sums`` or
  ``engine.fetch``;
- ``outside``: anywhere else, the window's last gap and a call the trace
  does not hold.

The gaps are the trace's; the spans only sort them, so the five classes
add up to the window's idle time.
"""

from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark import trace

CLASSES = ("device_side", "step_host", "validation", "epoch_edges", "outside")
EDGES = ("engine.plan", "engine.sums", "engine.fetch")
GRAPH_LAUNCH = "cudagraphlaunch"


def runtime_calls(raw: dict) -> Dict[object, Tuple[float, float, str]]:
    """The trace's runtime calls by correlation id: (start µs, end µs, name)."""
    out = {}
    for e in raw.get("traceEvents", []):
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() in trace.RUNTIME_CATEGORIES:
            ts = float(e["ts"])
            out[(e.get("args") or {}).get("correlation")] = (ts, ts + float(e.get("dur", 0)),
                                                            str(e.get("name", "")))
    return out


def marker_calls(raw: dict, calls: dict) -> List[Tuple[float, float, str]]:
    """The runtime calls that launched the marker kernels, in trace order."""
    marks = sorted((float(e["ts"]), (e.get("args") or {}).get("correlation"))
                   for e in raw.get("traceEvents", [])
                   if e.get("ph") == "X" and str(e.get("cat", "")).lower() in
                   trace.DEVICE_CATEGORIES and trace.MARKER in str(e.get("name", "")))
    return [calls[corr] for _, corr in marks if corr in calls]


class Clock:
    """``perf_counter_ns`` to the trace's µs, fitted on two markers: ``stamps``
    the host's (before, after) ns around each marker launch, ``launches``
    the (start, end) µs of their runtime events."""

    def __init__(self, stamps: Sequence[Tuple[int, int]], launches: Sequence[Tuple[float, float]]):
        if len(stamps) != 2 or len(launches) != 2:
            raise ValueError(f"a clock needs two markers, got {len(stamps)} stamps and "
                             f"{len(launches)} launches")
        (h0, h1), (t0, t1) = ([(a + b) / 2 for a, b in pair] for pair in (stamps, launches))
        self.host0, self.trace0 = h0, t0
        self.rate = (t1 - t0) / (h1 - h0)  # trace µs per host ns
        # how far each launch's runtime event lies from its stamps (µs):
        # the events must fall between them
        self.slack_us = [min(ta - self.at(a), self.at(b) - tb)
                         for (a, b), (ta, tb) in zip(stamps, launches)]

    def at(self, ns: float) -> float:
        return self.trace0 + self.rate * (ns - self.host0)


def _on_clock(spans: List[dict], clock: Clock) -> List[dict]:
    """``spans`` with ``start`` and ``end`` on the trace's clock (a span
    still open ends at infinity)."""
    return [dict(s, start=clock.at(s["start_ns"]),
                 end=float("inf") if s["end_ns"] is None else clock.at(s["end_ns"]))
            for s in spans]


class _Finder:
    """The innermost span around a time on the trace's clock (spans in the
    order opened, which is their order of start on one thread)."""

    def __init__(self, spans: List[dict]):
        self.spans = spans
        self.starts = [s["start"] for s in spans]

    def innermost(self, t: float) -> Optional[int]:
        """The last span opened at or before ``t`` holds it, or the nearest
        of its ancestors that does (spans nest)."""
        k = bisect.bisect_right(self.starts, t) - 1
        k = k if k >= 0 else None
        while k is not None and self.spans[k]["end"] < t:
            k = self.spans[k]["parent"]
        return k

    def chain(self, k: Optional[int]) -> List[str]:
        names = []
        while k is not None:
            names.append(self.spans[k]["name"])
            k = self.spans[k]["parent"]
        return names


def cause(chain: List[str], call_end: float, gap_start: float) -> str:
    """The class of a gap whose ending activity was launched by a call that
    returned at ``call_end`` inside the spans ``chain`` (innermost first)."""
    if "engine.validation" in chain:
        return "validation"
    if "engine.steps" in chain:
        return "device_side" if call_end <= gap_start else "step_host"
    if any(name in chain for name in EDGES):
        return "epoch_edges"
    return "outside"


def sort_gaps(parsed: dict, calls: dict, spans: List[dict], window: Tuple[float, float]
              ) -> dict:
    """Idle seconds of ``parsed`` (``trace.parse``) inside ``window`` (µs on
    the trace's clock), by class, by the innermost span of the launching
    call, and by the innermost span the host was in when the gap opened.
    ``spans`` are on the trace's clock (``start``, ``end`` µs)."""
    finder = _Finder(spans)
    classes, by_call, at_open = Counter(), Counter(), Counter()
    w0, w1 = window

    def add(opened_at: float, end: float, call) -> None:
        start, end = max(opened_at, w0), min(end, w1)
        if end <= start:
            return
        if call is None:
            klass, inner = "outside", "none"
        else:
            chain = finder.chain(finder.innermost(call[0]))
            klass, inner = cause(chain, call[1], opened_at), (chain[0] if chain else "none")
        opened = finder.innermost(start)
        classes[klass] += (end - start) / 1e6
        by_call[inner] += (end - start) / 1e6
        at_open[spans[opened]["name"] if opened is not None else "none"] += (end - start) / 1e6

    last = parsed["start"]
    for a, b, _, _, corr in parsed["events"]:
        if a > last:
            add(last, a, calls.get(corr))
        last = max(last, b)
    add(last, parsed["end"], None)
    return {"classes": {c: classes.get(c, 0.0) for c in CLASSES}, "spans": dict(by_call),
            "host_at_open": dict(at_open)}


def replay_alignment(spans: List[dict], calls: dict) -> dict:
    """How many ``graph.replay`` spans hold exactly one ``cudaGraphLaunch``
    runtime call on the fitted clock, of how many."""
    launches = sorted(s for s, _, name in calls.values() if GRAPH_LAUNCH in name.lower())
    replays = [s for s in spans if s["name"] == "graph.replay"]
    one = sum(1 for s in replays
              if bisect.bisect_right(launches, s["end"]) - bisect.bisect_left(launches, s["start"])
              == 1)
    return {"replays": len(replays), "one_launch": one}


def analyse(raw: dict, stamps: Sequence[Tuple[int, int]], host_ns: Tuple[int, int],
            spans: List[dict]) -> Optional[dict]:
    """The window's spans on the trace's clock and its idle gaps sorted:
    ``raw`` the exported trace, ``stamps`` the (before, after) ns around each
    marker launch, ``host_ns`` the host window (ns) whose share
    ``device_idle_pct.train`` reads, ``spans`` the recording's export.
    ``None`` where the trace lost a marker or its launch."""
    parsed = trace.parse(raw)
    calls = runtime_calls(raw)
    marks = marker_calls(raw, calls)
    if parsed["events"] is None or len(marks) != 2:
        return None
    clock = Clock(stamps, [(s, e) for s, e, _ in marks])
    on_clock = _on_clock(spans, clock)
    window = (clock.at(host_ns[0]), clock.at(host_ns[1]))
    inside = [s for s in on_clock if s["end"] >= window[0] and s["start"] <= window[1]]
    return {"idle_by_cause": sort_gaps(parsed, calls, on_clock, window),
            "replay_alignment": replay_alignment(inside, calls),
            "clock": {"rate": clock.rate, "slack_us": clock.slack_us}}


def idle_shares(record: dict) -> Dict[str, float]:
    """Each class's share of a traced record's window, in %: the five add up
    to ``device_idle_pct.train``'s reading. Empty where the record has no
    sorted gaps."""
    sorted_gaps = record.get("idle_by_cause")
    if record.get("kind") != "train" or not sorted_gaps or not record.get("window_s"):
        return {}
    return {c: 100.0 * s / record["window_s"] for c, s in sorted_gaps["classes"].items()}


def _seconds(spans: List[dict], names: Sequence[str], minus: Sequence[str] = ()) -> float:
    """Seconds inside spans named ``names`` (outermost ones only), less
    those of spans named ``minus`` inside them."""
    total = 0.0
    for s in spans:
        if s["end_ns"] is None:
            continue
        chain, k = [], s["parent"]
        while k is not None:
            chain.append(spans[k]["name"])
            k = spans[k]["parent"]
        inside = any(n in names for n in chain)
        if s["name"] in names and not inside:
            total += (s["end_ns"] - s["start_ns"]) / 1e9
        elif s["name"] in minus and inside:
            total -= (s["end_ns"] - s["start_ns"]) / 1e9
    return total


def setup_seconds(spans: List[dict]) -> Dict[str, float]:
    """Set-up's two stretches from its spans: the Engine and its data
    (``engine.init``, ``train.create_state``, ``engine.device_data``), and
    the first steps (the eager warm-up step and the capture, without a
    kernel build inside them, which only a checkout's first run pays)."""
    return {"setup_engine_data_s": _seconds(spans, ("engine.init", "train.create_state",
                                                    "engine.device_data")),
            "setup_first_steps_s": _seconds(spans, ("engine.warmup_step", "graph.capture"),
                                            ("kernels.build",))}
