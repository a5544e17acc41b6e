"""Tracing hooks (twin of ``multi_task_breast_cancer_tpu/utils/profiling.py``)
and the port's own spans and counters.

- :func:`span`: a named stretch of host time at a layer boundary (the
  Engine's epochs and steps, the captured programs, set-up). Outside
  :func:`recording` and :func:`profile_trace` it is one shared no-op after
  a single module-level check: nothing is allocated and nothing is timed;
  :func:`spanned` makes a function one span;
- :func:`recording`: keeps every span opened inside it (name, start and end
  on ``time.perf_counter_ns``, parent, depth) in memory; its
  :meth:`Recording.export` returns them;
- :func:`count` / :func:`counters`: named integers that always count, as
  the launch counters of :mod:`..ops.launches` do;
- :func:`profile_trace`: ``torch.profiler`` over the CPU and, where there is
  one, the GPU, exported as a Chrome trace (Perfetto, ``chrome://tracing``);
  inside it every span is also a ``record_function`` range, so the trace
  shows the spans above the kernels;
- :func:`maybe_profile`: the driver's hook; with ``MTBC_PROFILE=<dir>`` set,
  epochs 1 and 2 of fold 0 are traced to ``<dir>/trace_fold0_epoch<e>.json``;
- :class:`StepTimer`: wall-clock sums per phase, each phase a span.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

_NOOP = contextlib.nullcontext()  # what span() returns while nothing traces

_on = False  # span()'s one check: a recording is open or profile_trace runs
_recording: Optional["Recording"] = None
_annotating = False

COUNTS: Dict[str, int] = defaultdict(int)


def _refresh() -> None:
    global _on
    _on = _recording is not None or _annotating


class Recording:
    """The spans opened while :func:`recording` runs, in the order they
    were opened; each thread nests its own."""

    def __init__(self) -> None:
        self.spans: List["_Span"] = []
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def export(self) -> List[dict]:
        """One dict per span, in the order opened: ``name``, ``start_ns``,
        ``end_ns`` (``None`` while it is still open), ``parent`` (index of
        the enclosing span in this list, or ``None``) and ``depth``."""
        return [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
                 "parent": s.parent, "depth": s.depth} for s in self.spans]


class _Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "depth", "_stack", "_range")

    def __init__(self, name: str):
        self.name = name
        self.end_ns = None
        self._stack = self._range = None

    def __enter__(self) -> "_Span":
        rec = _recording
        if rec is not None:
            stack = self._stack = rec._stack()
            self.parent = stack[-1] if stack else None
            self.depth = len(stack)
            stack.append(len(rec.spans))
            rec.spans.append(self)
        if _annotating:
            from torch.profiler import record_function
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        if self._stack is not None:
            self._stack.pop()


def span(name: str):
    """A context manager: the stretch of host time inside it as a span named
    ``name``, where something traces; else the shared no-op."""
    if not _on:
        return _NOOP
    return _Span(name)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: every call of the function is a span named ``name``."""
    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Keep the spans opened inside: ``with recording() as rec: ...`` then
    ``rec.export()``. One recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording of spans is already open")
    rec = _recording = Recording()
    _refresh()
    try:
        yield rec
    finally:
        _recording = None
        _refresh()


def self_ns(spans: List[dict]) -> List[int]:
    """Each exported span's self time: its duration less its children's."""
    own = [s["end_ns"] - s["start_ns"] for s in spans]
    for s in spans:
        if s["parent"] is not None:
            own[s["parent"]] -= s["end_ns"] - s["start_ns"]
    return own


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTS[name] += n


def counters() -> Dict[str, int]:
    """Every counter's value now (a copy: subtract two to get the growth)."""
    return dict(COUNTS)


@contextlib.contextmanager
def profile_trace(trace_path: str) -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    global _annotating
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
    with profile(activities=activities) as prof:
        before, _annotating = _annotating, True
        _refresh()
        try:
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            _annotating = before
            _refresh()
    prof.export_chrome_trace(trace_path)


def maybe_profile(epoch: int, fold: int) -> contextlib.AbstractContextManager:
    """Trace epochs 1-2 of fold 0 when ``MTBC_PROFILE`` is set."""
    log_dir = os.environ.get("MTBC_PROFILE")
    if log_dir and fold == 0 and epoch in (1, 2):
        return profile_trace(os.path.join(log_dir, f"trace_fold0_epoch{epoch}.json"))
    return contextlib.nullcontext()


class StepTimer:
    """Accumulates wall-clock per phase: ``with timer('train'): ...``; each
    phase is also a span of the same name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(phase):
                yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> Dict[str, float]:
        return {phase: self.totals[phase] / max(self.counts[phase], 1)
                for phase in self.totals}
