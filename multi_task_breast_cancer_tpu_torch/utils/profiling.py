"""Tracing hooks (twin of ``multi_task_breast_cancer_tpu/utils/profiling.py``).

- :func:`profile_trace`: ``torch.profiler`` over the CPU and, where there is
  one, the GPU, exported as a Chrome trace (Perfetto, ``chrome://tracing``);
- :func:`maybe_profile`: the driver's hook; with ``MTBC_PROFILE=<dir>`` set,
  epochs 1 and 2 of fold 0 are traced to ``<dir>/trace_fold0_epoch<e>.json``;
- :class:`StepTimer`: wall-clock sums per phase.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def profile_trace(trace_path: str) -> Iterator[None]:
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)


def maybe_profile(epoch: int, fold: int) -> contextlib.AbstractContextManager:
    """Trace epochs 1-2 of fold 0 when ``MTBC_PROFILE`` is set."""
    log_dir = os.environ.get("MTBC_PROFILE")
    if log_dir and fold == 0 and epoch in (1, 2):
        return profile_trace(os.path.join(log_dir, f"trace_fold0_epoch{epoch}.json"))
    return contextlib.nullcontext()


class StepTimer:
    """Accumulates wall-clock per phase: ``with timer('train'): ...``."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def summary(self) -> Dict[str, float]:
        return {phase: self.totals[phase] / max(self.counts[phase], 1)
                for phase in self.totals}
