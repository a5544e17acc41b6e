"""One profiled window of the card: ``torch.profiler`` with CUDA activity
around a stretch of the run, its device activities read from the exported
trace. The device is busy where some activity (a kernel, a copy, a set)
runs; overlapping activities count once.

The profiler has lost a window's first device activities, so a lead-in
runs first and only what lies between two marker kernels, launched after
the lead-in and after the stretch, is kept. The marker is the CUDA runtime's
spin kernel (``torch.cuda._sleep``), which the port never launches.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import Counter
from typing import Callable, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"


def kernel_class(name: str) -> str:
    """The class of a device activity, by its name, for the breakdowns."""
    n = name.lower()
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "cuDNN layout conversions"
    if "instance_norm_leaky_relu" in n:
        return "norm backward (#2)" if "backward" in n else "norm forward (#1)"
    if "fast_augment" in n:
        return "augmentation (#3)"
    if any(k in n for k in ("xmma", "cudnn", "conv", "fft", "dgrad", "wgrad", "winograd",
                            "gemm", "cutlass", "sgemm", "implicit")):
        return "convolutions and GEMMs (cuDNN, cuBLAS)"
    if any(k in n for k in ("adam", "multi_tensor", "foreach")):
        return "optimizer"
    if "memcpy" in n or "memset" in n:
        return "copies and sets"
    if "softmax" in n:
        return "softmax"
    return "elementwise, reductions"


def _marker(torch) -> None:
    torch.cuda._sleep(1)


def _lead_in(torch) -> None:
    x = torch.zeros(1024, device="cuda")
    for _ in range(1024):
        x.add_(1.0)
    torch.cuda.synchronize()


def parse(trace: dict) -> dict:
    """The device activities between the two markers of an exported trace:
    ``events`` (start µs, end µs, category, name, correlation id), the
    runtime calls by correlation id, and ``markers`` found."""
    spans = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    events = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     str(e.get("cat", "")).lower(), str(e.get("name", "")),
                     (e.get("args") or {}).get("correlation"))
                    for e in spans if str(e.get("cat", "")).lower() in DEVICE_CATEGORIES)
    runtime = {(e.get("args") or {}).get("correlation"): str(e.get("name", ""))
               for e in spans if str(e.get("cat", "")).lower() in RUNTIME_CATEGORIES}
    marks = [k for k, e in enumerate(events) if MARKER in e[3]]
    if len(marks) != 2:
        return {"events": None, "markers": len(marks)}
    return {"events": events[marks[0] + 1:marks[1]], "runtime": runtime, "markers": 2,
            "start": events[marks[0]][1], "end": events[marks[1]][0]}


def busy_us(events) -> float:
    busy, start, end = 0.0, None, None
    for a, b, *_ in events:
        if end is None or a > end:
            busy += 0.0 if end is None else end - start
            start, end = a, b
        else:
            end = max(end, b)
    return busy + (0.0 if end is None else end - start)


def idle_gaps(parsed: dict) -> Counter:
    """Idle µs of the window by what ended each gap: the host's runtime call
    that launched the next activity, and that activity's class."""
    gaps = Counter()
    last = parsed["start"]
    for a, b, _, name, corr in parsed["events"]:
        if a > last:
            call = parsed["runtime"].get(corr, "unknown call")
            gaps[f"{call} -> {kernel_class(name)}"] += a - last
        last = max(last, b)
    if parsed["end"] > last:
        gaps["end of window"] += parsed["end"] - last
    return gaps


def window(torch, fn: Callable[[], None], attempts: int = 3) -> Optional[dict]:
    """Profile ``fn`` (synchronised, host clock around it). Returns
    ``window_s`` (host), ``busy_s`` (the union of the device activities),
    ``kernels`` (device seconds and count by name), ``classes`` (device
    seconds by class), ``gaps`` (idle seconds by what ended them); or
    ``None`` if every attempt lost a marker."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in(torch)
            _marker(torch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            _marker(torch)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                parsed = parse(json.load(f))
        finally:
            os.remove(path)
        if parsed["events"] is not None:
            break
        print(f"trace: {parsed['markers']} markers found of 2; profiling again",
              file=sys.stderr, flush=True)
    else:
        return None
    kernels = {}
    classes = Counter()
    for a, b, _, name, _ in parsed["events"]:
        s, n = kernels.get(name, (0.0, 0))
        kernels[name] = (s + (b - a) / 1e6, n + 1)
        classes[kernel_class(name)] += (b - a) / 1e6
    return {"window_s": host_s, "busy_s": busy_us(parsed["events"]) / 1e6,
            "kernels": kernels, "classes": dict(classes),
            "gaps": {k: v / 1e6 for k, v in idle_gaps(parsed).items()}}


def breakdown(traced: dict) -> dict:
    """The result line's ``breakdown``: device seconds by class and idle
    seconds by what ended the gap, each the ten largest."""
    top = lambda d: [[k, v] for k, v in Counter(d).most_common(10)]  # noqa: E731
    return {"device_ops": top(traced["classes"]), "idle_gaps": top(traced["gaps"])}
