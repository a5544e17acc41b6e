"""Build the hand-written CUDA kernels on first use, load them with ctypes,
and call their C entry points: the one boundary between the port's Python
and its ``.cu`` libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface under ``build/torch_kernels/`` at the
repository root (git-ignored). The library's file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. ``ptxas`` reports each kernel's registers and spills (``-Xptxas -v``);
the report is kept beside the library (``build_log``). Nothing here runs at
import time: the CPU tests import every module of the port on machines
without ``nvcc`` or a GPU.

:func:`launch` is the one caller of the entry points: it binds an entry on
its first call, passes the current stream, raises on a failed launch and
counts a good one in the calling wrapper's ``launches`` (:mod:`.launches`).
The card's facts the planners share and the entries' dtype suffixes live
here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from multi_task_breast_cancer_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}

DTYPE_SUFFIXES = {torch.float32: "f32", torch.bfloat16: "bf16"}
H100_SMS = 132  # an H100 SXM's SMs: the planners' default card
STREAM = object()  # in :func:`launch`'s arguments: the card's current stream


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "of this package are compiled on first use")


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the given kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together, keeping each compiler's output
    beside its library (a ``kernels.build`` span, counted in
    ``kernels.builds``). Returns the seconds taken; raises ``RuntimeError``
    with the compiler's output if one fails."""
    t0 = time.perf_counter()
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    missing = [name for name in names if not _target(name).exists()]
    if not missing:
        return time.perf_counter() - t0
    failures = []
    with profiling.span("kernels.build"):
        jobs = []
        for name in missing:
            out = _target(name)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    profiling.count("kernels.builds", len(jobs))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """The compiler's output (with ptxas's register and spill report) of the
    built ``csrc/<name>.cu``; empty if it was not built here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (a
    ``kernels.load`` span, counted in ``kernels.loads``)."""
    lib = _libraries.get(name)  # loaded: no lock needed to read it
    if lib is not None:
        return lib
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            with profiling.span("kernels.load"):
                build([name])
                lib = _libraries[name] = ctypes.CDLL(str(_target(name)))
            profiling.count("kernels.loads")
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA card ``index``, asked once a card."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _argtype(value):
    if value is None or value is STREAM or isinstance(value, torch.Tensor):
        return ctypes.c_void_p
    if isinstance(value, int):
        return ctypes.c_int
    if isinstance(value, float):
        return ctypes.c_float
    raise TypeError(f"no C argument type for {type(value).__name__}")


def _bind(fn, args) -> None:
    """Declare the C entry ``fn``'s argument types from its first call's
    ``args``, and note where its pointers and its stream go."""
    argtypes = [_argtype(a) for a in args]
    fn.stream_arg = [a is STREAM for a in args].index(True)  # every entry takes its stream
    fn.pointer_args = tuple(i for i, a in enumerate(args)
                            if a is None or isinstance(a, torch.Tensor))
    fn.argtypes, fn.restype = argtypes, ctypes.c_int


def launch(source: str, entry: str, device, *args, dtype: Optional[torch.dtype] = None,
           counter=None, plan=None) -> None:
    """Call ``entry`` (``entry_<suffix>`` for ``dtype``) of ``csrc/<source>.cu``
    on ``device``'s card, ``args`` in the entry's order: a tensor as its data
    pointer, ``None`` as a null pointer, :data:`STREAM` as the current stream
    (read at each call: a graph captures on a side stream), an ``int`` as a
    C ``int`` and a ``float`` as a C ``float`` (the first call declares the
    types from its values). A non-zero ``cudaError_t`` raises
    ``RuntimeError`` naming the entry, the error, the tensors' shapes and
    dtype and ``plan``, and counts nothing; a good launch adds one to
    ``counter.launches`` where a counter is given."""
    name = entry if dtype is None else f"{entry}_{DTYPE_SUFFIXES[dtype]}"
    fn = getattr(library(source), name)
    if fn.argtypes is None:
        _bind(fn, args)
    values = list(args)
    for i in fn.pointer_args:  # by position: an isinstance test per argument costs more
        if values[i] is not None:
            values[i] = values[i].data_ptr()
    with torch.cuda.device(device):
        values[fn.stream_arg] = torch.cuda.current_stream(device).cuda_stream
        err = fn(*values)
    if err != 0:
        shapes = ", ".join(str(tuple(a.shape)) for a in args if isinstance(a, torch.Tensor))
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} at tensors {shapes}"
                           + ("" if dtype is None else f" {dtype}")
                           + ("" if plan is None else f", plan {plan}"))
    if counter is not None:
        counter.launches += 1
