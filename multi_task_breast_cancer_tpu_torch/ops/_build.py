"""Build the hand-written CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface under ``build/torch_kernels/`` at the
repository root (git-ignored). The library's file name carries a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. ``ptxas`` reports each kernel's registers and spills (``-Xptxas -v``);
the report is kept beside the library (``build_log``). Nothing here runs at
import time: the CPU tests import every module of the port on machines
without ``nvcc`` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

from multi_task_breast_cancer_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


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
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            with profiling.span("kernels.load"):
                build([name])
                lib = _libraries[name] = ctypes.CDLL(str(_target(name)))
            profiling.count("kernels.loads")
        return lib
