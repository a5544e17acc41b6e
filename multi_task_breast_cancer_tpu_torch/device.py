"""Where the port runs: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Union

import torch

# the compute dtypes of ``training.compute_dtype``, by name
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda:0``, or ``cuda:{LOCAL_RANK}`` under a process group
    (one rank per GPU, :mod:`.parallel.multihost`). A CUDA device without a
    usable GPU raises ``RuntimeError``: the port never falls back to the CPU
    on its own, so a CPU run is always one the caller asked for
    (``device="cpu"``)."""
    if device is None:
        from multi_task_breast_cancer_tpu_torch.parallel import multihost
        device = f"cuda:{multihost.local_rank()}" if multihost.active() else "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                f"pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def replica_devices(device: Optional[Union[str, torch.device]] = None,
                    data_parallel: bool = True,
                    devices: Optional[Sequence[Union[str, torch.device]]] = None
                    ) -> List[torch.device]:
    """The devices of a serving backend's model replicas, one replica each:
    ``devices`` when given (a device may repeat: two replicas on one card);
    else, with ``data_parallel`` and ``device`` ``None`` or ``"cuda"`` (no
    index), every visible GPU, as JAX replicates over its local devices;
    else ``[resolve_device(device)]``."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    first = resolve_device(device)
    any_gpu = device is None or torch.device(device) == torch.device("cuda")
    if data_parallel and first.type == "cuda" and any_gpu and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [first]


def stream_context(stream):
    """``torch.cuda.stream(stream)``, or nothing for ``None`` (the CPU, or
    one replica on the current stream)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def replica_streams(devices: Sequence[torch.device]) -> list:
    """A stream of its own for each replica on a GPU when there are several
    replicas, so that their executions may overlap; ``None`` otherwise."""
    if len(devices) < 2:
        return [None] * len(devices)
    return [torch.cuda.Stream(d) if d.type == "cuda" else None for d in devices]


def set_float32_policy(device: torch.device, compute_dtype: str) -> None:
    """Every float32 op on a CUDA device computes in float32: TF32 off in
    cuDNN convolutions and in matmuls, which would otherwise keep about 3
    decimal digits and drift from the JAX reference for that reason alone.
    Under ``compute_dtype == "bfloat16"`` the model runs in bf16, and the f32
    ops that remain (losses, metrics, Adam's update) stay float32 all the
    same. The switches are process-wide; every entry point that builds a
    model on the card (the Engine, the serving backends, the export) calls
    this."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {compute_dtype!r} is not one of {sorted(COMPUTE_DTYPES)}")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
