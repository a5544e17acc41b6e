"""Where the port runs: the GPU unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda:0``. A CUDA device without a usable GPU raises
    ``RuntimeError``: the port never falls back to the CPU on its own, so a
    CPU run is always one the caller asked for (``device="cpu"``)."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                f"pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_float32_policy(device: torch.device, compute_dtype: str) -> None:
    """``compute_dtype == "float32"`` on a CUDA device computes in float32:
    TF32 off in cuDNN convolutions and in matmuls, which would otherwise keep
    about 3 decimal digits and drift from the JAX reference for that reason
    alone. The switches are process-wide; every entry point that builds a
    model on the card (the Engine, the serving backends) calls this."""
    if device.type == "cuda" and compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
