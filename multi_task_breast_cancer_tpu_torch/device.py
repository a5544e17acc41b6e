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
