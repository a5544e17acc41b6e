"""Weight bridge: the JAX package's parameter tree → the port's ``state_dict``.

The JAX tree is taken as numpy, nested (``variables["params"]``) or flat with
``/``-joined paths, as a JAX serving artifact's ``weights.npz`` stores it
(``params/backbone/encoder1/block1/conv/kernel``). Paths map one to one onto
the port's module names; only layouts change:

- conv kernels HWIO → OIHW (``DeconvHead.conv1x1_kernel`` too);
- dense kernels (I, O) → (O, I);
- transposed-conv kernels HWIO → (I, O, kh, kw) with the taps flipped, the
  inverse of ``torch_import.deconv_kernel`` in the JAX package:
  ``lax.conv_transpose`` (no kernel transpose) applies tap ``(k-1-a, k-1-b)``
  where ``ConvTranspose2d`` applies ``(a, b)``. That holds for the
  ``upsample*`` layers (``nn.ConvTranspose``) and for ``DeconvHead``'s
  ``deconv_kernel`` alike. In the nnU-Net family the ``upsample*`` modules
  are the only transposed convs named ``kernel``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_SEP = "/"


def _flat(params) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        for key, value in node.items():
            path = f"{prefix}{_SEP}{key}" if prefix else str(key)
            if isinstance(value, Mapping):
                walk(path, value)
            else:
                out[path] = np.asarray(value)

    walk("", params)
    flat = {}
    for path, arr in out.items():
        head, _, rest = path.partition(_SEP)
        if head == "batch_stats":
            raise ValueError(f"{path}: batch statistics belong to no ported model")
        flat[rest if head == "params" else path] = arr
    return flat


def _deconv(w: np.ndarray) -> np.ndarray:
    return w[::-1, ::-1].transpose(2, 3, 0, 1)


def _conv(w: np.ndarray) -> np.ndarray:
    return w.transpose(3, 2, 0, 1)


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX params (nested or flat, with or without the ``params`` level) →
    the port's ``state_dict`` (float32 CPU tensors)."""
    state = {}
    for path, arr in _flat(params).items():
        *owner, leaf = path.split(_SEP)
        name = leaf
        if leaf == "kernel":
            name = "weight"
            if arr.ndim == 4:
                arr = _deconv(arr) if owner and owner[-1].startswith("upsample") else _conv(arr)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{path}: unexpected kernel shape {arr.shape}")
        elif leaf == "deconv_kernel":
            arr = _deconv(arr)
        elif leaf == "conv1x1_kernel":
            arr = _conv(arr)
        state[".".join(owner + [name])] = torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C"))  # a writable copy
    return state


def widths_from_params(params) -> Tuple[int, ...]:
    """The nnU-Net family's five level widths, read from the encoder kernels
    (a serving artifact's manifest does not record ``nnunet_widths``). The
    segmentation and multitask models keep the encoder under ``backbone``;
    ``NNUNetClassifier`` at the top level."""
    flat = _flat(params)
    prefix = "backbone/" if "backbone/encoder1/block2/conv/kernel" in flat else ""
    return tuple(int(flat[f"{prefix}encoder{i}/block2/conv/kernel"].shape[-1])
                 for i in range(1, 6))
