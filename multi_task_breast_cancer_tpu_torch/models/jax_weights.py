"""Weight bridge: the JAX package's parameter tree → the port's ``state_dict``,
and back (``params_to_jax``, which writes JAX-format weights;
``flat_jax_weights``, a serving artifact's flat ``weights.npz``).

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
  ``deconv_kernel`` alike. Every transposed conv named ``kernel`` sits in a
  module whose name starts with ``upsample``: the nnU-Net family's and
  Adityan's ``upsample1-5``, the UNet++ ``UpCat``s' ``upsample``;
- an affine norm's ``scale`` and ``bias`` and every bias keep their layout.

The BTS models flatten NCHW maps in JAX's (h, w, c) order
(``blocks.flatten_hwc``), so a dense layer after a flatten is a plain
transpose too.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` → the JAX parameter tree (nested, float32
    numpy, without the ``params`` level): the inverse of
    :func:`params_from_jax`."""
    tree: dict = {}
    for name, t in state_dict.items():
        *owner, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            leaf = "kernel"
            if arr.ndim == 4:
                arr = (_undeconv(arr) if owner and owner[-1].startswith("upsample")
                       else _unconv(arr))
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{name}: unexpected weight shape {arr.shape}")
        elif leaf == "deconv_kernel":
            arr = _undeconv(arr)
        elif leaf == "conv1x1_kernel":
            arr = _unconv(arr)
        node = tree
        for key in owner:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(arr, np.float32)
    return tree


def flat_jax_weights(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` as a JAX serving artifact's ``weights.npz``
    holds it: ``/``-joined paths under ``params``
    (``params/backbone/encoder1/block1/conv/kernel``), JAX layouts
    (:func:`params_to_jax`). :func:`params_from_jax` reads it back."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        for key in sorted(node):
            path = f"{prefix}{_SEP}{key}"
            if isinstance(node[key], Mapping):
                walk(path, node[key])
            else:
                flat[path] = node[key]

    walk("params", params_to_jax(state_dict))
    return flat


def _undeconv(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 0, 1)[::-1, ::-1]


def _unconv(w: np.ndarray) -> np.ndarray:
    return w.transpose(2, 3, 1, 0)


def size_knobs_from_params(params) -> Dict[str, Any]:
    """The size knobs a model is built with, read from its weights (a JAX
    serving artifact's manifest records none of them), as factory keyword
    arguments:

    - the nnU-Net family: ``nnunet_widths``, the five encoder widths (under
      ``backbone`` in the segmentation and multitask models);
    - the BTS family: ``width``, the first level's width (``encoder1``,
      ``trunk/encoder1`` or the classifier's ``enc1``), and, with a
      segmentation head, ``deep_supervision``: whether ``output3`` exists;
    - Adityan: ``width`` (``encoder1/conv1``);
    - the UNet++ family (fixed widths): ``deep_supervision``, whether
      ``final_conv_0_1`` exists. ``MTUNetPlusPlus`` holds all four heads
      either way, so it reads as deep-supervised; its served answer (the
      finest head and the mean of one class head) is the same both ways.
    """
    flat = _flat(params)
    for prefix in ("backbone/", ""):
        if f"{prefix}encoder5/block2/conv/kernel" in flat:
            return {"nnunet_widths": tuple(
                int(flat[f"{prefix}encoder{i}/block2/conv/kernel"].shape[-1])
                for i in range(1, 6))}
    for first in ("encoder1/block2", "trunk/encoder1/block2", "enc1/block2"):
        if f"{first}/conv/kernel" in flat:
            knobs = {"width": int(flat[f"{first}/conv/kernel"].shape[-1])}
            if "output1/kernel" in flat:
                knobs["deep_supervision"] = "output3/deconv_kernel" in flat
            return knobs
    if "encoder1/conv1/kernel" in flat:
        return {"width": int(flat["encoder1/conv1/kernel"].shape[-1])}
    if "final_conv_0_4/kernel" in flat:
        return {"deep_supervision": "final_conv_0_1/kernel" in flat}
    return {}
