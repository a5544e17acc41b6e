"""Weight bridge: the JAX package's variables → the port's ``state_dict``,
and back (``params_to_jax`` / ``variables_to_jax``, which write JAX-format
weights; ``flat_jax_weights``, a serving artifact's flat ``weights.npz``).

The JAX tree is taken as numpy, nested (``variables["params"]``, or the whole
``{"params": …, "batch_stats": …}``) or flat with ``/``-joined paths, as a
JAX serving artifact's ``weights.npz`` stores it
(``params/backbone/encoder1/block1/conv/kernel``,
``batch_stats/in_block/bn1/bn/mean``). Paths map one to one onto the port's
names: parameters onto parameters, ``batch_stats/<path>/mean|var`` onto the
buffers ``<path>.mean|var`` of :class:`~.blocks.BatchNorm`. Only layouts
change:

- conv kernels HWIO → OIHW (``DeconvHead.conv1x1_kernel`` too);
- dense kernels (I, O) → (O, I);
- transposed-conv kernels HWIO → (I, O, kh, kw) with the taps flipped, the
  inverse of ``torch_import.deconv_kernel`` in the JAX package:
  ``lax.conv_transpose`` (no kernel transpose) applies tap ``(k-1-a, k-1-b)``
  where ``ConvTranspose2d`` applies ``(a, b)``. That holds for every
  ``nn.ConvTranspose`` and for ``DeconvHead``'s ``deconv_kernel`` alike.
  Which 4-D ``kernel`` is a transposed conv is read from the target model:
  the paths of its ``ConvTranspose2d`` modules (:func:`transposed_convs`);
- an affine norm's ``scale`` and ``bias``, every bias, a PReLU's ``alpha``
  and the batch statistics keep their layout.

The BTS models flatten NCHW maps in JAX's (h, w, c) order
(``blocks.flatten_hwc``), so a dense layer after a flatten is a plain
transpose too.
"""

from __future__ import annotations

from typing import Any, Collection, Dict, FrozenSet, Mapping, Union

import numpy as np
import torch
from torch import nn

_SEP = "/"
_STATS = "batch_stats"

Target = Union[nn.Module, Collection[str]]


def transposed_convs(model: nn.Module) -> FrozenSet[str]:
    """The module paths of ``model``'s transposed convolutions."""
    return frozenset(name for name, m in model.named_modules()
                     if isinstance(m, nn.ConvTranspose2d))


def _transposed(target: Target) -> FrozenSet[str]:
    return transposed_convs(target) if isinstance(target, nn.Module) else frozenset(target)


def _flat(params) -> Dict[str, np.ndarray]:
    """``/``-joined paths: parameters without the ``params`` level, batch
    statistics under ``batch_stats/``."""
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
        flat[rest if head == "params" else path] = arr
    return flat


def _deconv(w: np.ndarray) -> np.ndarray:
    return w[::-1, ::-1].transpose(2, 3, 0, 1)


def _conv(w: np.ndarray) -> np.ndarray:
    return w.transpose(3, 2, 0, 1)


def params_from_jax(params, model: Target) -> Dict[str, torch.Tensor]:
    """JAX variables (nested or flat, with or without the ``params`` level;
    ``batch_stats`` where there are any) → the port's ``state_dict``
    (float32 CPU tensors). ``model`` is the target model, or the paths of
    its transposed convolutions (:func:`transposed_convs`)."""
    transposed = _transposed(model)
    state = {}
    for path, arr in _flat(params).items():
        *owner, leaf = path.split(_SEP)
        if owner and owner[0] == _STATS:
            owner = owner[1:]
        name = leaf
        if leaf == "kernel":
            name = "weight"
            if arr.ndim == 4:
                arr = _deconv(arr) if ".".join(owner) in transposed else _conv(arr)
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


def variables_to_jax(state_dict: Mapping[str, torch.Tensor], model: nn.Module) -> dict:
    """The port's ``state_dict`` of ``model`` → the JAX variables (nested,
    float32 numpy): ``{"params": …}``, plus ``"batch_stats"`` when the model
    has buffers. The inverse of :func:`params_from_jax`."""
    transposed = transposed_convs(model)
    buffers = {name for name, _ in model.named_buffers()}
    variables: dict = {"params": {}}
    for name, t in state_dict.items():
        *owner, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        if name in buffers:
            tree = variables.setdefault(_STATS, {})
        else:
            tree = variables["params"]
            if leaf == "weight":
                leaf = "kernel"
                if arr.ndim == 4:
                    arr = _undeconv(arr) if ".".join(owner) in transposed else _unconv(arr)
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
        node[leaf] = np.array(arr, np.float32, order="C")  # 0-d stays 0-d
    return variables


def params_to_jax(state_dict: Mapping[str, torch.Tensor], model: nn.Module) -> dict:
    """The JAX parameter tree (without the ``params`` level) of ``model``'s
    ``state_dict``; its buffers are left out (:func:`variables_to_jax`)."""
    return variables_to_jax(state_dict, model)["params"]


def flat_jax_weights(state_dict: Mapping[str, torch.Tensor],
                     model: nn.Module) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` of ``model`` as a JAX serving artifact's
    ``weights.npz`` holds it: ``/``-joined paths under ``params``
    (``params/backbone/encoder1/block1/conv/kernel``) and ``batch_stats``,
    JAX layouts (:func:`variables_to_jax`). :func:`params_from_jax` reads it
    back."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        for key in sorted(node):
            path = f"{prefix}{_SEP}{key}"
            if isinstance(node[key], Mapping):
                walk(path, node[key])
            else:
                flat[path] = node[key]

    for top, tree in variables_to_jax(state_dict, model).items():
        walk(top, tree)
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
    - UNet, AttentionUNet and ResidualUNet: ``width``, the first conv's
      channels (``down1/conv``, ``enc1/conv0``, ``in_block/conv1``);
      SegResNet and SwinUNETR (``patch_embed``) have fixed widths: none;
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
    if "patch_embed/kernel" in flat:
        return {}
    for first in ("encoder1/conv1", "down1/conv", "enc1/conv0", "in_block/conv1"):
        if f"{first}/kernel" in flat:
            return {"width": int(flat[f"{first}/kernel"].shape[-1])}
    if "final_conv_0_4/kernel" in flat:
        return {"deep_supervision": "final_conv_0_1/kernel" in flat}
    return {}
