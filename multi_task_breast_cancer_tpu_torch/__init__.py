"""PyTorch/CUDA port of ``multi_task_breast_cancer_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing from it (nor ``jax``). It is ported slice by slice, serving first:

- :mod:`.models` — the nnU-Net family (``MTnnUNet``, ``nnUNet``) as NCHW
  ``nn.Module``s, plus the bridge that loads JAX weights;
- :mod:`.ops.hopper_kernels` — the hand-written CUDA kernels (built on first
  use from ``csrc/``) with their plain PyTorch twins;
- :mod:`.serve` — the micro-batching HTTP server over a live model or a JAX
  serving artifact's weights.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`.device.resolve_device`).
"""
