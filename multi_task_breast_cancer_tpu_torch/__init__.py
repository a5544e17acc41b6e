"""PyTorch/CUDA port of ``multi_task_breast_cancer_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
nothing from it (nor ``jax``). It is ported slice by slice, serving and
training so far:

- :mod:`.models` — the nnU-Net family (``MTnnUNet``, ``nnUNet``) as NCHW
  ``nn.Module``s, plus the bridge that loads JAX weights;
- :mod:`.ops` — the hand-written CUDA kernels (built on first use from
  ``csrc/``: the fused norm's forward and backward in
  :mod:`.ops.hopper_kernels`, the 3-shear augmentation in
  :mod:`.ops.fast_augment`) with their plain PyTorch twins, and the losses
  and device metrics;
- :mod:`.train` — the epoch ``Engine``, optimizers, schedulers, train state;
- :mod:`.data` — the in-memory fold and the exact joint augmentation;
- :mod:`.parallel` — data parallelism over ``torch.distributed``: the data
  mesh (one rank per GPU), the ``(data × space)`` mesh of spatial
  partitioning and its collectives (:mod:`.parallel.spatial`), and
  multi-process start-up;
- :mod:`.serve` — serving artifacts (``serve export``: ``torch.export``
  programs) and the micro-batching HTTP server over a live model, a port
  artifact or a JAX serving artifact's weights.

Every path computes in float32 (TF32 off) or, with ``training.compute_dtype:
bfloat16``, in bf16 with f32 master weights, losses and metrics.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`.device.resolve_device`).
"""
