"""Kernels of the port, hand-written CUDA built on first use by :mod:`._build`
(:mod:`.hopper_kernels`, :mod:`.fast_augment`), and the training losses and
device metrics."""
