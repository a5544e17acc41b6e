"""Kernels of the port, hand-written CUDA built on first use by :mod:`._build`
(:mod:`.hopper_kernels`, :mod:`.fast_augment`, :mod:`.layer_norm`,
:mod:`.instance_norm_affine`), flax's
normalisation arithmetic (:mod:`.flax_norm`), and the training losses and
device metrics."""
