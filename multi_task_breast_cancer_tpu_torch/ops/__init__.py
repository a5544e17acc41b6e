"""Kernels of the port: hand-written CUDA (:mod:`.hopper_kernels`) built on
first use by :mod:`._build`."""
