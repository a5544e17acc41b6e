"""The port's model zoo (PyTorch, NCHW): the nnU-Net family in this slice
(:mod:`.registry` lists what is ported) and the JAX weight bridge
(:mod:`.jax_weights`)."""
