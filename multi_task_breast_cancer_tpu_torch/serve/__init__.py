"""Serving on the GPU with the PyTorch port.

- :mod:`.server` — the micro-batching HTTP server and its backends
  (a live model from a config, a port artifact's exported programs, or a
  JAX serving artifact's weights);
- :mod:`.export` — serving artifacts: ``torch.export`` programs per batch
  bucket and platform, the weights apart in the JAX layout;
- :mod:`.post` — output postprocessing (class probabilities, the
  pipeline-refinement rule, masks);
- ``python -m multi_task_breast_cancer_tpu_torch.serve export|run`` — the CLI.
"""
