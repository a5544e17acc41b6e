"""Serving on the GPU with the PyTorch port.

- :mod:`.server` — the micro-batching HTTP server and its backends
  (a live model from a config, or a JAX serving artifact's weights);
- :mod:`.post` — output postprocessing (class probabilities, the
  pipeline-refinement rule, masks);
- ``python -m multi_task_breast_cancer_tpu_torch.serve run`` — the CLI.
"""
