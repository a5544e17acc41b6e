"""The benchmark of the PyTorch/CUDA port (see BENCHMARK.json and PERF.md)."""
