"""CPU tests of the benchmark harness (run with python -m pytest benchmark/tests -q)."""
