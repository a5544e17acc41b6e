"""The port's experiment driver against the JAX driver in CV_PROD mode, for
MTnnUNet: ``tests/test_torch_driver.py``'s comparison, in a file of its own
so that the suite's two slowest cases run on two workers."""

from __future__ import annotations

import pytest

from test_torch_driver import (  # noqa: F401  (fixtures)
    check_driver_matches_jax_driver,
    one_torch_thread,
    tree,
)


@pytest.mark.parametrize("task,mode,arch", [("multitask", "CV_PROD", "MTnnUNet")])
def test_driver_matches_jax_driver(tmp_path, monkeypatch, tree, task, mode, arch):  # noqa: F811
    check_driver_matches_jax_driver(tmp_path, monkeypatch, tree, task, mode, arch)
