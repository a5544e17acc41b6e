"""Fixtures of the benchmark's tests: the folder cut to CPU size, once."""

import pytest
import torch

from benchmark.tests import tiny


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def few_threads():
    """The tests run small models; few threads keep a parallel run of the
    suite from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
