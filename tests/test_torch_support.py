"""Shared support of the tests/test_torch_*.py modules (it holds no test).

A module that works torch hard on the CPU imports `one_torch_thread`; the
import registers the fixture for that module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while the importing module runs: the workers of a
    parallel test run share the cores, and torch's thread pools then spin on
    each other for many times the work's own time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
