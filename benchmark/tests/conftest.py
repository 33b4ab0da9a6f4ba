"""Shared fixtures of the benchmark's own tests.  They run on the CPU
at tiny sizes; tests marked `card` run on an NVIDIA card only and skip
elsewhere (the check happens in the `card` fixture, never at import)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny(tmp_path):
    from benchmark.tests.tiny import tiny_bench
    return tiny_bench(tmp_path)
