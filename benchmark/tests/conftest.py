"""Tests of the benchmark harness.  Those marked ``cuda`` need the card and
skip here, decided inside the test."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (decided inside the test)")
    torch.set_num_threads(2)      # several workers share the host's cores


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures only on the card")
    return torch.device("cuda")
