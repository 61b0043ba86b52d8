"""pytest settings of the benchmark's own tests (`python -m pytest
benchmark/`): the `cuda` marker of tests that need the card, and the
fixture that decides, inside the test, whether there is one."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"
