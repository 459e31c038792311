"""CPU tests of the benchmark.  Tests that need the card carry the
``cuda`` marker and decide inside the ``card`` fixture."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
