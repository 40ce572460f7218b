"""The benchmark's own tests (CPU; card-only ones skip without CUDA):

    python -m pytest -q rtbench/tests

The port's scene cache stays off here, so no test writes under ``HOME``.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ["VKRT_TORCH_SCENE_CACHE"] = "off"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture(autouse=True)
def few_torch_threads():
    """Torch's CPU ops on two threads (the tests run beside other workers)."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
