"""The harness's own tests: `python -m pytest port_bench/tests` from the
root of the repository.  Tests marked `cuda` need the card and skip
without one; the check for a card is made in the `card` fixture."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
