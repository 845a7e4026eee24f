"""Tests of the benchmark (`python -m pytest gpubench/tests -q` from the
repository's root). They run on the CPU at small sizes; a test marked
`cuda` needs a CUDA device and skips without one (decided in the `card`
fixture, never at import). Nothing here imports JAX."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"


# sizes at which a CPU test holds a whole run: the configuration's and the
# traffic's structure, with fewer genes, isoforms and pairs
SMALL = {"genes": 60, "isoforms": 200, "pairs_per_sample": 20000,
         "samples": 2}


@pytest.fixture
def small():
    return dict(SMALL)
