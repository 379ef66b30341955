"""The benchmark's own tests: on the CPU, at small sizes. Run from the root
of the checkout with ``python -m pytest benchmark/tests``. Tests marked
``chip`` need a CUDA card and skip without one."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark's cells run on the chip only")
    return torch.device("cuda", 0)
