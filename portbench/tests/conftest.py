"""The benchmark's own tests: the repo root and src/ on the path, and the
test-sized specification under tests/data/."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny_spec():
    from portbench.harness.spec import Spec

    return Spec(DATA / "BENCHMARK.json", first=[DATA])


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
