"""The harness on the card, at a size a test holds: each smoke cell, traced
(the device trace read, the comparison made on the card).  Marked ``gpu``;
whether a card is there is decided in the fixture.

    PYTHONPATH=src python -m pytest -q -m gpu portbench/tests
"""
import pytest

from portbench.run import run_cell
from portbench.tests.smoke import smoke_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("kind", ["dense", "moe", "poisson"])
def test_smoke_cell_traced_on_the_card(cuda, kind):
    res = run_cell(smoke_cell(kind), 2**31 + 9, 1.0, True, cuda,
                   t_start=0.0)
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]
    assert res["metrics"], res
    assert res["checks"]["missing"]["value"] == 0
