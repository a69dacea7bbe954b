"""A whole run of each cell at a tiny size on the card: the port's CUDA
kernels against the reference. Skips where no card is present."""
from __future__ import annotations

import time

import pytest
import torch

from n2vbench import harness
from n2vbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", tiny.CELLS)
def test_tiny_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    out = harness.run(tiny.cell(name), 2 ** 31 + 3, 0.5, False,
                      torch.device("cuda", 0), time.perf_counter(),
                      log=lambda *_: None)
    assert out["correct"], out["checks"]
    assert out["memory_peak"] > 0
