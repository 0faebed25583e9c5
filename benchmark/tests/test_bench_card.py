"""A cell's whole run on the card, shrunk in time: set-up, a short window,
the check. Needs a CUDA card (marker ``card``); skips without one,
deciding inside the test."""

import time

import pytest
import torch

from benchmark import harness, manifest


@pytest.mark.card
@pytest.mark.parametrize("cell", ["eggs_64.headless", "eggs_64.frames",
                                  "default_4k.frames"])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    man = manifest.load()
    r = harness.run_cell(man, manifest.workload(man, cell), 2 ** 31 + 3,
                         2.0, False, torch.device("cuda", 0),
                         time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) >= {"setup_s"}
