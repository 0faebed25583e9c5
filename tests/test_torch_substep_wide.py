"""Wide (window 3 + fresh-cell mask) collision pass of the PyTorch port
against the TPU kernel in interpret mode; see test_torch_substep.py for the
inputs and the tolerances (the same reasons hold)."""

import pytest
import torch

from test_torch_substep import run_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("integrate", [True, False],
                         ids=["integrate", "plain"])
@pytest.mark.parametrize("g", [32, 64])
def test_substep_pass_window3_matches_pallas(g, integrate):
    run_pair(g, 3, integrate)
