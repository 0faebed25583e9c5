"""The plane-resident variant of ``multi_step`` against the JAX package.

With ``sweep_symmetric=True`` (budget off) the port keeps the halo-padded
planes of ``bin_to_planes(rotate=True)`` resident across steps, as the JAX
package does on every device off the TPU; the sweeps are the symmetric
ones (kernel E's plain version in the port). Scenes, tolerances and the
pinning of the JAX path are those of ``tests/test_torch_resident.py``:
positions and previous positions atol 1e-3 px, velocities atol 0.2 px/s,
centroid / AABB atol 1e-3 px, in-grid sets equal.
"""

import numpy as np
import pytest
import torch

from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from test_torch_resident import assert_states_close, run_both, scene


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel
    monkeypatch.setattr(sweep_kernel, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("wide", [0, 240], ids=["wide_off", "wide_240"])
@pytest.mark.parametrize("kind", ["rebin", "calm"])
def test_plane_resident_multi_step_matches_jax(kind, wide):
    tsolver.rebins[:] = [0, 0]
    d = scene(kind)
    a, b, stats_j, stats_t, wj, wt = run_both(d, 6, sweep_symmetric=True,
                                              wide_budget_substeps=wide)
    assert_states_close(a, b, stats_j, stats_t)
    assert np.abs(b["pos"] - d["pos"]).max() > 1.0
    for pop in (0, 1):
        assert [int(x) for x in wt[pop]] == [int(x) for x in wj[pop]]
    if kind == "rebin":
        assert min(tsolver.rebins) > 0
    else:
        assert tsolver.rebins == [0, 0]
