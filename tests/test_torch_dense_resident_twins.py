"""The dense engine's resident loop (``run_steps`` on the resident route,
the wide sweep statically off, as the bench's headline scene runs)
step-locked to the JAX package on the CPU, on the 660-particle lattice of
``tests/test_torch_step.py`` at G = 64 with velocities of up to 120 px/s:
2 calls of ``run_steps(4)``, each from the JAX state
(``torch_twins.resident_locked``). The port's ``multi_step`` runs again
with its recorders and must reproduce the port's call bit for bit; each
resident step's rebin must equal the JAX loop's as it ran (traced,
``torch_twins.JaxTrace``); the host fields bit for bit, pos / prev / vel
within 1e-3 px / 0.2 px/s and the episode states equal after each call.
"""

import numpy as np
import pytest
import torch

import torch_twins as TW
from torch_twins import jax_trace  # noqa: F401  (the fixture)
from test_torch_dense_lattice_twins import LATTICE, lattice_pair
from test_torch_dense_twins import print_findings
from test_torch_step import lattice_state
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    TW.pin_plane_path(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _zero_counters():
    tsolver.rebins[:] = [0, 0]
    tsolver.host_syncs = 0


def resident_scene():
    """The lattice with uniform velocities of up to 120 px/s and the
    follow pull off: neighbours drift past a quarter cell within a few
    steps, so the resident loop rebins."""
    d = lattice_state()
    d["batch_radius"][:, :2] = 65536.0
    rng = np.random.RandomState(1)
    for pop in (0, 1):
        n = int(d["count"][pop])
        d["vel"][pop, :n] = rng.uniform(-120.0, 120.0, (n, 2))
    return d


def test_resident_run_steps_rebins_match_jax(jax_trace):
    hj, ht = lattice_pair(resident_scene(),
                          dict(LATTICE, wide_budget_substeps=0))
    rep = TW.resident_locked(hj, ht, 2, 4, jax_trace)
    print_findings("resident", rep)
    print("resident rebins per call:", rep.rebins)
    assert rep.steps == 2 and sum(map(sum, rep.rebins)) > 0
    assert rep.pos_err <= TW.POS_TOL and rep.vel_err <= TW.VEL_TOL
