"""Small scenes of the dense engine step-locked to the JAX package on the
CPU, with the rule of ``test_torch_dense_twins.py`` (``lockstep.
explain_dense``, the JAX step traced as it runs), on the 660-particle
lattice of ``tests/test_torch_step.py`` at G = 64:

- packed to half its spacing, 8 updates: a spawn in which the gate trips
  on both sides (the episode budgets fall);
- at its own spacing, 2 updates from a carried episode state two
  substeps short of its rearm, with and without the trip set: the calm
  count, the budget's refill and the window carried across updates.

The resident loop on this lattice is in
``test_torch_dense_resident_twins.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver

import torch_twins as TW
from torch_twins import jax_trace  # noqa: F401  (the fixture)
from test_torch_dense_twins import gate_ran, print_findings
from test_torch_step import lattice_state

LATTICE = dict(engine="dense", budget_mode="off", dense_rebin="step",
               dense_grid_dim=64, dense_slots=4)


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


def lattice_pair(d, options):
    """A JAX and a port handler holding the host state ``d``."""
    hj, ht = TW.pair(capacity=d["pos"].shape[1], max_batches=4,
                     options=options)
    hj._state = jstate.ParticleState(**{k: jnp.asarray(v)
                                        for k, v in d.items()})
    ht._state = state_from_numpy(d)
    for h in (hj, ht):
        h._counts = [int(c) for c in d["count"]]
    return hj, ht


def packed_lattice():
    """The lattice of ``tests/test_torch_step.py`` at half its spacing:
    neighbours overlap by half a diameter, so it spawns apart."""
    d = lattice_state()
    for pop in (0, 1):
        n = int(d["count"][pop])
        c = d["pos"][pop, :n].mean(0)
        p = (c + 0.5 * (d["pos"][pop, :n] - c)).astype(np.float32)
        for f in ("pos", "prev", "last_pos"):
            d[f][pop, :n] = p
    return d


def test_lattice_spawn_step_locked_gate_trips(jax_trace):
    hj, ht = lattice_pair(packed_lattice(), LATTICE)
    rep = TW.step_locked(hj, ht, 8, trace=jax_trace)
    print_findings("lattice spawn", rep)
    assert rep.steps == 8 and gate_ran(rep)


@pytest.mark.parametrize("carried", [(False, 100, 10), (True, 100, 10)],
                         ids=["calm_to_rearm", "tripped_then_calm"])
def test_gate_carry_across_updates_as_jax(carried, jax_trace):
    """The wide gate's episode state carried into the lattice at its own
    spacing, where the yolks are calm: 10 calm substeps of the 12 that end
    an episode, with the budget down to 100, and that state with the trip
    set (the yolks' first substep runs window 3). Both handlers take it
    from the JAX one; the yolks' rearm comes at the end of the first
    update and refills their budget, and the calm count runs on into the
    second: the episode states are equal after every update."""
    hj, ht = lattice_pair(lattice_state(), LATTICE)
    hj._wide_state = tuple(
        (jnp.bool_(carried[0]), jnp.int32(carried[1]), jnp.int32(carried[2]))
        for _ in range(2))
    rep = TW.step_locked(hj, ht, 2, trace=jax_trace)
    assert rep.steps == 2 and not rep.flips
    assert rep.windows[0][1] == [carried[0], False]
    assert [w[1] for w in rep.wide] == [(False, 240, 12), (False, 240, 14)]
