"""Fused collision pass of the PyTorch port against the TPU kernel.

The port's plain ``substep_pass`` (the CPU side of kernel B) is held to the
JAX package's ``_substep_pass_pallas`` run in interpret mode, on component
tensors binned from a seeded scene (``_bin_components``), window 1 here and
window 3 with the fresh-cell mask in ``test_torch_substep_wide.py``; G = 64
spans two of the TPU kernel's 32-row blocks, so it covers the wrap between
blocks and across the torus edge.

Tolerances, with their reasons:

- without ``integrate``: positions atol 1e-4 px. The pair math is the same
  op for op, but XLA's ``rsqrt`` and PyTorch's CPU ``rsqrt`` round
  differently (one ulp); positions stay below 512 px, where an ulp is
  3e-5 px.
- with ``integrate``: positions atol 1e-3 px, ``prev`` exact. XLA contracts
  ``x + damp * (x - prev)`` and the follow update into fused multiply-adds,
  so the integrated positions differ by an ulp, and the pair sum (hit tests
  near their thresholds) amplifies that; 1e-3 px is the bound
  ``tests/test_fused_path.py`` sets for the same class of difference.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as tsweep

# collision/cohesion compliance, overlap, cohesion factor, max_pairs,
# cell size, fresh modulus, occupancy cap — SweepParams.pack() at defaults
PARAMS = np.array([0.36, 28.8, 2.0, 2.0, 3.4e38, 8.0, 0.0, 8.0], np.float32)
# damp, follow compliance, relaxation, 0
AUX = np.array([0.9, 57.6, 1.0, 0.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def component_inputs(g: int, seed: int, n=None):
    """(xy, prev, stat, follow) of a random overlapping scene, binned by the
    port (bit-identical to the JAX binning, see test_torch_binning)."""
    n = n or (700 if g == 32 else 1500)
    rng = np.random.RandomState(seed)
    pos = rng.uniform(20.0, 180.0, size=(n, 2)).astype(np.float32)
    vel = rng.uniform(-40.0, 40.0, size=(n, 2)).astype(np.float32)
    inv = rng.uniform(0.55, 1.0, n).astype(np.float32)
    rad = np.full(n, 4.0, np.float32)
    batch = rng.randint(0, 3, n).astype(np.int32)
    act = np.ones(n, bool)
    act[-7:] = False
    tx = torch.full((n,), 100.0)
    ty = torch.full((n,), 100.0)
    td = torch.full((n,), float(np.float32(2.0 * np.sqrt(50.0))))
    t = [torch.from_numpy(a) for a in (pos, vel, inv, rad, batch, act)]
    xy, prev, stat, follow, _ = tsolver._bin_components(
        *t, torch.tensor(8.0), tx, ty, td, torch.tensor(1 / 120), g, 4)
    return xy, prev, stat, follow


def run_pair(g: int, window: int, integrate: bool, seed: int = 0):
    xy, prev, stat, follow = component_inputs(g, seed)
    fresh = window == 3
    j = jsweep._substep_pass_pallas(
        jnp.asarray(xy.numpy()), jnp.asarray(stat.numpy()),
        jnp.asarray(prev.numpy()), jnp.asarray(follow.numpy()),
        jnp.asarray(PARAMS), jnp.asarray(AUX), 4, True, window, fresh,
        integrate, True)
    j = jax.block_until_ready(j)
    t = tsweep.substep_pass(xy, stat, torch.from_numpy(PARAMS),
                            torch.from_numpy(AUX), 4, cohesion=True,
                            window=window, fresh_mask=fresh, prev=prev,
                            follow=follow, integrate=integrate)
    occupied = stat[3].numpy() > 0
    assert occupied.sum() > 500
    if integrate:
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]),
                                   rtol=0, atol=1e-3)
        np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
        moved = t[0].numpy()
    else:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4)
        moved = t.numpy()
    # the pass did real work: corrections moved occupied slots, empty stay 0
    assert np.abs(moved - xy.numpy())[:, occupied].max() > 0.1
    assert not moved[:, ~occupied].any()


@pytest.mark.parametrize("integrate", [True, False],
                         ids=["integrate", "plain"])
@pytest.mark.parametrize("g", [32, 64])
def test_substep_pass_window1_matches_pallas(g, integrate):
    run_pair(g, 1, integrate)


def test_device_flag_selects_the_window():
    """``wide`` (a 0-dim tensor, the violence gate) picks window 3 + fresh
    mask when true and window 1 when false, exactly as the explicit form."""
    xy, prev, stat, follow = component_inputs(32, 1)
    p, a = torch.from_numpy(PARAMS), torch.from_numpy(AUX)
    for wide in (False, True):
        explicit = tsweep.substep_pass(xy, stat, p, a, 4, cohesion=True,
                                       window=3 if wide else 1,
                                       fresh_mask=wide)
        flagged = tsweep.substep_pass(xy, stat, p, a, 4, cohesion=True,
                                      wide=torch.tensor(wide))
        assert torch.equal(explicit, flagged)
