"""The main path, the dense engine's step, step-locked to the JAX package on
the CPU (``torch_twins.step_locked``).

Every update starts both handlers from the JAX state; the port's result is
held to the JAX handler's: the host-decided fields bit for bit, pos / prev
1e-3 px, vel 0.2 px/s, the wide gate's episode state ``(trip, budget,
calm)`` equal. A step past them passes only where the dense rule of
``egg_fluid_simulation_tpu_torch.utils.lockstep`` (``explain_dense``)
explains it from each side's step substep by substep: the JAX step as it
ran, traced through the module attributes it calls (``torch_twins.
JaxTrace``: ``_plane_run`` and ``_plane_drift_over`` on the JAX package's
CPU plane path), and the port's step run again by its own code with a
recorder (``lockstep.DensePortSide``: ``_Population.substeps``, the fused
path it runs), each held to the step that ran. The rule: equal slot
vectors and fallback sets, and at each substep that parts, the port's
substep on the JAX input agreeing at every slot within the pass tolerance
plus twice that slot's own 1-ulp rounding envelope; a window the gate
chose differently must come from a count whose differing slots lie within
a few float32 steps of the threshold. Anything else raises
``lockstep.Departure``.

Here ``dense_16k`` (``scenarios.DENSE_SCENES``): the JAX handler's own
automatic dense configuration at capacity 16384, 3 updates through the
spawn transient (the gate trips every substep). The slow tier runs it for
its 20 updates, and one update against the JAX package's fused path in
interpret mode (``FORCE_INTERPRET``, traced through ``_fused_run`` and
``_comp_drift_over``). The fused binning of both packages
(``_bin_components``, the occupancy-pressure boost's clamp included) is
held bit for bit on the same state. The small scenes (a packed lattice
spawn, the gate's carry across updates) are in
``test_torch_dense_lattice_twins.py``, the resident loop in
``test_torch_dense_resident_twins.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from egg_fluid_simulation_tpu_torch import scenarios
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.utils import lockstep

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
import torch_twins as TW
from torch_twins import jax_trace  # noqa: F401  (the fixture)


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


def dense_16k():
    sc = scenarios.DENSE_SCENES["dense_16k"]
    hj, ids = scenarios.build(sc, J)
    ht, ids_t = scenarios.build(sc, T, device="cpu")
    assert ids_t == ids
    o = ht._options
    assert (o.engine, o.dense_grid_dim, o.dense_slots, o.budget_mode,
            o.wide_budget_substeps, o.dense_rebin) == \
        ("dense", (128, 64), (4, 4), "off", 240, "step")
    return hj, ht


def print_findings(name, rep):
    for line in TW.flip_lines(rep):
        print(f"{name}: {line}")


def gate_ran(rep) -> bool:
    """The wide sweep ran on both populations (their episode budgets
    fell)."""
    return all(w[pop][1] < 240 for w in rep.wide[-1:] for pop in (0, 1))


def test_dense_16k_step_locked_to_jax(jax_trace):
    hj, ht = dense_16k()
    rep = TW.step_locked(hj, ht, 3, trace=jax_trace)
    print_findings("dense_16k", rep)
    assert rep.steps == 3 and gate_ran(rep)
    assert all(isinstance(f, (lockstep.Amplified, lockstep.DenseFlip))
               for _, f in rep.flips)


@pytest.mark.parametrize("occ_cap", [8.0, 1.25])
def test_fused_binning_and_boost_clamp_as_jax(occ_cap):
    """The fused layout both packages bin from one state after the spawn's
    first update (``_bin_components``: slots, positions, the step-static
    fields, the occupancy-pressure boost ``clip(count / K, 1, cap)``, the
    follow targets) agree bit for bit, the previous positions (``pos -
    sub_dt * vel``, which XLA may contract) within one float32 step and
    the dead zone within the JAX table's 16 bits; at a cap of 1.25 the
    clamp binds in the packed cells."""
    hj, ht = dense_16k()
    hj.update(1 / 60)
    for h in (hj, ht):
        h._options = dataclasses.replace(h._options, occ_pressure_cap=occ_cap)
    js = TW.JaxDenseSide(hj)
    js.fused = True
    ps = lockstep.DensePortSide(ht._device_cfg2(), ht._options, "cpu")
    before = TW.host_view(hj.state)
    for pop in (0, 1):
        (_, gj), sj = js.bin(pop, before)
        (P, gp), sp = ps.bin(pop, before)
        assert P.fused
        np.testing.assert_array_equal(sp, sj)
        for name, a, b in zip(("xy", "stat", "targets"),
                              (gj[0], gj[2], gj[3][:2]),
                              (gp[0], gp[2], gp[3][:2])):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
        # the dead zone 2 sqrt(batch_radius): JAX gathers the per-batch
        # table through a bf16 hi/lo product (~16 significant bits), the
        # port exactly (ROADMAP, deliberate)
        np.testing.assert_allclose(gp[3][2].numpy(), np.asarray(gj[3][2]),
                                   rtol=2.0 ** -16, atol=0)
        steps = lockstep.float_steps(gp[1].numpy(), np.asarray(gj[1]))
        assert steps.max() <= 1
        boost = gp[2][3].numpy()
        assert 1.0 < boost.max() <= occ_cap       # cells over K
        if occ_cap < 2.0:
            assert boost.max() == occ_cap          # the clamp binds


@pytest.mark.slow
def test_dense_16k_twenty_updates_step_locked(jax_trace):
    hj, ht = dense_16k()
    sc = scenarios.DENSE_SCENES["dense_16k"]
    rep = TW.step_locked(hj, ht, sc.steps, trace=jax_trace)
    print_findings("dense_16k", rep)
    assert rep.steps == sc.steps and gate_ran(rep)


@pytest.mark.slow
def test_dense_16k_against_jax_fused_path(monkeypatch, request, jax_trace):
    """One update against the JAX package's fused path (``_fused_run``,
    kernel B's counterpart, interpreted on the CPU): the port's fused
    path meets its true counterpart at the automatic configuration."""
    from egg_fluid_simulation_tpu.ops import solver as jsolver
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", True)
    jax.clear_caches()      # the step traces again, on the fused path
    request.addfinalizer(jax.clear_caches)
    hj, ht = dense_16k()
    assert jsolver._fused_component_path(hj._options)
    assert TW.JaxDenseSide(hj).fused
    rep = TW.step_locked(hj, ht, 1, trace=jax_trace)
    print_findings("dense_16k fused", rep)
    assert rep.steps == 1
