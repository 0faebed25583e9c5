"""The overlap stress (``BASELINE.json`` configs[2]: 8 default eggs forced
into one region) on the port's plain path, on the CPU, at full size: 8
upstream default eggs (white 60 px, 225 particles; yolk a fifth, 9) spawned
within 2 px of one point on the default handler (capacity 4096: the gather
engine, the ordered budget, a 4096-bucket table of 16 slots), settled.

- one ``solver.step`` of the settled pile against the JAX package's step on
  the same inputs within the whole-step tolerances of
  ``tests/test_torch_gather.py``, and against the benchmark's frozen plain
  path (``benchmark/reference``);
- in that state the yolk's candidate pairs exceed its ordered budget and
  the white's do not, and the same step with the budget off moves some yolk
  far past the position tolerance from JAX's, so the comparison sees the
  budget's cut;
- the budget's cut counter (``gather_kernel.cut_counter``, read through
  ``profiling.counters``) counts, pass by pass, what
  ``solver._ordered_budget`` says of the pass: a cut where some pair of the
  true 3x3 cells lies past ``max_pairs``; a spread-out scene under its
  budget counts every pass and no cut.

The targets are on a 1/64 px grid, exact in the JAX package's 16-bit
per-batch table gather.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu_torch as T
from benchmark.reference.model import Reference
from egg_fluid_simulation_tpu import config as jconfig
from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch import config as tconfig
from egg_fluid_simulation_tpu_torch.config import population_config
from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                    state_to_numpy)
from egg_fluid_simulation_tpu_torch.ops import solver as S
from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
from egg_fluid_simulation_tpu_torch.utils import profiling

SEED = 24
EGGS = 8
CENTRE = 92.0           # px: the white radius and a 32 px margin
JITTER = 2.0            # px
SETTLE = 60
POS_TOL = 1e-3          # px, pos and prev: the whole-step twins' tolerance
VEL_TOL = 0.2           # px/s
DT = 1 / 60


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    # pin the JAX dense step to its CPU plane path whatever interpret switch
    # an earlier test file set for the session
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel
    monkeypatch.setattr(sweep_kernel, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _specs(eggs: int = EGGS, spacing: float = 0.0, side: int = EGGS):
    """``eggs`` default eggs on a lattice of ``side`` columns ``spacing``
    px apart, each centre moved by up to ``JITTER`` px."""
    shift = np.random.default_rng(SEED).uniform(-JITTER, JITTER, (eggs, 2))
    b = np.arange(eggs)
    home = CENTRE + spacing * np.stack([b % side, b // side], axis=1)
    xy = np.round((home + shift) * 64.0) / 64.0
    return [dict(x=float(x), y=float(y), white_radius=60.0, yolk_radius=12.0,
                 white_n_particles=225, yolk_n_particles=9) for x, y in xy]


@pytest.fixture(scope="module")
def pile():
    specs = _specs()
    h = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                            device="cpu")
    h.add_many(specs)
    h.run_steps(SETTLE)
    return specs, h


def _port_step(d, options):
    cfg2 = tconfig.stack_device_configs(
        tconfig.device_config_from_dict(tconfig.default_white_config()),
        tconfig.device_config_from_dict(tconfig.default_yolk_config()))
    st, _, _ = S.step(state_from_numpy(d), cfg2, torch.tensor(DT),
                      torch.tensor(1.0), options,
                      wide_state=(S.wide_state_init(options),) * 2)
    return state_to_numpy(st)


def _jax_step(d, options):
    names = [f.name for f in dataclasses.fields(jsolver.SolverOptions)]
    oj = jsolver.SolverOptions(**{f: getattr(options, f) for f in names})
    cfg2 = jconfig.stack_device_configs(
        jconfig.device_config_from_dict(jconfig.default_white_config()),
        jconfig.device_config_from_dict(jconfig.default_yolk_config()))
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    sj, _, _ = jsolver.step(sj, cfg2, jnp.float32(DT), jnp.float32(1.0), oj,
                            wide_state=(jsolver.wide_state_init(oj),) * 2)
    jax.block_until_ready(sj.pos)
    return host_view(sj)


@pytest.fixture(scope="module")
def stepped(pile):
    """The settled pile's host view, and one step of it by JAX and by the
    port at the handler's options."""
    _, h = pile
    d = state_to_numpy(h.state)
    return d, _jax_step(d, h._options), _port_step(d, h._options)


def _gap(a, b, count) -> float:
    return max(float(np.abs(a[i, :int(count[i])]
                            - b[i, :int(count[i])]).max()) for i in range(2))


def _cell_size(cfg):
    return torch.clamp(cfg.max_radius * torch.maximum(
        cfg.collision_overlap_factor,
        cfg.cohesion_interaction_distance_factor), min=1.0)


def _budget(h, pop: int):
    """``(new_pairs, cum, max_pairs)`` of population ``pop``'s state as a
    pass would see it."""
    options = h._options
    cap = options.pop_caps[pop]
    cfg = population_config(h._device_cfg2(), pop)
    act = h.state.active_mask()[pop, :cap]
    grid, cand, valid = S._pair_candidates(h.state.pos[pop, :cap], act,
                                           _cell_size(cfg), options)
    return S._ordered_budget(grid, cand, valid, act)


def test_the_pile_runs_the_default_handler_options(pile):
    _, h = pile
    o = h._options
    assert (o.engine, o.budget_mode, o.table_size, o.slots_per_cell,
            o.pop_caps) == ("gather", "ordered", 4096, 16, (2048, 1024))
    assert [int(c) for c in h.state.count] == [EGGS * 225, EGGS * 9]


def test_one_step_against_jax(stepped):
    d, want, got = stepped
    count = d["count"]
    assert _gap(got["pos"], want["pos"], count) <= POS_TOL
    assert _gap(got["prev"], want["prev"], count) <= POS_TOL
    assert _gap(got["vel"], want["vel"], count) <= VEL_TOL
    assert _gap(got["pos"], d["pos"], count) > 1.0      # the step moved it


def test_one_step_against_the_frozen_reference(pile, stepped):
    specs, h = pile
    d, _, got = stepped
    cfg = dict(handler=dict(capacity=4096, max_batches=256, options="auto",
                            render_post_mode="coarse", jacobi_relaxation=1.0),
               white_config="default", yolk_config="default")
    dyn = {f: torch.from_numpy(d[f]) for f in ("pos", "prev", "vel",
                                                "last_pos")}
    want, _, _ = Reference(cfg, specs, "cpu").step(dyn, None, None, DT)
    count = d["count"]
    assert _gap(got["pos"], want.pos.numpy(), count) <= POS_TOL
    assert _gap(got["prev"], want.prev.numpy(), count) <= POS_TOL
    assert _gap(got["vel"], want.vel.numpy(), count) <= VEL_TOL


def test_the_yolk_is_past_its_budget_and_the_white_is_not(pile):
    _, h = pile
    new_pairs, _, max_pairs = _budget(h, 1)
    assert float(new_pairs.sum()) > float(max_pairs)
    new_pairs, _, max_pairs = _budget(h, 0)
    assert float(new_pairs.sum()) < float(max_pairs)


def test_the_budget_off_parts_from_jax(pile, stepped):
    """The budget's cut is part of the result: stepped with the budget
    off, some yolk lands more than ten position tolerances away from JAX's
    step, which cuts."""
    _, h = pile
    d, want, _ = stepped
    off = _port_step(d, dataclasses.replace(h._options, budget_mode="off"))
    n = int(d["count"][1])
    assert float(np.abs(off["pos"][1, :n] - want["pos"][1, :n]).max()) \
        > 10 * POS_TOL


def _counted_step(h, monkeypatch):
    """One step with each pass's cut worked out from ``_ordered_budget``
    on the pass's own input beside the counter's move in that pass:
    ``([(pop, want, [cut, passes] moved)], moved over the step)``."""
    solve = S.solve_pairs
    options = h._options
    seen = []

    def counted(pos, inv_mass, radius, batch_slot, active, cfg, *args,
                pop=None, **kw):
        grid, cand, valid = S._pair_candidates(pos, active, _cell_size(cfg),
                                               options)
        new_pairs, cum, max_pairs = S._ordered_budget(grid, cand, valid,
                                                      active)
        want = int(torch.any((new_pairs > 0) & (cum >= max_pairs)))
        row = GK.cut_counter(pos.device)[pop]
        before = row.clone()
        out = solve(pos, inv_mass, radius, batch_slot, active, cfg, *args,
                    pop=pop, **kw)
        seen.append((pop, want, (row - before)[:2].tolist()))
        return out

    monkeypatch.setattr(S, "solve_pairs", counted)
    c0 = profiling.counters()["budget_cuts"]
    _port_step(state_to_numpy(h.state), options)
    c1 = profiling.counters()["budget_cuts"]
    return seen, (c1 - c0).tolist()


def test_cut_counter_counts_the_ordered_budget_pass_by_pass(pile,
                                                            monkeypatch):
    _, h = pile
    seen, moved = _counted_step(h, monkeypatch)
    per_pass = h._options.n_substeps * h._options.n_collision_steps
    assert [p for p, _, _ in seen] == [0] * per_pass + [1] * per_pass
    for pop, want, got in seen:
        assert got == [want, 1]
    wants = [[sum(w for p, w, _ in seen if p == pop), per_pass]
             for pop in range(2)]
    assert moved == wants
    assert wants[1][0] > 0 and wants[0][0] == 0


def test_a_scene_under_its_budget_counts_every_pass_and_no_cut(monkeypatch):
    """The default handler's 16 spread-out eggs (a 4 x 4 lattice 2.25
    white radii apart) after their spawn: both populations under budget."""
    h = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                            device="cpu")
    h.add_many(_specs(16, 2.25 * 60.0, 4))
    seen, moved = _counted_step(h, monkeypatch)
    per_pass = h._options.n_substeps * h._options.n_collision_steps
    assert all(want == 0 and got == [0, 1] for _, want, got in seen)
    assert moved == [[0, per_pass], [0, per_pass]]


def test_cut_counts_is_a_copy_of_the_counter(pile):
    _, h = pile
    got = profiling.counters(h)["budget_cuts"]
    counter = GK.cut_counter(h.state.pos.device)
    assert got.shape == (2, 2) and got.dtype == torch.int32
    assert torch.equal(got, counter[:, :2])
    assert got.data_ptr() != counter.data_ptr()


def test_only_a_steps_budgeted_passes_count(pile):
    """``solve_pairs`` without ``pop`` (a direct call, as the smoke's and
    the twins' replays make) and a step with the budget off leave the
    counter as it was."""
    _, h = pile
    counter = GK.cut_counter(h.state.pos.device)
    before = counter.clone()
    options = h._options
    cfg = population_config(h._device_cfg2(), 1)
    cap = options.pop_caps[1]
    st = h.state
    S.solve_pairs(st.pos[1, :cap], st.inv_mass[1, :cap],
                  st.radius[1, :cap], st.batch_slot[1, :cap],
                  st.active_mask()[1, :cap], cfg, torch.tensor(0.0),
                  torch.tensor(0.0), torch.tensor(1.0), options)
    _port_step(state_to_numpy(h.state),
               dataclasses.replace(options, budget_mode="off"))
    assert torch.equal(counter, before)


@pytest.mark.parametrize("row,ok", [
    (torch.zeros(3, dtype=torch.int32), True),
    (torch.zeros(3, dtype=torch.int64), False),
    (torch.zeros(4, dtype=torch.int32), False),
    (torch.zeros((3, 2), dtype=torch.int32)[:, 0], False),
])
def test_the_kernel_wrappers_check_the_counter_row(row, ok):
    if ok:
        GK._check_cuts("gather_sweep", row, row.device)
    else:
        with pytest.raises(ValueError, match="cut counter row"):
            GK._check_cuts("gather_sweep", row, row.device)
