"""The 1D particle-sharded step of the PyTorch port (``parallel/sharding.py``)
against the JAX package's, on the CPU: JAX's ``sharded_step`` on 4 devices
of its CPU mesh in the test process, the port's on 4 gloo ranks
(``tests/torch_ranks.py``), both on the scene of ``tests/test_sharding.py``
(gather engine, literal cohesion, budget off).

Tolerances (``tests/test_sharding.py:51-74``): positions rtol 1e-5 / atol
1e-3 px, velocities rtol 1e-4 / atol 0.2 px/s, centroid and AABB rtol 1e-4
/ atol 0.1 px, batch counts 0.5; against JAX's sharded step and against the
port's single-device gather step. The JAX follow constraint gathers its
per-batch table as a bf16 hi/lo product (~16 bits of a target; the port
gathers exactly, as ``tests/test_torch_demo_checkpoint.py`` explains); it is
patched to an exact gather for this module's JAX steps. The per-pass
all-gather's bytes are counted: 6 floats a particle a pass. The same ranks
then run the dry run's checks (``parallel/dryrun.py``).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ranks
from egg_fluid_simulation_tpu import (SimulationHandler,
                                      SolverOptions as JOptions,
                                      default_white_config,
                                      default_yolk_config)
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.parallel import sharding as jsharding
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.config import (device_config_from_dict,
                                                   stack_device_configs)
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions

N_RANKS = 4
OPTS = dict(cohesion_mode="literal", table_size=4096, slots_per_cell=32,
            budget_mode="off")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _make_handler(capacity=1024):
    """The scene of tests/test_sharding.py."""
    h = SimulationHandler(default_white_config(), default_yolk_config(),
                          capacity=capacity, max_batches=8,
                          options=JOptions(cohesion_mode="literal"))
    a = h.add(0.0, 0.0, 20.0, 6.0, None, None, 40, 10)
    h.add(300.0, 100.0, 20.0, 6.0, None, None, 30, 8)
    h.set_target_position(a, 150.0, 50.0)
    h._flush_targets()
    return h


def _exact_rows(table, idx, chunk=1 << 16):
    return table[idx]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    h = _make_handler()
    inputs = {f"state_{k}": v for k, v in host_view(h.state).items()}
    inputs.update(white_config=json.dumps(h._white_config),
                  yolk_config=json.dumps(h._yolk_config))
    ranks = torch_ranks.start("sharding_program", inputs,
                              tmp_path_factory.mktemp("sharding"), N_RANKS)
    cfg2 = h._device_cfg2()
    dt, relax = jnp.float32(1 / 60), jnp.float32(1.0)
    saved = jsolver.take_batch_rows
    jsolver.take_batch_rows = _exact_rows
    try:
        mesh = jsharding.make_mesh(jax.devices()[:N_RANKS])
        step = jsharding.sharded_step(mesh, JOptions(**OPTS))
        new, stats = step(jsharding.shard_state(h.state, mesh), cfg2, dt,
                          relax)
        want = (host_view(new), jax.device_get(stats))
    finally:
        jsolver.take_batch_rows = saved
    # the port's single-device gather step on the same state
    tcfg2 = stack_device_configs(device_config_from_dict(h._white_config),
                                 device_config_from_dict(h._yolk_config))
    single, sstats = tsolver.step(state_from_numpy(host_view(h.state)),
                                  tcfg2, torch.tensor(1 / 60),
                                  torch.tensor(1.0), SolverOptions(**OPTS))
    return dict(h=h, jax=want, single=(host_view(single), sstats),
                port=ranks.result())


def _check(port, prefix, pos, vel, stats):
    np.testing.assert_allclose(port[f"{prefix}_pos"][0][:70], pos[0][:70],
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(port[f"{prefix}_vel"][0][:70], vel[0][:70],
                               rtol=1e-4, atol=0.2)
    np.testing.assert_allclose(port[f"{prefix}_centroid"],
                               np.asarray(stats.centroid), rtol=1e-4, atol=0.1)
    np.testing.assert_allclose(port[f"{prefix}_aabb_min"],
                               np.asarray(stats.aabb_min), rtol=1e-4, atol=0.1)
    np.testing.assert_allclose(port[f"{prefix}_batch_count"],
                               np.asarray(stats.batch_count), atol=0.5)


def test_sharded_step_matches_jax_sharded_step(run):
    want, stats = run["jax"]
    _check(run["port"], "step", want["pos"], want["vel"], stats)


def test_sharded_step_matches_single_device_step(run):
    want, stats = run["single"]
    _check(run["port"], "step", want["pos"], want["vel"], stats)


def test_sharded_step_runs_multiple_steps(run):
    port = run["port"]
    assert np.isfinite(port["steps5_pos"][:, :70]).all()
    # batch a is dragged toward (150, 50)
    c = (port["steps5_batch_pos_sum"][0, 0] + port["steps5_batch_pos_sum"][1, 0]
         ) / max(float(port["steps5_batch_count"][0, 0]
                       + port["steps5_batch_count"][1, 0]), 1.0)
    assert 0.0 < c[0] < 160.0


def test_sharded_step_all_gather_bytes(run):
    port, h = run["port"], run["h"]
    opts = SolverOptions(**OPTS)
    passes = 2 * opts.n_substeps * opts.n_collision_steps
    n_local = h.state.capacity // N_RANKS
    assert int(port["bytes_all_gather"]) == passes * n_local * 6 * 4
    assert int(port["bytes_total"]) == (int(port["bytes_all_gather"])
                                        + int(port["bytes_reductions"]))


def test_dryrun_passes_on_four_ranks(run):
    """``parallel/dryrun.py``'s checks (sharded and spatial steps against
    one device, resident steps, render, SpatialHandler) ran in the rank
    set without raising."""
    assert int(run["port"]["dryrun_passed"]) == 1
