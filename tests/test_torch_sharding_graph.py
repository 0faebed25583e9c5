"""The 1D particle-sharded step's graph (``parallel/sharding_graph.py``) on
the CPU, where ``ShardedGraphs(capture=False)`` runs its plumbing eagerly on
the static buffers a card replays from: one gloo rank and four
(``tests/torch_ranks.py`` ``sharding_graph_program``), the scene of
``tests/test_sharding.py`` (gather engine, literal cohesion, budget off),
``N_STEPS`` chained steps.

- Against the eager ``sharded_step`` (``step_graph.EAGER``), bit for bit:
  every state field and stat of each step, and the collective bytes of each
  step per category (on four ranks 6 floats a particle a pass under
  ``all_gather``, the statistics' sum and max under ``reductions``; none on
  one rank). The default route of a CPU mesh is the eager one, bit for bit.
- The state a step handed out is not overwritten by later steps, and
  Python-number scalars give the tensors' step.
- Against the JAX package's ``sharded_step`` on 4 devices of its CPU mesh,
  each step, at ``tests/test_sharding.py``'s tolerances: positions rtol
  1e-5 / atol 1e-3 px, velocities rtol 1e-4 / atol 0.2 px/s, centroid and
  AABB rtol 1e-4 / atol 0.1 px, batch counts 0.5. JAX's follow constraint
  gathers its per-batch table as a bf16 hi/lo product; it is patched to an
  exact gather for this module's JAX steps, as in
  ``tests/test_torch_sharding.py``.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from egg_fluid_simulation_tpu import SolverOptions as JOptions
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.parallel import sharding as jsharding
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
from egg_fluid_simulation_tpu_torch.parallel.sharding_graph import \
    sharded_key
from test_torch_sharding import OPTS, _exact_rows, _make_handler

RANKS = (1, 4)
N_STEPS = 3
ROUTES = ("eager", "graphs", "default")
FIELDS = ("pos", "prev", "vel", "last_pos", "radius", "mass_t", "inv_mass",
          "batch_slot", "color", "count", "batch_target", "batch_radius",
          "batch_used")
STATS = ("aabb_min", "aabb_max", "centroid", "last_centroid", "max_radius",
         "max_velocity", "batch_pos_sum", "batch_count")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank sets started first; JAX's ``N_STEPS`` steps on its
    4-device mesh meanwhile."""
    h = _make_handler()
    inputs = {f"state_{k}": v for k, v in host_view(h.state).items()}
    inputs.update(white_config=json.dumps(h._white_config),
                  yolk_config=json.dumps(h._yolk_config),
                  options=json.dumps(OPTS), n_steps=N_STEPS)
    ranks = {n: torch_ranks.start("sharding_graph_program", inputs,
                                  tmp_path_factory.mktemp(f"graph{n}"), n)
             for n in RANKS}
    saved = jsolver.take_batch_rows
    jsolver.take_batch_rows = _exact_rows
    try:
        mesh = jsharding.make_mesh(jax.devices()[:4])
        step = jsharding.sharded_step(mesh, JOptions(**OPTS))
        st = jsharding.shard_state(h.state, mesh)
        want = []
        for _ in range(N_STEPS):
            st, stats = step(st, h._device_cfg2(), jnp.float32(1 / 60),
                             jnp.float32(1.0))
            want.append((host_view(st), jax.device_get(stats)))
    finally:
        jsolver.take_batch_rows = saved
    return dict(h=h, jax=want, port={n: r.result() for n, r in ranks.items()})


@pytest.mark.parametrize("n_ranks", RANKS)
@pytest.mark.parametrize("route", ("graphs", "default"))
def test_route_matches_eager_bit_for_bit(runs, n_ranks, route):
    port = runs["port"][n_ranks]
    for k in range(N_STEPS):
        for name in FIELDS + STATS:
            np.testing.assert_array_equal(port[f"{route}_{k}_{name}"],
                                          port[f"eager_{k}_{name}"],
                                          err_msg=f"step {k}: {name}")


@pytest.mark.parametrize("n_ranks", RANKS)
def test_graph_bytes_match_eager(runs, n_ranks):
    port = runs["port"][n_ranks]
    opts = SolverOptions(**OPTS)
    passes = 2 * opts.n_substeps * opts.n_collision_steps
    n_local = runs["h"].state.capacity // n_ranks
    b = runs["h"].state.max_batches
    for k in range(N_STEPS):
        counted = {r: json.loads(str(port[f"{r}_{k}_bytes"])) for r in ROUTES}
        assert counted["graphs"] == counted["eager"] == counted["default"]
        if n_ranks == 1:
            assert counted["eager"] == {"total": 0}
        else:
            # the pair fields of every particle a pass; the stats' (2, 5 +
            # 3 B) sums and (2, 6) maxes
            assert counted["eager"] == {
                "all_gather": passes * n_local * 6 * 4,
                "reductions": (2 * (5 + 3 * b) + 2 * 6) * 4,
                "total": passes * n_local * 24 + (2 * (5 + 3 * b) + 12) * 4}


@pytest.mark.parametrize("n_ranks", RANKS)
def test_handed_out_state_is_not_overwritten(runs, n_ranks):
    port = runs["port"][n_ranks]
    assert int(port["graphs_captures"]) == 1
    for name in FIELDS:
        np.testing.assert_array_equal(port[f"graphs_first_after_{name}"],
                                      port[f"graphs_0_{name}"])


@pytest.mark.parametrize("n_ranks", RANKS)
def test_python_number_scalars(runs, n_ranks):
    port = runs["port"][n_ranks]
    for name in FIELDS + STATS:
        np.testing.assert_array_equal(port[f"graphs_floats_{name}"],
                                      port[f"graphs_0_{name}"])


@pytest.mark.parametrize("n_ranks", RANKS)
def test_graph_steps_match_jax_sharded_step(runs, n_ranks):
    port = runs["port"][n_ranks]
    for k, (want, stats) in enumerate(runs["jax"]):
        p = f"graphs_{k}"
        np.testing.assert_allclose(port[f"{p}_pos"][0][:70],
                                   want["pos"][0][:70], rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(port[f"{p}_vel"][0][:70],
                                   want["vel"][0][:70], rtol=1e-4, atol=0.2)
        for name in ("centroid", "aabb_min", "aabb_max"):
            np.testing.assert_allclose(port[f"{p}_{name}"],
                                       np.asarray(getattr(stats, name)),
                                       rtol=1e-4, atol=0.1)
        np.testing.assert_allclose(port[f"{p}_batch_count"],
                                   np.asarray(stats.batch_count), atol=0.5)


def test_sharded_key_fixes_the_owned_range_and_shapes():
    from egg_fluid_simulation_tpu_torch.state import zeros_state
    opts = SolverOptions(**OPTS)
    state = zeros_state(256, 8, "cpu")
    mesh = types.SimpleNamespace(size=4, rank=1)
    key = sharded_key(mesh, opts, state)
    assert key == (opts, 256, 8, 4, 1, "cpu")
    assert sharded_key(types.SimpleNamespace(size=4, rank=2), opts,
                       state) != key
    assert sharded_key(mesh, opts, zeros_state(128, 8, "cpu")) != key
    assert sharded_key(mesh, opts, zeros_state(256, 4, "cpu")) != key
    assert sharded_key(mesh, SolverOptions(**{**OPTS, "table_size": 2048}),
                       state) != key
