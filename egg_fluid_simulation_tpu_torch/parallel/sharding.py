"""Particle-sharded SPMD step over a 1D mesh of ranks.

The counterpart of ``egg_fluid_simulation_tpu/parallel/sharding.py`` on
``torch.distributed`` (:mod:`.mesh`), riding on the gather engine:

- **Data parallel over particles**: each rank owns a contiguous slice of
  both populations' particle arrays; integration, the follow constraint and
  the velocity update are local.
- **Neighbour search**: each collision pass all-gathers the pair fields
  (position, inverse mass, radius, batch, liveness) of every particle, one
  collective a pass, builds the hash grid of the whole set and projects the
  constraints of its own slice only. Jacobi projection makes that exact:
  each endpoint's owner applies its own half of every pair.
- **Reductions** (centroid, AABB, max velocity, per-batch sums) finish
  with sums, maxes and mins over the mesh.

It trades bandwidth (an all-gather of every particle a pass) for no
rebalancing; the 2D decomposition (:mod:`.spatial`) moves boundary-sized
bytes instead.

The JAX package jits its ``shard_map`` body into one program a step; on a
card the step here (:func:`shard_body`) is captured once in a CUDA graph,
its all-gathers and all-reduces NCCL work inside it, and replayed
(:mod:`.sharding_graph`).
"""

from __future__ import annotations

import torch

from ..config import DeviceConfig, population_config
from ..ops import grid as grid_ops
from ..ops import solver as solver_ops
from ..ops.kernels import gather_kernel
from ..ops.solver import SolverOptions
from ..ops.step_graph import EAGER
from ..state import PARTICLE_FIELDS, ParticleState, StepStats
from ..utils.mathx import EPS
from .mesh import Mesh, make_mesh

__all__ = ["make_mesh", "shard_state", "sharded_step", "shard_body",
           "unshard_state", "global_stats"]

_BIG = 3.4e38


def shard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """This rank's contiguous slice of the particle arrays of a whole state
    (the same on every rank), on the mesh's device; the batch tables whole."""
    n_local = state.capacity // mesh.size
    if n_local * mesh.size != state.capacity:
        raise ValueError(f"capacity {state.capacity} does not divide over "
                         f"{mesh.size} ranks")
    lo = mesh.rank * n_local
    kw = {f: getattr(state, f)[:, lo:lo + n_local].to(mesh.device)
          for f in PARTICLE_FIELDS}
    kw.update({f: getattr(state, f).to(mesh.device) for f in
               ("count", "batch_target", "batch_radius", "batch_used")})
    return state.replace(**kw)


def unshard_state(state: ParticleState, mesh: Mesh) -> ParticleState:
    """The whole state on every rank: each rank's slice of the particle
    axis, concatenated in rank order (the JAX package's global array)."""
    if mesh.size == 1:
        return state
    return state.replace(**{
        f: mesh.all_gather(getattr(state, f).transpose(0, 1), "gather")
        .transpose(0, 1).contiguous() for f in PARTICLE_FIELDS})


def global_stats(pops, max_batches: int, mesh: Mesh) -> StepStats:
    """Step statistics over the whole mesh from each population's local
    ``(pos, last_pos, vel, radius, act, batch_slot)`` (``radius`` 0 where
    not ``act``): one sum and one max all-reduce, the minima riding the
    max negated."""
    sums, maxes = [], []
    for pos, last, vel, rad, act, bslot in pops:
        bsum, bcount = solver_ops.batch_segment_sums(pos, act, bslot,
                                                     max_batches)
        sums.append(torch.cat([
            torch.sum(act).to(torch.float32).reshape(1),
            torch.sum(torch.where(act[:, None], pos, 0.0), dim=0),
            torch.sum(torch.where(act[:, None], last, 0.0), dim=0),
            bsum.reshape(-1), bcount]))
        maxes.append(torch.cat([
            torch.max(torch.where(act, torch.sum(vel * vel, -1), 0.0)
                      ).reshape(1),
            torch.amax(torch.where(act[:, None], pos + rad[:, None], -_BIG),
                       dim=0),
            -torch.amin(torch.where(act[:, None], pos - rad[:, None], _BIG),
                        dim=0),
            torch.max(rad).reshape(1)]))
    s = mesh.psum(torch.stack(sums))
    m = mesh.pmax(torch.stack(maxes))
    b = max_batches
    n_act = torch.clamp(s[:, 0], min=1.0)
    return StepStats(
        aabb_min=-m[:, 3:5], aabb_max=m[:, 1:3],
        centroid=s[:, 1:3] / n_act[:, None],
        last_centroid=s[:, 3:5] / n_act[:, None],
        max_radius=torch.clamp(m[:, 5], min=1.0),
        max_velocity=torch.sqrt(m[:, 0]),
        batch_pos_sum=s[:, 5:5 + 2 * b].reshape(2, b, 2),
        batch_count=s[:, 5 + 2 * b:5 + 3 * b])


def _solve_pairs_sharded(pos, inv_mass, radius, batch_slot, active,
                         cfg: DeviceConfig, collision_c, cohesion_c,
                         relaxation, options: SolverOptions, mesh: Mesh):
    """One collision pass: all-gather the pair fields, project the local
    slice (the JAX package's ``_solve_pairs_sharded``: the math of
    ``solver.solve_pairs`` on a grid of every particle). The five fields
    ride one all-gather, the batch slot and liveness as floats (exact).
    The grid's front and the pass of the local slice (the owned range of
    the gathered particles) are kernel H (``gather_kernel``) on CUDA
    tensors and its plain version on CPU tensors."""
    n_local = pos.shape[0]
    pack = torch.stack([pos[:, 0], pos[:, 1], inv_mass, radius,
                        batch_slot.to(torch.float32),
                        active.to(torch.float32)], dim=1)
    g_pack = mesh.all_gather(pack, "all_gather")

    max_factor = torch.maximum(cfg.collision_overlap_factor,
                               cfg.cohesion_interaction_distance_factor)
    cell_size = torch.clamp(cfg.max_radius * max_factor, min=1.0)
    record, bucket = gather_kernel.gather_front(
        g_pack[:, 0:2], g_pack[:, 2], g_pack[:, 3],
        g_pack[:, 4].to(torch.int32), g_pack[:, 5] > 0.5, cell_size,
        options.table_size)
    table = grid_ops.slot_table(bucket, options.table_size,
                                options.slots_per_cell)
    grid = grid_ops.CellGrid(table=table,
                             cell_xy=gather_kernel.record_cells(record),
                             table_size=options.table_size)
    return gather_kernel.gather_sweep(
        record, grid, None, None, collision_c, cohesion_c,
        cfg.collision_overlap_factor, cfg.cohesion_interaction_distance_factor,
        relaxation, spacing=options.cohesion_mode == "spacing",
        owned=(mesh.rank * n_local, n_local), pair_chunk=options.pair_chunk)


def _substep_sharded(pos, prev, vel, inv_mass, radius, mass_t, batch_slot,
                     active, cfg, batch_target, follow_radius, sub_dt,
                     relaxation, options, mesh):
    follow_c = solver_ops.strength_to_compliance(cfg.follow_strength, sub_dt)
    collision_c = solver_ops.strength_to_compliance(cfg.collision_strength,
                                                    sub_dt)
    cohesion_c = solver_ops.strength_to_compliance(cfg.cohesion_strength,
                                                   sub_dt)
    pos, prev, vel, inv_mass, radius = solver_ops.pre_solve(
        pos, prev, vel, mass_t, active, cfg, sub_dt)
    pos = solver_ops.solve_follow(pos, inv_mass, batch_slot, active,
                                  batch_target, follow_radius, follow_c)
    for _ in range(options.n_collision_steps):
        pos = _solve_pairs_sharded(pos, inv_mass, radius, batch_slot, active,
                                   cfg, collision_c, cohesion_c, relaxation,
                                   options, mesh)
    vel = torch.where(active[:, None], (pos - prev) / sub_dt, 0.0)
    return pos, prev, vel, inv_mass, radius


def shard_body(mesh: Mesh, options: SolverOptions, state: ParticleState,
               cfg2: DeviceConfig, step_delta: torch.Tensor,
               relaxation: torch.Tensor):
    """One particle-sharded step of this rank's slice: ``(state, stats)``.
    ``step_delta`` and ``relaxation`` are 0-d float32 tensors on the state's
    device; the owned range and every shape are fixed by the mesh and the
    state. It never reads the device, so a CUDA graph can hold it
    (:mod:`.sharding_graph`)."""
    dev = state.device
    sub_dt = torch.clamp(step_delta / options.n_substeps, min=EPS)
    n_local = state.pos.shape[1]
    local_ids = mesh.rank * n_local + torch.arange(
        n_local, dtype=torch.int32, device=dev)
    active = local_ids[None, :] < state.count[:, None]
    last_pos = state.pos
    follow_radius = torch.sqrt(torch.clamp(state.batch_radius, min=0.0))

    outs, pops = [], []
    for i in range(2):
        cfg = population_config(cfg2, i)
        act = active[i]
        carry = (state.pos[i], state.prev[i], state.vel[i],
                 state.inv_mass[i], state.radius[i])
        for _ in range(options.n_substeps):
            carry = _substep_sharded(
                *carry, state.mass_t[i], state.batch_slot[i], act, cfg,
                state.batch_target, follow_radius[i], sub_dt, relaxation,
                options, mesh)
        outs.append(carry)
        pos, _, vel, _, radius = carry
        pops.append((pos, last_pos[i], vel, torch.where(act, radius, 0.0),
                     act, state.batch_slot[i]))
    stats = global_stats(pops, state.max_batches, mesh)
    pos, prev, vel, inv_mass, radius = (torch.stack(x) for x in zip(*outs))
    return state.replace(pos=pos, prev=prev, vel=vel, inv_mass=inv_mass,
                         radius=radius, last_pos=last_pos), stats


def _device_scalar(x, dev) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``dev``; a Python number is filled
    in on the device (no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def sharded_step(mesh: Mesh, options: SolverOptions, graphs=None):
    """The particle-sharded step: ``step(state, cfg2, step_delta,
    relaxation) -> (state, stats)`` on this rank's slice (see
    :func:`shard_state`), with the semantics of the single-device
    :func:`...ops.solver.step` on the gather engine with
    ``budget_mode="off"`` (the ordered 0.05 n^2 cutoff, inert above ~360
    live particles, would need a prefix scan across ranks).

    On a CUDA mesh the step replays a CUDA graph of :func:`shard_body`
    (:class:`.sharding_graph.ShardedGraphs`), as the JAX package jits its
    ``shard_map`` body; on a CPU mesh it runs eagerly. ``graphs``:
    ``ops.step_graph.EAGER`` runs eagerly on any device (the route a
    replay is compared with), a :class:`~.sharding_graph.ShardedGraphs`
    runs through that one (``capture=False``: its plumbing, eagerly)."""
    if options.budget_mode != "off":
        raise ValueError("sharded_step implements budget_mode='off'; the "
                         "ordered budget is inert at multi-device counts")
    from .sharding_graph import ShardedGraphs
    if graphs is None and mesh.device.type == "cuda":
        graphs = ShardedGraphs(mesh, options)
    eager = graphs is None or graphs is EAGER

    @torch.no_grad()
    def step(state: ParticleState, cfg2: DeviceConfig, step_delta,
             relaxation):
        scalars = (_device_scalar(step_delta, state.device),
                   _device_scalar(relaxation, state.device))
        if eager:
            return shard_body(mesh, options, state, cfg2, *scalars)
        return graphs.run(state, cfg2, *scalars)

    return step
