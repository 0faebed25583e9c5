"""Multi-device dry run: the sharded layers on N ranks against one device.

    python -m egg_fluid_simulation_tpu_torch.parallel.dryrun --device cpu [--ranks 4]

The counterpart of ``egg_fluid_simulation_tpu/parallel/dryrun.py``. It
starts ``--ranks`` processes of one process group (a file store in a
temporary directory; gloo ranks with ``--device cpu``, NCCL and one card a
rank with ``--device cuda``) and checks on them: the 1D particle-sharded
step against the single-device step of the same state (positions rtol 1e-5
/ atol 1e-4 px); the same state through the sharded step's CUDA graph
(``parallel/sharding_graph.py``; on the CPU its plumbing run eagerly)
against the eager route over ``GRAPH_STEPS`` steps, bit for bit
(``batch_pos_sum`` within ``STATS_RTOL``: ``index_add_``'s atomics) with
equal collective bytes a step; with ``--device cuda`` both routes timed at
``N_TIMED`` particles in all (:func:`time_sharded`); the 2D spatial step (halo exchange, migration) against the
single-device dense step (centroids rtol 1e-4 / atol 1e-3 px), three
resident spatial steps without a migration drop, the sharded render, and
the SpatialHandler product flow, which on a card replays its steps and
draws from CUDA graphs (``parallel/spatial_graph.py``), held bit for bit
against the same flow on the eager route (frame within 1e-6). ``--device`` is required: on a machine
with one card, more than one rank works only as gloo ranks on the CPU, and
the script does not choose that for the caller.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

MESHES = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}
GRAPH_STEPS = 3         # chained sharded steps, replayed against eager
STATS_RTOL = 1e-5       # batch_pos_sum, replayed vs eager (atomic sums)
N_TIMED = 65_536        # particles in all of the timed sharded scene: 16,384
                        # a rank on four, the gather engine's top a card
TIMED_STEPS = 10        # chained steps a timed block
TIMED_BLOCKS = 5        # timed blocks of each route, in turns, a capture
CAPTURES = 2            # captures timed (replays are bimodal across them)
H_SYMBOLS = {"gather_front": "gather_front_kernel",
             "gather_sweep": "gather_sweep_kernel",
             "gather_count": "gather_count_kernel"}


def _tiny_handler(capacity: int, device, engine: str = "gather"):
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                SolverOptions,
                                                default_white_config,
                                                default_yolk_config)
    h = SimulationHandler(
        default_white_config(), default_yolk_config(), capacity=capacity,
        max_batches=8, device=device,
        options=SolverOptions(engine=engine, table_size=2048,
                              slots_per_cell=16, dense_grid_dim=64,
                              dense_slots=4,
                              budget_mode="off" if engine == "dense"
                              else "ordered"))
    a = h.add(0.0, 0.0, 20.0, 6.0, None, None, 40, 10)
    h.add(120.0, 40.0, 20.0, 6.0, None, None, 30, 8)
    h.set_target_position(a, 80.0, 30.0)
    h._flush_targets()
    return h


def chain(step, state, cfg2, dt, relax, n: int, mesh):
    """``n`` chained calls of a sharded ``step`` from ``state``: each
    step's ``(state, stats, collective bytes per category)``."""
    from .accounting import measured_collective_bytes
    out = []
    for _ in range(n):
        (state, stats), counted = measured_collective_bytes(
            mesh, step, state, cfg2, dt, relax)
        out.append((state, stats, counted))
    return out


def chains_unequal(got, want):
    """``(what differs, batch_pos_sum's largest relative error)`` of two
    :func:`chain` results: the state fields a step writes, the stats (but
    ``batch_pos_sum``) and the bytes, step by step, bit for bit."""
    import dataclasses
    from egg_fluid_simulation_tpu_torch.ops.step_graph import CARRIED
    bad, err = set(), 0.0
    for k, ((sa, ta, ba), (sb, tb, bb)) in enumerate(zip(got, want)):
        bad |= {f"{k}.{f}" for f in CARRIED
                if not torch.equal(getattr(sa, f), getattr(sb, f))}
        for f in dataclasses.fields(ta):
            a, b = getattr(ta, f.name), getattr(tb, f.name)
            if f.name == "batch_pos_sum":
                err = max(err, float(((a - b).abs()
                                      / b.abs().clamp(min=1.0)).max()))
            elif not torch.equal(a, b):
                bad.add(f"{k}.{f.name}")
        if ba != bb:
            bad.add(f"{k}.bytes")
    return sorted(bad), err


def traced_step(step, *args, attempts: int = 3) -> dict:
    """One call of ``step(*args)`` under ``torch.profiler``: kernel H's
    launches by entry point, the CUDA kernels and their device ms. A trace
    can lose records: it is taken again (up to ``attempts``) until H's
    front and sweep launch alike."""
    from egg_fluid_simulation_tpu_torch.utils.profiling import \
        kernel_launches
    for _ in range(attempts):
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        h = kernel_launches(prof, H_SYMBOLS)
        if h["gather_front"] == h["gather_sweep"] > 0:
            break
    return dict(h=h, h_total=sum(h.values()), kernels=len(kernels),
                device_ms=round(dev_ms, 4), profiled_wall_ms=round(wall, 4),
                busy_share=round(dev_ms / wall, 3))


def time_sharded(mesh, lead: bool) -> None:
    """The sharded step replayed and eager at ``N_TIMED`` particles in all
    (``bench.build_handler``'s scene on the gather engine, budget off), on
    every rank: ms a step (median of ``TIMED_BLOCKS`` blocks of
    ``TIMED_STEPS`` chained steps from the scene's state, CUDA events, the
    routes in turns) for each of ``CAPTURES`` captures; kernel H's launches
    a step and device ms from a trace of one replayed and one eager step;
    the graph's nodes, capture seconds and pool bytes; the bytes a step.
    Raises unless H launches 24 times a step replayed (a front and a sweep
    a pass)."""
    from egg_fluid_simulation_tpu_torch.bench import build_handler
    from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    from egg_fluid_simulation_tpu_torch.utils.profiling import (
        graph_node_types, nvidia_smi)
    from .accounting import measured_collective_bytes
    from .sharding import shard_state, sharded_step
    from .sharding_graph import ShardedGraphs
    dev = mesh.device
    h = build_handler(N_TIMED, dev, engine="gather", budget_mode="off")
    opts = h._options
    cfg2 = h._device_cfg2()
    dt, relax = h._step_scalars(1 / 60)
    st0 = shard_state(h.state, mesh)
    eager = sharded_step(mesh, opts, graphs=EAGER)
    passes = 2 * opts.n_substeps * opts.n_collision_steps
    ms = {"replay": [], "eager": []}
    first_s = []
    for _ in range(CAPTURES):
        graphs = ShardedGraphs(mesh, opts)
        replay = sharded_step(mesh, opts, graphs=graphs)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        replay(st0, cfg2, dt, relax)
        torch.cuda.synchronize(dev)
        first_s.append(round(time.perf_counter() - t0, 3))
        blocks = {"replay": [], "eager": []}
        for b in range(TIMED_BLOCKS):
            for mode in (("replay", "eager") if b % 2 == 0
                         else ("eager", "replay")):
                step = replay if mode == "replay" else eager
                st = st0
                torch.cuda.synchronize(dev)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                for _ in range(TIMED_STEPS):
                    st, _ = step(st, cfg2, dt, relax)
                ev1.record()
                torch.cuda.synchronize(dev)
                blocks[mode].append(ev0.elapsed_time(ev1) / TIMED_STEPS)
        for mode in ms:
            ms[mode].append(round(float(np.median(blocks[mode])), 4))
    g = graphs.graph()
    _, bytes_replay = measured_collective_bytes(mesh, replay, st0, cfg2, dt,
                                                relax)
    _, bytes_eager = measured_collective_bytes(mesh, eager, st0, cfg2, dt,
                                               relax)
    tr = {"replay": traced_step(replay, st0, cfg2, dt, relax),
          "eager": traced_step(eager, st0, cfg2, dt, relax)}
    # the largest median over the ranks, per route and capture
    worst = mesh.pmax(torch.tensor(ms["replay"] + ms["eager"],
                                   dtype=torch.float32, device=dev),
                      "report").tolist()
    if lead:
        print(f"dryrun: sharded step timed, {mesh.size} rank(s), "
              f"{h.get_n_particles()} particles ({st0.pos.shape[1]} a rank), "
              f"engine {opts.engine}, table {opts.table_size}, K "
              f"{opts.slots_per_cell}; ms a step (median of {TIMED_BLOCKS} "
              f"blocks of {TIMED_STEPS} steps, CUDA events, rank 0) replayed "
              f"{ms['replay']} eager {ms['eager']} (per capture; largest "
              f"over the ranks {worst[:CAPTURES]} / {worst[CAPTURES:]}); "
              f"first call {first_s} s, capture "
              f"{round(g.capture_seconds, 3)} s, pool {graphs.pool_bytes()} "
              f"B, graph nodes {graph_node_types(g._graph.raw_cuda_graph())}; "
              f"one step traced: replayed {tr['replay']}, eager "
              f"{tr['eager']}; bytes a step replayed {bytes_replay} eager "
              f"{bytes_eager}; card {nvidia_smi()}", flush=True)
    if tr["replay"]["h"] != {"gather_front": passes, "gather_sweep": passes,
                             "gather_count": 0} or bytes_replay != bytes_eager:
        raise AssertionError(f"sharded step replayed: H launched "
                             f"{tr['replay']['h']} a step (expected "
                             f"{passes} fronts and sweeps), bytes "
                             f"{bytes_replay} against {bytes_eager}")


def check(n_ranks: int, device: str) -> None:
    """The dry run's checks, on every rank of a running group; rank 0
    prints."""
    import torch.distributed as dist

    from egg_fluid_simulation_tpu_torch import (SpatialHandler,
                                                default_white_config,
                                                default_yolk_config)
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.ops import solver as solver_ops
    from egg_fluid_simulation_tpu_torch.ops.solver import SolverOptions
    from egg_fluid_simulation_tpu_torch.parallel import sharding
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S

    lead = dist.get_rank() == 0
    mesh = sharding.make_mesh(device)
    dev = mesh.device
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (gloo ranks)")
    capacity = n_ranks * max(64, -(-512 // n_ranks))
    h = _tiny_handler(capacity, dev)
    opts = SolverOptions(engine="gather", table_size=2048, slots_per_cell=16,
                         budget_mode="off")
    cfg2 = h._device_cfg2()
    dt = torch.tensor(1 / 60, device=dev)
    relax = torch.tensor(1.0, device=dev)
    step = sharding.sharded_step(mesh, opts)
    new, stats = step(sharding.shard_state(h.state, mesh), cfg2, dt, relax)
    pos = sharding.unshard_state(new, mesh).pos.cpu().numpy()
    if not np.isfinite(pos[:, :70]).all():
        raise AssertionError("sharded step produced non-finite positions")
    ref, _ = solver_ops.step(h.state, cfg2, dt, relax, opts)
    np.testing.assert_allclose(pos[:, :70], ref.pos.cpu().numpy()[:, :70],
                               rtol=1e-5, atol=1e-4)
    if lead:
        print(f"dryrun: {n_ranks}-rank sharded step OK ({kind}), matches one "
              f"device, centroid={stats.centroid[0].cpu().numpy().round(2)}",
              flush=True)

    # ---- the same state through the sharded step's graph (captured on a
    # card, its plumbing run eagerly on the CPU) against the eager route ----
    from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    from egg_fluid_simulation_tpu_torch.parallel.sharding_graph import \
        ShardedGraphs
    graphs = ShardedGraphs(mesh, opts, capture=dev.type == "cuda")
    st0 = sharding.shard_state(h.state, mesh)
    got = chain(sharding.sharded_step(mesh, opts, graphs=graphs), st0, cfg2,
                dt, relax, GRAPH_STEPS, mesh)
    want = chain(sharding.sharded_step(mesh, opts, graphs=EAGER), st0, cfg2,
                 dt, relax, GRAPH_STEPS, mesh)
    bad, err = chains_unequal(got, want)
    if bad or err > STATS_RTOL or graphs.captures != 1:
        raise AssertionError(f"the sharded step's graph differs from the "
                             f"eager step: {bad}, batch sums {err}")
    if lead:
        route = "replayed" if dev.type == "cuda" else "graph plumbing, eager"
        print(f"dryrun: sharded step {route} = eager over {GRAPH_STEPS} "
              f"steps, bit for bit (batch_pos_sum rel err {err}); bytes a "
              f"step {got[0][2]}", flush=True)
    if dev.type == "cuda":
        time_sharded(mesh, lead)

    # ---- 2D spatial decomposition (dense engine, halo exchange) ----
    db, dx = MESHES[n_ranks]
    lay = S.SpatialLayout(grid_dim=32, slots_per_cell=4, db=db, dx=dx,
                          migrate_cap=32)
    sp_opts = SolverOptions(engine="dense", budget_mode="off",
                            dense_rebin="step", dense_grid_dim=32,
                            dense_slots=4)
    h2 = _tiny_handler(capacity, dev, engine="dense")
    cells = [max(1.0, cfg["max_radius"]
                 * max(cfg["collision_overlap_factor"],
                       cfg["cohesion_interaction_distance_factor"]))
             for cfg in (h2._white_config, h2._yolk_config)]
    sp_mesh = S.make_spatial_mesh(db, dx, device)
    sp_state = S.redistribute(h2.state, cells, lay, sp_mesh)
    sp_state, sp_stats, _ = S.spatial_step(sp_mesh, lay, sp_opts)(
        sp_state, h2._device_cfg2(), dt, relax)
    if not torch.isfinite(sp_state.pos).all():
        raise AssertionError("spatial step produced non-finite positions")
    _, ref2_stats = solver_ops.step(h2.state, h2._device_cfg2(), dt, relax,
                                    sp_opts)
    np.testing.assert_allclose(sp_stats.centroid.cpu().numpy(),
                               ref2_stats.centroid.cpu().numpy(), rtol=1e-4,
                               atol=1e-3)
    cb = lay.collective_bytes_per_step(sp_opts)
    if lead:
        print(f"dryrun: ({db}x{dx})-mesh 2D spatial dense step OK, halo "
              f"exchange + migration, centroid matches one device; bytes a "
              f"step a rank (model): {cb['total_per_step']:,}", flush=True)

    # ---- resident steps (drift-gated rebin, migration inside it) ----
    multi = S.spatial_multi_step(sp_mesh, lay, sp_opts)
    sp_state2, sp_stats2, info2, _ = multi(sp_state, h2._device_cfg2(), dt,
                                           relax, 3)
    if not (torch.isfinite(sp_state2.pos).all()
            and int(info2[:, 0].sum()) == 0):
        raise AssertionError("resident spatial steps: non-finite or dropped")
    if lead:
        print(f"dryrun: ({db}x{dx})-mesh resident steps OK (3 steps)",
              flush=True)

    # ---- sharded render ----
    opts2 = tuple(R.auto_render_options(cfg, 256)
                  for cfg in (h2._white_config, h2._yolk_config))
    draw = S.spatial_draw(sp_mesh, lay, opts2, (0.0, 0.0, 256, 256), 0.3,
                          0.01, True)
    frame, audits = draw(sp_state2, sp_stats2, h2._device_cfg2(), 1.0)
    frame = frame.cpu().numpy()
    if not (frame.shape == (256, 256, 4) and np.isfinite(frame).all()
            and frame[..., 3].max() > 0.05):
        raise AssertionError("sharded render is empty or not finite")
    if int(audits[:, 0].sum()) != 0:
        raise AssertionError(f"sharded render dropped splats: {audits}")
    if lead:
        print(f"dryrun: ({db}x{dx})-mesh sharded render OK (frame alpha max "
              f"{frame[..., 3].max():.3f})", flush=True)

    # ---- the product surface ----
    hp = SpatialHandler(default_white_config(), default_yolk_config(),
                        db=db, dx=dx, capacity=capacity, max_batches=8,
                        options=sp_opts, device=device)
    bid = hp.add(60.0, 50.0, 25.0, 8.0, None, None, 50, 12)
    hp.set_target_position(bid, 100.0, 80.0)
    hp.update(2 / 60)
    hp.run_steps(2)
    frame2 = hp.draw(viewport=(0, 0, 256, 256)).cpu().numpy()
    px, py = hp.get_position(bid)
    if not (np.isfinite(frame2).all() and frame2[..., 3].max() > 0.05
            and np.isfinite([px, py]).all()):
        raise AssertionError("SpatialHandler product flow failed")
    if lead:
        print(f"dryrun: SpatialHandler product flow OK (add / update / "
              f"run_steps / draw / get_position on the {db}x{dx} mesh)",
              flush=True)

    # ---- the same flow on the eager route: on a card the handler above
    # replayed its steps and draws from CUDA graphs ----
    from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    from egg_fluid_simulation_tpu_torch.parallel.spatial_graph import (
        STATE_OUT, rebin_route)
    he = SpatialHandler(default_white_config(), default_yolk_config(),
                        db=db, dx=dx, capacity=capacity, max_batches=8,
                        options=sp_opts, device=device)
    he._spatial = EAGER
    bid = he.add(60.0, 50.0, 25.0, 8.0, None, None, 50, 12)
    he.set_target_position(bid, 100.0, 80.0)
    he.update(2 / 60)
    he.run_steps(2)
    frame_e = he.draw(viewport=(0, 0, 256, 256)).cpu().numpy()
    unequal = [f for f in STATE_OUT if not torch.equal(
        getattr(hp.state, f), getattr(he.state, f))]
    frame_err = float(np.abs(frame2 - frame_e).max())
    if unequal or frame_err > 1e-6:
        raise AssertionError(f"the replayed SpatialHandler differs from the "
                             f"eager one: {unequal}, frame {frame_err}")
    if lead:
        route = ("eager on the CPU" if hp._spatial is None
                 else f"graphs, rebin route {rebin_route(hp.mesh)}")
        print(f"dryrun: SpatialHandler ({route}) = the eager route, bit for "
              f"bit (frame {frame_err})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"),
                    help="cpu: gloo ranks; cuda: NCCL, one card a rank")
    ap.add_argument("--ranks", type=int, default=4, choices=sorted(MESHES))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device")
    from .mesh import spawn_ranks
    spawn_ranks(check, (args.ranks, args.device), args.ranks, args.device,
                timeout_s=600.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
