"""Benchmark of the port on one CUDA card: the keys of the JAX package's
``bench.py``, measured through the port's API.

    python -m egg_fluid_simulation_tpu_torch.bench [--quick]
    python bench_torch.py [--quick]
    python bench_torch.py --spatial --device cuda --ranks 1

Stages, each one function of the device and its sizes (particles, settle
steps, block length and block count), each printing one flushed JSON line in
the headline shape of ``bench.py`` (``metric``, ``value`` = p50 step+render
ms at 1M, ``unit``, ``vs_baseline`` = 16 ms frame / ``value``, ``stage``,
``wall_s``, then every key known so far); the last line (``stage`` =
``final``) holds them all:

- ``10k``: ``step_ms_10k`` (``run_steps(n)`` per step on the 10k scene,
  dense engine, after 120 settle steps), ``particle_steps_per_sec_10k``,
  ``engine_10k``;
- ``1m_step``: ``n_particles_headline``, ``step_ms_1m`` (``run_steps(n)`` per
  step: the resident ``solver.multi_step``, replayed from its graphs on a
  card), ``particle_steps_per_sec_1m``, ``host_syncs_per_step_1m`` (host
  reads of the rebin flag: 0 on a card) and ``rebins_1m`` (the replayed
  loop's device counter, read between blocks) over its timed blocks,
  ``update_ms_1m`` (``update(1/60)`` per step: the fixed step replayed from
  its CUDA graph), the ``drop_stats`` keys and ``physics_honest``;
- ``1m_step_render``: ``step_render_ms_1m`` (``solver.multi_step_frames`` per
  frame through the handler's resident graphs, each frame a replayed render
  of the full canvas viewport at an interpolation alpha cycling over
  ``linspace(0.15, 1, block)``), ``render_ms_1m`` (its
  difference to ``step_ms_1m``), ``render_overflow_dropped`` (the final
  state re-rendered with its audit read: the stage fails if it is not 0),
  ``drop_stats`` again;
- ``render_modes``: ``render_only_ms_coarse`` / ``_full`` (render-only
  frames of the current state at cycling alpha), ``coarse_vs_full_max_err``
  / ``_mean_err`` (one frame of each);
- ``1m_step_default``: ``step_ms_1m_default_opts`` (the constructor-default
  wide sweep, ``wide_budget_substeps`` left as it is);
- ``spatial_1x1``: ``spatial_1x1_step_ms_65k``, ``dense_step_ms_65k``,
  ``spatial_1x1_vs_dense`` (a 1 x 1 ``SpatialHandler`` against the dense
  handler, 65,536 particles, 60 settle steps; on a card the spatial
  handler's resident steps replay from its graphs,
  ``parallel/spatial_graph.py``), ``spatial_host_syncs_per_step_65k``
  (host reads of the spatial rebin decision a step over its timed blocks:
  0 when replayed).

Timing: blocks of a fixed number of steps or frames between two CUDA events
(``utils.profiling.StepTimer``), one untimed warm-up block first (it builds
the kernels, captures the step's, the resident loops' and the render's
graphs, fills the caches); every render is the one ``draw`` replays
(``ops/render_graph.py``), every resident step a replay of
``ops/resident_graph.py``; a key is the p50 of its blocks per step or
frame, with ``<key>_p25``, ``<key>_p75`` and ``<key>_blocks`` beside it. The
events hold the host's gaps between launches: wall time of the card, not
its busy time. ``--quick`` runs the 1M stages at 65,536 particles.

No fallback: without a card the bench prints one line and exits 1. The last
three stages record ``render_modes_error``, ``default_opts_error`` or
``spatial_error`` when they raise and the run goes on, as in ``bench.py``;
the process then exits 1. A failure of the first three stages (a render drop
included) ends the run with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import (SimulationHandler, SolverOptions, SpatialHandler,
               default_white_config, default_yolk_config)
from .ops import solver as S
from .parallel import spatial as SP
from .parallel import spatial_bench
from .utils.profiling import StepTimer, collision_drop_stats

__all__ = ["SPAWN_AREA", "BENCH_KEYS", "PORT_KEYS", "TIMED_KEYS", "SIZES",
           "build_handler", "render_frame_fn", "emit", "drop_stats",
           "rebin_count",
           "stage_10k", "stage_1m_step", "stage_1m_step_render",
           "stage_render_modes", "stage_default_opts", "stage_spatial_1x1",
           "run", "main"]

T0 = time.time()
SPAWN_AREA = 20.0   # px^2 per white particle at spawn (settled: ~16.2)
TARGET_MS = 16.0    # the frame budget vs_baseline divides
METRIC = "p50 step+render latency at 1M particles"
SETTLE = 120        # steps past the mild spawn transient (~2 simulated s)
QUICK_N = 65_536    # --quick: the 1M stages' particles

# The keys of bench.py, with its meaning (tests/test_torch_bench.py reads
# the file's own stores and checks this list against them)
BENCH_KEYS = (
    "step_ms_10k", "particle_steps_per_sec_10k", "n_particles_headline",
    "step_ms_1m", "particle_steps_per_sec_1m",
    "collision_drop_pct_white", "max_cell_occupancy_white",
    "mean_cell_occupancy_white", "collision_drop_pct_yolk",
    "max_cell_occupancy_yolk", "mean_cell_occupancy_yolk", "physics_honest",
    "step_render_ms_1m", "render_ms_1m", "render_overflow_dropped",
    "render_only_ms_coarse", "render_only_ms_full", "coarse_vs_full_max_err",
    "coarse_vs_full_mean_err", "step_ms_1m_default_opts",
    "spatial_1x1_step_ms_65k", "dense_step_ms_65k", "spatial_1x1_vs_dense")
# the keys a failed extra stage records in bench.py
ERROR_KEYS = {"render_modes": "render_modes_error",
              "1m_step_default": "default_opts_error",
              "spatial_1x1": "spatial_error"}
# timed keys: each has <key>_p25, <key>_p75 and <key>_blocks beside it
TIMED_KEYS = ("step_ms_10k", "step_ms_1m", "update_ms_1m", "step_render_ms_1m",
              "render_only_ms_coarse", "render_only_ms_full",
              "step_ms_1m_default_opts", "spatial_1x1_step_ms_65k",
              "dense_step_ms_65k")
# the keys the port adds: the device, the engine of the 10k stage, the
# replayed update beside step_ms_1m and what explains the gap between them,
# and the spatial handler's host reads of its rebin decision
PORT_KEYS = ("device", "engine_10k", "update_ms_1m", "host_syncs_per_step_1m",
             "rebins_1m", "spatial_host_syncs_per_step_65k")

# Each stage's sizes: particles, settle steps, steps or frames a timed block,
# timed blocks (bench.py's counts of particles and settle steps)
SIZES = {
    "10k": dict(n=10_000, settle=SETTLE, block=100, blocks=5),
    "1m_step": dict(n=1_000_000, settle=SETTLE, block=40, blocks=5),
    "1m_step_render": dict(block=20, blocks=5),
    "render_modes": dict(block=16, blocks=5),
    "1m_step_default": dict(n=1_000_000, settle=SETTLE, block=20, blocks=5),
    "spatial_1x1": dict(n=65_536, settle=60, block=20, blocks=5),
}


def emit(stage: str, results: dict, final: bool = False) -> None:
    """One flushed, headline-shaped JSON line (``bench.py``'s shape)."""
    sr = results.get("step_render_ms_1m")
    out = {
        "metric": METRIC,
        "value": sr,
        "unit": "ms",
        "vs_baseline": round(TARGET_MS / sr, 4) if sr else None,
        "stage": "final" if final else stage,
        "wall_s": round(time.time() - T0, 1),
        **results,
    }
    print(json.dumps(out), flush=True)


def build_handler(n_target: int, device, wide_default: bool = False,
                  spatial: bool = False, **overrides):
    """``bench.py``'s scene through the port's API: ~``n_target`` whites in
    2000-white batches (the oracle-equilibrium gate's size) tiled alias-free,
    a tenth as many yolks, a grid per population that covers the scene, dense
    engine, budget off, one rebin a step, K = 4, ``wide_budget_substeps=0``
    unless ``wide_default``; ``overrides`` replace solver options.
    ``spatial`` builds a SpatialHandler on a 1 x 1 mesh with the one shared
    grid its layout requires (``build_handler(n, spatial=1)`` of bench.py)."""
    per_batch = max(200, min(n_target // 4, 2000))
    n_batches = min(max(1, n_target // per_batch), 512)
    per_batch_w = n_target // n_batches
    per_batch_y = max(2, per_batch_w // 10)
    cap_w = 1 << int(np.ceil(np.log2(max(per_batch_w * n_batches, 1024))))
    cap_y = 1 << int(np.ceil(np.log2(max(per_batch_y * n_batches, 1024))))
    radius = float(np.sqrt(per_batch_w * SPAWN_AREA / np.pi))
    spacing = 2.0 * radius + 0.25 * radius
    side = int(np.ceil(np.sqrt(n_batches)))
    extent = (side - 1) * spacing + 2.0 * radius + 64.0

    def pick_grid(cell: float, n_pop: int) -> int:
        g = 32
        while g * cell < extent * 1.04 or g * g * 4 < 2 * n_pop:
            g += 32
        return g

    g_w = pick_grid(8.0, per_batch_w * n_batches)
    g_y = pick_grid(12.0, per_batch_y * n_batches)
    if spatial:
        g_w = g_y = max(g_w, g_y)
    kw = dict(engine="dense", budget_mode="off", dense_rebin="step",
              dense_grid_dim=(g_w, g_y), dense_slots=4, pop_caps=(cap_w, cap_y))
    if not wide_default:
        kw["wide_budget_substeps"] = 0
    options = SolverOptions(**{**kw, **overrides})
    hk = dict(capacity=max(cap_w, cap_y), max_batches=max(n_batches, 4),
              options=options, device=device)
    specs = [dict(x=float((b % side) * spacing + radius + 32.0),
                  y=float((b // side) * spacing + radius + 32.0),
                  white_radius=radius, yolk_radius=radius * 0.3,
                  white_n_particles=per_batch_w,
                  yolk_n_particles=per_batch_y)
             for b in range(n_batches)]
    if spatial:
        h = SpatialHandler(default_white_config(), default_yolk_config(),
                           db=1, dx=1, **hk)
        for sp in specs:
            h.add(sp["x"], sp["y"], sp["white_radius"], sp["yolk_radius"],
                  None, None, sp["white_n_particles"], sp["yolk_n_particles"])
        return h
    h = SimulationHandler(default_white_config(), default_yolk_config(), **hk)
    h.add_many(specs)
    return h


def render_frame_fn(h, viewport, audits=None, alphas=None):
    """A ``multi_step_frames`` ``frame_fn(state, stats, t)``: the handler's
    render of ``viewport`` with its current options, reduced to a sum, by
    the route ``draw`` takes (a replay of the handler's render graph on a
    card). The interpolation alpha is ``alphas[t % len(alphas)]`` (a 1-D
    tensor on the handler's device), else the handler's own. Each frame's
    render audit is appended to ``audits``."""
    opts2 = h._frame_options()

    def frame_fn(state, stats, t=0):
        a = None if alphas is None else alphas[t % alphas.shape[0]]
        f, _, audit = h._render(opts2, viewport, state=state, stats=stats,
                                alpha=a, clone=False)
        if audits is not None:
            audits.append(audit.clone())
        return torch.sum(f)
    return frame_fn


def drop_stats(h) -> dict:
    """The in-band honesty counters of ``bench.py``: per population the
    settled collision-budget drop rate and the peak and mean cell occupancy;
    ``physics_honest`` holds white to the oracle-equilibrium envelope (drops
    <= 25%, max occupancy <= 22)."""
    ds = collision_drop_stats(h)
    out = {}
    for pop in ("white", "yolk"):
        out[f"collision_drop_pct_{pop}"] = round(ds[pop]["drop_pct"], 3)
        out[f"max_cell_occupancy_{pop}"] = ds[pop]["max_cell_occupancy"]
        out[f"mean_cell_occupancy_{pop}"] = round(
            ds[pop]["mean_cell_occupancy"], 3)
    out["physics_honest"] = bool(
        out["collision_drop_pct_white"] <= 25.0
        and out["max_cell_occupancy_white"] <= 22)
    return out


def _blocks_ms(fn, per_block: int, blocks: int, device, after=None) -> list:
    """Per-unit ms of ``blocks`` timed calls of ``fn`` (each ``per_block``
    steps or frames), after one untimed warm-up call. On a CUDA device each
    block lies between two CUDA events with the device idle before it.
    ``after()`` runs after each call, warm-up included, outside the
    timing."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    timer = StepTimer(window=blocks, device=device)
    after = after or (lambda: None)
    fn()
    after()
    for _ in range(blocks):
        if cuda:
            torch.cuda.synchronize(device)
        with timer.phase("block"):
            fn()
        after()
    return [ms / per_block for ms in timer.samples("block")]


def _spread(key: str, ms: list) -> dict:
    """``key``: the p50 of the blocks' ms; its p25, p75 and block count."""
    p25, p50, p75 = (float(v) for v in np.percentile(ms, [25, 50, 75]))
    return {key: round(p50, 4), f"{key}_p25": round(p25, 4),
            f"{key}_p75": round(p75, 4), f"{key}_blocks": len(ms)}


def _steps_ms(h, key: str, block: int, blocks: int) -> dict:
    """``run_steps(block)`` per step, in timed blocks."""
    return _spread(key, _blocks_ms(lambda: h.run_steps(block), block, blocks,
                                   h.device))


def stage_10k(device, n: int, settle: int, block: int, blocks: int) -> dict:
    """``step_ms_10k``: ``run_steps(block)`` per step on the settled 10k
    scene (the dense engine, as bench.py pins it)."""
    h = build_handler(n, device)
    total = sum(h.get_n_particles())
    h.run_steps(settle)
    out = _steps_ms(h, "step_ms_10k", block, blocks)
    out["particle_steps_per_sec_10k"] = round(
        total / out["step_ms_10k"] * 1000, 0)
    out["engine_10k"] = h._options.engine
    return out


def rebin_count(h) -> list:
    """The rebins (white, yolk) the handler's resident loops took so far:
    its replayed loops' device counter, read on the host, on a card;
    ``solver.rebins`` where the loop runs eagerly."""
    graphs = h._resident_graphs()
    if graphs is None:
        return list(S.rebins)
    return [0, 0] if graphs.rebins is None else graphs.rebins.tolist()


def stage_1m_step(device, n: int, settle: int, block: int, blocks: int):
    """The headline handler, settled: ``step_ms_1m`` (``run_steps(block)``
    per step, the resident loop, replayed on a card) with its host reads of
    the rebin flag and its rebins (both read between blocks), then
    ``update_ms_1m`` (``update(1/60)`` per step, the step replayed from its
    graph), then ``drop_stats``. Returns ``(handler, keys)``."""
    h = build_handler(n, device)
    total = sum(h.get_n_particles())
    h.run_steps(settle)
    out = {"n_particles_headline": total}
    # the counts after each block; the first block is the untimed warm-up
    syncs, rebins = [], []
    S.host_syncs = 0
    S.rebins[:] = [0, 0]

    def counts():
        syncs.append(S.host_syncs)
        rebins.append(rebin_count(h))
    out.update(_spread("step_ms_1m", _blocks_ms(
        lambda: h.run_steps(block), block, blocks, h.device, after=counts)))
    out["particle_steps_per_sec_1m"] = round(total / out["step_ms_1m"] * 1000,
                                             0)
    out["host_syncs_per_step_1m"] = (syncs[-1] - syncs[0]) / (blocks * block)
    out["rebins_1m"] = [rebins[-1][i] - rebins[0][i] for i in (0, 1)]
    out.update(_spread("update_ms_1m", _blocks_ms(
        lambda: [h.update(1 / 60) for _ in range(block)], block, blocks,
        h.device)))
    out.update(drop_stats(h))
    return h, out


def _canvas_viewport(h):
    """``bench.py``'s frame viewport: the largest canvas of the current
    render options, square, centred on the white centroid."""
    view = float(max(o.canvas_size for o in h._frame_options()))
    origin = (h.stats.centroid[0].cpu().numpy() - view / 2.0).astype(np.float32)
    return (float(origin[0]), float(origin[1]), int(view), int(view))


def _alphas(block: int, device) -> torch.Tensor:
    """The frame loop's interpolation alphas, ``linspace(0.15, 1, block)``
    in float32, as ``bench.py`` cycles them."""
    return torch.from_numpy(
        np.linspace(0.15, 1.0, block).astype(np.float32)).to(device)


def stage_1m_step_render(h, step_ms_1m: float, block: int,
                         blocks: int) -> dict:
    """``step_render_ms_1m``: ``solver.multi_step_frames`` per frame on the
    headline handler, through its resident graphs (its steps replayed on a
    card), each frame a render of the full canvas viewport at a
    cycling alpha, after the render budget is seeded from the measured peak
    bin occupancy and one audited draw (which may raise it) froze the
    options. The final state is then rendered once more with its audit read
    (``render_overflow_dropped``)."""
    h.seed_render_budget()
    viewport = _canvas_viewport(h)
    h.draw(viewport=viewport, check_overflow=True)
    alphas = _alphas(block, h.device)
    frame_fn = render_frame_fn(h, viewport, alphas=alphas)
    cfg2 = h._device_cfg2()
    dt, relax = h._step_scalars(1 / 60)

    def frames():
        h._state, _, h._wide_state = S.multi_step_frames(
            h.state, cfg2, dt, relax, h._options, block, frame_fn,
            wide_state=h._wide_or_init(), graphs=h._resident_graphs())
        h._frames = None
    out = _spread("step_render_ms_1m",
                  _blocks_ms(frames, block, blocks, h.device))
    out["render_ms_1m"] = round(out["step_render_ms_1m"] - step_ms_1m, 4)
    audits = []
    render_frame_fn(h, viewport, audits, alphas[-1:])(h.state, h.stats)
    out["render_overflow_dropped"] = int(audits[0][:, 0].sum())
    out.update(drop_stats(h))
    return out


def stage_render_modes(h, block: int, blocks: int) -> dict:
    """``render_only_ms_coarse`` / ``_full``: render-only frames of the
    handler's current state at a cycling alpha in each post mode, and the
    two modes' frames at alpha 1 against each other."""
    out, frames = {}, {}
    for mode in ("coarse", "full"):
        old = h._render_post_mode
        h._render_post_mode = mode
        try:
            viewport = _canvas_viewport(h)
            opts2 = h._frame_options()
            alphas = _alphas(block, h.device)

            def render(a):
                return h._render(opts2, viewport, alpha=a, clone=False)[0]

            def loop():
                acc = torch.zeros((), dtype=torch.float32, device=h.device)
                for t in range(block):
                    acc = acc + torch.sum(render(alphas[t]))
                return acc
            out.update(_spread(f"render_only_ms_{mode}",
                               _blocks_ms(loop, block, blocks, h.device)))
            frames[mode] = render(alphas[-1]).cpu().numpy()
        finally:
            h._render_post_mode = old
    diff = np.abs(frames["coarse"] - frames["full"])
    out["coarse_vs_full_max_err"] = round(float(diff.max()), 4)
    out["coarse_vs_full_mean_err"] = round(float(diff.mean()), 5)
    return out


def stage_default_opts(device, n: int, settle: int, block: int,
                       blocks: int) -> dict:
    """``step_ms_1m_default_opts``: ``run_steps(block)`` per step on the
    scene with the constructor-default wide sweep, settled."""
    hd = build_handler(n, device, wide_default=True)
    hd.run_steps(settle)
    return _steps_ms(hd, "step_ms_1m_default_opts", block, blocks)


def stage_spatial_1x1(device, n: int, settle: int, block: int,
                      blocks: int) -> dict:
    """``spatial_1x1_step_ms_65k`` and ``dense_step_ms_65k``:
    ``run_steps(block)`` per step of a 1 x 1 ``SpatialHandler`` (a one-rank
    group in this process, left again afterwards when the stage started it)
    and of the dense handler on the same scene, each settled."""
    started = not dist.is_initialized()
    try:
        hs = build_handler(n, device, spatial=True)
        hs.run_steps(settle)
        reads = []                 # after each block, warm-up included
        out = _spread("spatial_1x1_step_ms_65k", _blocks_ms(
            lambda: hs.run_steps(block), block, blocks, hs.device,
            after=lambda: reads.append(SP.host_reads)))
        out["spatial_host_syncs_per_step_65k"] = (
            (reads[-1] - reads[0]) / (blocks * block))
        del hs
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    hd = build_handler(n, device)
    hd.run_steps(settle)
    out.update(_steps_ms(hd, "dense_step_ms_65k", block, blocks))
    out["spatial_1x1_vs_dense"] = round(
        out["spatial_1x1_step_ms_65k"] / max(out["dense_step_ms_65k"], 1e-9),
        4)
    return out


def _extra_stage(stage: str, results: dict, fn, *args, **sizes) -> None:
    """One of the stages after the headline: its failure is recorded under
    ``bench.py``'s key (the traceback on stderr) and the run goes on."""
    try:
        results.update(fn(*args, **sizes))
    except Exception as e:  # noqa: BLE001 — keep later stages alive
        traceback.print_exc()
        results[ERROR_KEYS[stage]] = f"{type(e).__name__}: {e}"
    emit(stage, results)


def run(device, quick: bool = False, sizes=None) -> int:
    """Every stage on ``device`` at ``SIZES`` (the 1M stages at 65,536
    particles with ``quick``; ``sizes`` replaces a stage's entries), one
    line each, then the final line. Returns 1 when a stage recorded an
    error, else 0; a failure of the first three stages raises."""
    device = torch.device(device)
    sz = {k: dict(v) for k, v in SIZES.items()}
    if quick:
        sz["1m_step"]["n"] = sz["1m_step_default"]["n"] = QUICK_N
    for k, v in (sizes or {}).items():
        sz[k].update(v)
    results = {"device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else device.type)}

    results.update(stage_10k(device, **sz["10k"]))
    emit("10k", results)

    h, keys = stage_1m_step(device, **sz["1m_step"])
    results.update(keys)
    emit("1m_step", results)

    results.update(stage_1m_step_render(h, results["step_ms_1m"],
                                        **sz["1m_step_render"]))
    emit("1m_step_render", results)
    if results["render_overflow_dropped"] != 0:
        raise AssertionError(
            f"render budget overflow in the headline frame: "
            f"{results['render_overflow_dropped']} particles dropped")

    _extra_stage("render_modes", results, stage_render_modes, h,
                 **sz["render_modes"])
    _extra_stage("1m_step_default", results, stage_default_opts, device,
                 **sz["1m_step_default"])
    del h
    if device.type == "cuda":
        torch.cuda.empty_cache()
    _extra_stage("spatial_1x1", results, stage_spatial_1x1, device,
                 **sz["spatial_1x1"])
    emit("final", results, final=True)
    return int(any(k in results for k in ERROR_KEYS.values()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="The port's bench on one CUDA card (bench.py's keys).")
    ap.add_argument("--quick", action="store_true",
                    help="the 1M stages at 65,536 particles")
    ap.add_argument("--spatial", action="store_true",
                    help="run parallel/spatial_bench.py instead (needs "
                         "--device)")
    ap.add_argument("--device", choices=("cpu", "cuda"),
                    help="with --spatial: gloo ranks on the CPU or one card "
                         "a rank")
    ap.add_argument("--ranks", type=int,
                    help="with --spatial: the number of ranks")
    args = ap.parse_args(argv)
    if args.spatial:
        if args.device is None:
            ap.error("--spatial needs --device cpu or --device cuda")
        sub = ["--device", args.device]
        if args.ranks is not None:
            sub += ["--ranks", str(args.ranks)]
        return spatial_bench.main(sub)
    if args.device is not None or args.ranks is not None:
        ap.error("--device and --ranks go with --spatial; the bench itself "
                 "runs on the card")
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the bench runs only on the card",
              file=sys.stderr, flush=True)
        return 1
    return run(torch.device("cuda", 0), quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
