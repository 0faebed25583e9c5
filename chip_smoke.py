#!/usr/bin/env python3
"""GPU smoke run of egg_fluid_simulation_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``egg_fluid_simulation_tpu_torch/
csrc/`` (the build line carries each kernel's registers and spills), checks
each kernel against its plain PyTorch version at the shapes of the paths
that run it (``check.*``: both populations of the 1M scene, white and yolk,
each timed for A, the sweeps B, D and E, the splat C and the count F), for
the tiled kernels B, D, E and F at small ragged grids with pairs across the
torus seam (``check.sweep_shapes``) and for the placement A at small ragged
grids with both binning layouts (``check.place_shapes``); A and F write
into memory that held NaN, so an element they leave unwritten shows. A and
F, which take tens of microseconds, are timed from a CUDA graph of 20 calls
(``graph_ms``), the others by CUDA events around calls launched one by one.
Then it drives the paths through the public API:

- ``main_path``: the 1M-white / 100k-yolk scene of ``bench.py``
  (``build_handler``) with the budget off (the fused path: kernels A, B),
  a few ``update(1/60)`` calls and a 2560 px ``draw`` (kernel C);
- ``resident_path`` / ``resident_frames``: on the same handler,
  ``run_steps`` (multi-step residency: kernel A only at the first binning,
  the final step and each drift-gated rebin) and ``multi_step_frames``
  with the render as ``frame_fn``, each replayed from the handler's
  resident graphs (the rebin in an IF node, no read of the device) against
  the eager loop from the same state, bit for bit, launches from a trace,
  rebins from the device counter; then timed both ways; the same steps on
  the bench's settled 10k scene (``resident_graph.*`` lines);
- ``default_options``: a small spawn explosion with the constructor-default
  solver options of an automatic handler (the wide sweep);
- ``plane_path``: the same 1M scene with the ordered budget and the default
  violence gate (the plane-resident step: kernels F, D), 3 updates and a
  draw; it fails when a binning's ``FIELD_CUM`` prefix reaches 2^24, where
  float32 stops counting by ones (``check.count_planes`` too);
- ``plane_modes``: a 65k-white scene under the symmetric sweep (kernel E),
  per-substep and per-pass rebinning, the stale-hash pass count and the
  literal cohesion mode;
- ``plane_reference``: a small scene stepped once on the card and on the
  CPU (plain versions): the ordered plane path, the symmetric sweep and, as
  a control, the fused path; positions held together;
- ``resident_reference``: a calm 4k lattice on the card and on the CPU:
  4 resident steps on the fused and on the plane-resident (symmetric
  sweep) variant, and 3 resident frames; ``warmup``: the state is
  unchanged by it.
- ``step_graph``: on the two 1M handlers (fused and plane) the update
  replays the fixed step from a CUDA graph (``ops/step_graph.py``); it is
  held bit for bit against ``solver.step`` run eagerly from the same state
  (stats but the atomically summed ``batch_pos_sum``, at ``STATS_RTOL``),
  and timed against eager updates in alternating blocks (wall, device ms,
  kernels, busy share of each);
- ``draw_graph``: ``draw`` replays its render from a CUDA graph
  (``ops/render_graph.py``). On the 1M handler at the bench's 2560 px
  canvas viewport and on the demo scene (the gather engine, capacity
  8192), the replayed draw is held bit for bit against the eager draw
  (frame, canvases, audit; the largest difference printed, a failure
  beyond ``DRAW_TOL``) at three interpolation alphas and after an
  ``update``, then timed against it (wall and device ms, kernels, kernel
  C's launches a draw from the trace: 2), with ``render.host_reads`` a
  draw (2 with the audit, 1 without) and the graphs' memory pools; a
  clustered scene's first draw overflows, bumps the budget (a new key),
  re-renders with nothing dropped, and a replay after it drops nothing;
- ``settled``: the 1M scene after the bench's 120 settle steps, kernels A,
  B and C checked on it as on the spawn state (the kernel line keeps the
  spawn state's numbers);
- ``gather_path``: an automatic handler at capacity 8192 (the gather
  engine: kernel H, ``csrc/gather_pairs.cu``, for the front of each
  collision pass's grid, the ordered budget's count and the sweep) with
  ~8000 live particles; ``check.gather_pairs`` first (H against its plain
  versions on the scene's state, both populations: the front bit for bit
  against ``build_grid``; budget on and off, binding, literal cohesion, a
  16-bucket table, a K read at run time, the owned range of the sharded
  step: the count bit for bit, the sweep within ``GATHER_TOL``; timed from
  a CUDA graph beside an empty kernel's time); then
  ``update(1/60)`` x10 and an 800 x 600 ``draw`` (kernel C), then
  ``run_steps(10)`` (H's launches asserted: a front, a count and a sweep
  each collision pass and population, no other solver kernel); wall p50 by
  CUDA events, device ms and launches per ``update`` from a
  ``utils.profiling.trace`` block, the collision budget's drops; the
  replayed step against the eager one as in ``step_graph``, and ``update``
  replayed against eager; ``gather_reference``: the default 4k scene
  stepped once on the card and on the CPU;
- ``demo``: the demo session (``DemoState.run``, as ``run_demo``) for 60
  frames on the card, a draw every 10th, then ``check.gather_pairs`` on
  its state, then frames of update + draw timed (CUDA events) and traced,
  replayed and eager in turns; ``checkpoint``: the demo's
  handler saved mid-session, loaded on the CPU and on the card (state bit
  for bit), one step on each (card vs CPU within the step tolerances);
- ``sharded_graph``: the 1D particle-sharded step (``parallel/sharding.py``)
  on a one-rank mesh (a 1-rank NCCL group in the process; its all-gather
  returns its input), replayed from its CUDA graph
  (``parallel/sharding_graph.py``) on the scene of ``gather_handler`` and
  on bench.py's 65,536-white scene with the gather engine, budget off: the
  first replayed step against the single-device gather step within
  ``SHARDED_TOL``; three chained replays, traced and with any read of the
  device an error, against the eager route bit for bit (``batch_pos_sum``
  within ``STATS_RTOL``; bytes a step equal), kernel H's launches a step
  from the trace (24: a front and a sweep a pass), no wrapper launch; the
  graph's nodes, capture seconds and pool bytes; replayed against eager
  timed (``sharded_graph.*.step.time``). Kernel H's front and sweep against
  their plain versions at the 65k sharded pass's own arguments
  (``check.gather_pairs.sharded``; the sweep within ``GATHER_TOL`` plus one
  ulp of the position), which are the kernel line's ``.sharded`` entries;
- ``spatial_1x1``: the 2D spatial layer (``parallel/``) on a one-rank mesh
  (a 1-rank NCCL group started in the process over an in-memory store; every
  halo a copy, no collective) at the 65,536-particle scene of bench.py's
  ``spatial_1x1_*`` keys (``build_handler(65536, spatial=True)``: one shared
  grid), against the dense handler on the same scene on its plane route
  (kernel D, the spatial step's summation order): three free-running
  steps, held after the first and the third within the step tolerances,
  and against the automatic fused route (kernel B) after the first within
  ``FUSED_TOL`` (its difference after the third printed); 60
  settle steps. The spatial handler's ``step_once``, ``run_steps`` and
  ``draw`` replay from its CUDA graphs (``parallel/spatial_graph.py``; the
  first call of each timed, ``spatial_graph.first_call``): each replayed
  against the eager route from one state (``spatial_graph.<unit>``: bit
  for bit, ``batch_pos_sum`` within ``STATS_RTOL``) over a block of
  ``run_steps`` that takes the rebin branch and one that does not
  (``CALM_DT`` steps), rebins from the device counter = the eager loop's,
  0 host reads of the rebin decision replayed, D (12 a step) and C (2 a
  draw) counted from the replay's profiler trace and no wrapper launch;
  the graphs' own calls under ``sync_errors``; each part's graph nodes,
  capture seconds and pool bytes (``spatial_graph.parts``); replayed
  against eager timed (wall and device ms, ``spatial_graph.*.time``);
  per-step time of ``run_steps`` blocks of the spatial handler, of its
  bare replayed resident steps and of the dense handler in turns (CUDA
  events, p50 and the blocks printed), the handler's host redistribute
  alone (host-clock ms a call, ``redistribute_ms``), one traced block of
  each handler; a draw.
  Kernel D against its plain version on the run's own local window (kept
  from one eager step) and on the windows of 2 x 2 and 4 x 2 layouts of
  the same grid cut from it (halo rows and lanes from the torus
  neighbours), windows 1 and 3, static and through the device flag; kernel
  C on a ``SpatialHandler.draw`` payload, alpha and rgb. D's and C's
  launches in the replayed resident steps and draw are their own entries
  of the kernel line (``.spatial_1x1``);
- ``scenarios``: the five baseline configs of ``BASELINE.json``
  (``egg_fluid_simulation_tpu_torch/scenarios.py``: configs 1, 2, 3, the
  three parameter extremes of 4, and 5, at the sizes, steps, targets and
  ``Path`` drive of ``tests/test_baseline_scenarios.py``) through
  ``update`` on the card (the step graph replayed: kernel H) and, for
  config 5, ``draw`` (the render graph replayed: kernel C). Each step is
  step-locked to the port on the CPU: the card runs free, and each of its
  steps is stepped again on the CPU from the card's snapshot (state,
  stats, episode state, accumulator) in ``SCENARIO_WORKERS`` processes;
  the host-decided fields bit for bit, pos / prev within ``REF_TOL`` px,
  vel within ``VEL_TOL``, or a rounding flip that
  ``utils/lockstep.explain`` names (the step replayed pass by pass on both
  devices, kernel H's front against the plain front: the particle whose
  cell differs, within 4 float32 steps of the border); config 5's frames
  against the CPU's draw of the card's state within 1e-4, the same
  boosts, 0 splats dropped, H and C counted in its trace. One line a
  config (steps, worst errors, flips, replayed ``update`` wall ms,
  ``validate_state``, drops), then the phase's seconds;
- ``dense_twins``: the main path, the dense engine's replayed ``update``
  and resident loop, step-locked to the port on the CPU at the bench's
  scenes (``scenarios.BENCH_SCENES``): ``DENSE_65K_STEPS`` updates of the
  65k spawn (the CPU twins in ``DENSE_WORKERS`` processes) and a draw at
  the bench's canvas viewport from one state on both sides, one replayed
  update of the 1M scene settled 120 steps (the CPU on every core), and
  ``DENSE_RESIDENT_STEPS`` replayed resident steps of the settled 65k
  scene, each from the card's carry. A step that parts past ``REF_TOL`` /
  ``VEL_TOL`` (or whose episode state differs) passes only where the dense
  rule of ``utils/lockstep.explain_dense`` explains it, from each side's
  step run again by its own code with its recorders (the CPU's bit for bit
  to the CPU's update, the card's eagerly within the pass tolerance of the
  replayed graph's output): each parting substep, rerun on the card from
  the CPU's input with its window, agrees at every slot within the pass
  tolerance plus twice that slot's own 1-ulp envelope (rounding a packed
  scene amplifies), and a window or rebin chosen on one side only comes
  from slots within a few float32 steps of the threshold. One line a
  scene (worst errors, substeps named rounding, flips, rebins, replayed
  wall, CPU seconds a step), one on where card and CPU part on one input
  (``arithmetic``: kernel B against its plain version, the plain version
  on card and CPU, ``torch.rsqrt``), then the phase's seconds;
- ``bench``: ``python bench_torch.py --quick`` (the port's bench,
  ``egg_fluid_simulation_tpu_torch/bench.py``, its 1M stages at 65,536
  particles) in a subprocess under ``BENCH_TIMEOUT_S``; it fails on a
  non-zero exit, a missing key of ``bench.py``'s set or of the port's, a
  non-finite number or a render drop, and prints the final line's keys
  beside the card's name and power limit.

Kernel H has no TPU counterpart (XLA fuses the JAX package's
``solve_pairs``); its three entry points are the kernel line's
``gather_front``, ``gather_count`` and ``gather_sweep``, with the gather
path's launches, and ``gather_front.sharded`` and ``gather_sweep.sharded``
with the sharded step's.
Kernel G (``splat_tiles``) has no caller on any path: it is checked alone
(``check.splat_tiles``) on slot-major candidates built from the 1M scene's
render payload. The kernel line gives, per kernel, its launches on its
path, its time and its plain version's, its bound on the card (``bound``)
and, where one PyTorch call computes the same function, that call's time.
A handler's fixed step is replayed from a CUDA graph, which runs its
launches without the wrappers, so the launches of a path that replays
(``main_path``, ``plane_path``, ``plane_modes``, ``gather_path``,
``sharded_graph``, ``spatial_1x1``) are counted in a ``torch.profiler`` trace of its run, by
kernel symbol
(``launches_run``); the wrappers' counters, which count the eager first
step and the capture, are printed beside them and must not be zero where
the run captured.

Every phase prints its own line; any failure raises, so the script exits
non-zero. Without a CUDA card it exits non-zero before doing anything. The
line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from egg_fluid_simulation_tpu_torch import bench as BENCH
from egg_fluid_simulation_tpu_torch.bench import build_handler, render_frame_fn
from egg_fluid_simulation_tpu_torch.utils.profiling import nvidia_smi

SEED = 0
N_WHITE = 1_000_000
MAIN_UPDATES = 3
N_WHITE_MODES = 65_536
MODE_STEPS = 2
N_WHITE_REF = 4096
REF_STEPS = 1               # card vs CPU: one step (a spawn explosion
                            # amplifies the ulp-level rounding
                            # differences of the two devices)
PLACE_TOL = 0.0             # bit-exact
SUBSTEP_TOL = 1e-4          # px
SWEEP_TOL = 1e-4            # px: D in its plain version's order; E adds
                            # with atomics in a run-dependent order
COUNT_TOL = 0.0             # bit-exact: small integers
CUM_EXACT = 2.0 ** 24       # FIELD_CUM, a float32 prefix of counts, is
                            # exact below this; the smoke fails at it
REF_TOL = 1e-3              # px after a few steps, card vs CPU (the CPU
                            # tests' tolerance against the JAX package)
SPLAT_TOL = 1e-4            # alpha: products taken in another order
COMPOSITE_TOL = 1e-5        # a channel: kernel I rounds each tap's product,
                            # the matrices' FMA chains do not (~1e-7)
GATHER_TOL = 1e-4           # px a pass: kernel H sums a particle's
                            # candidates in another order than its plain
                            # version (each pair's term rounds alike)
STRESS_TABLE = 16           # kernel H's check on a small hash table:
STRESS_SLOTS = 4            # repeated and crowded buckets
ODD_SLOTS = 12              # kernel H at a K it does not compile in (K
                            # read at run time)
STATS_RTOL = 1e-5           # batch_pos_sum, replayed vs eager step:
                            # index_add_ sums with atomics in any order
GRAPH_UNITS = 6             # updates (frames) a timed block, graph vs eager
GRAPH_BLOCKS = 4            # timed blocks of each, in turns
DRAW_ALPHAS = (0.25, 0.5, 0.875)    # draws replayed vs eager, then one
                                    # after an update
DRAW_TOL = 1e-6             # replayed vs eager draw: bit for bit expected
DRAW_UNITS = 6              # draws a timed block, replayed vs eager
TOP_KERNELS = 8             # kernels by device time in a traced block
DRAW_BLOCKS = 4
RESIDENT_STEPS = 20         # run_steps on the 1M scene
RESIDENT_FRAMES = 3         # multi_step_frames on the 1M scene
RESIDENT_REF_STEPS = 4      # run_steps of the calm 4k lattice, card vs CPU
RESIDENT_REF_FRAMES = 3     # multi_step_frames of the same, card vs CPU
GATHER_CAPACITY = 8192      # the top of the gather engine's range
GATHER_BATCHES = 8          # of 900 white + 90 yolk: ~8000 live particles
GATHER_UPDATES = 10         # update(1/60) calls of gather_path
GATHER_RESIDENT = 10        # run_steps of gather_path
DEMO_FRAMES = 60            # run_demo's session on the card
DEMO_DRAW_EVERY = 10
VEL_TOL = 0.2               # px/s, card vs CPU
N_SPATIAL = 65_536          # spatial_1x1: bench.py's spatial_1x1_* scene
SPATIAL_CHECK_STEPS = 3     # spatial vs dense step, free-running, held
                            # after 1 and 3
FUSED_TOL = 5e-3            # px: the spatial step against the dense
FUSED_VEL_TOL = 0.6         # handler's fused route (kernel B, another
                            # summation order) after one step: ~3x the
                            # 1.59e-3 px / 0.183 px/s read on an H100
SPATIAL_SETTLE = 60         # run_steps before timing (bench.py)
SPATIAL_BLOCKS = 4          # timed blocks per handler, in turns
SPATIAL_CHAIN = 10          # run_steps per timed block
SPATIAL_GRAPH_STEPS = 5     # run_steps of a replayed-vs-eager block
SHARDED_STEPS = 3           # chained sharded steps, replayed vs eager
SHARDED_TOL = (1e-5, 1e-4)  # rtol, atol px: the one-rank sharded step vs
                            # the single-device gather step (the dry run's)
ULP = 2.0 ** -23            # float32 rounding, relative: kernel H's sweep
                            # against its plain version on the 65k scene, whose
                            # positions pass 1024 px (an ulp there 1.2e-4),
                            # is held to GATHER_TOL + one ulp of the position
CALM_DT = 1e-4              # s: steps that drift too little to rebin (the
                            # block that does not take the branch)
BENCH_TIMEOUT_S = 420       # the quick bench's subprocess, start-up included

# Peak rates of one H100 SXM (vendor datasheet): HBM3 bytes/s and
# FP32 operations/s outside the tensor cores. A kernel's bound is the larger
# of its bytes (each input read once, each output written once) and its
# operations (what this run's data needs) over these.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per unit of work, counted from the kernels' sources:
PAIR_OPS = 36        # one (self, partner) term of pair_terms.cuh's
                     # projection with its accumulation (B, D, E)
PROLOGUE_OPS = 20    # kernel B's integrate + follow prologue, per slot
COUNT_OPS = 4        # kernel F: one partner's adjacency test and count
FRONT_OPS = 12       # kernel H's front, a particle: two divides, two
                     # floors, the hash's products, XOR, mask and select
SPLAT_OPS = 28       # kernel C: one candidate at one pixel, exp as one
COMPOSITE_OPS = 202  # kernel I's composite, a screen pixel on the canvas
                     # at a factor above 1: four samples of 36 (two rows of
                     # two taps and the column pass, four channels), the
                     # shift's 44, the blend's 14
UPSAMPLE_OPS = 9     # kernel I's upsample, a channel of an output pixel
SPLAT_BOX_OPS = 27   # kernel C: one window candidate's extent box against
                     # its tile (splat_kernel.extent_box and the four tests)
TILES_OPS = 26       # kernel G: the same with the normalised box test
TILES_CULL_OPS = 10  # kernel G: one candidate's box against the tile


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call of ``fn`` (CUDA events around ``reps`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn``, ``reps`` calls captured in one CUDA
    graph and replayed between CUDA events: the kernels' time without the
    host's launch cost between calls, which a kernel of a few tens of
    microseconds falls below (``cuda_ms`` would time the host). A wrapper's
    launch counter counts the captured calls once."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def window_pairs(occ, k: int, w: int) -> float:
    """(self, partner) terms between occupied slots of cells within +-w
    rows and columns on the torus: what a sweep over the (G, G*K) slots
    ``occ`` (> 0 = occupied) evaluates on this data."""
    import torch
    g = occ.shape[0]
    n = (occ > 0).reshape(g, -1, k).sum(-1).to(torch.float64)
    near = sum(torch.roll(n, (dy, dx), (0, 1))
               for dy in range(-w, w + 1) for dx in range(-w, w + 1))
    return float((n * near).sum() - n.sum())


# (G, K, fresh modulus; 0 = the grid's own G): grids a tile of kernels B, D
# and E does not divide, one smaller than a tile in both directions, and one
# whose fractional fresh modulus takes the general fresh-cell adjacency test
SWEEP_SHAPES = ((20, 3, 0.0), (33, 4, 0.0), (24, 1, 24.5), (40, 8, 0.0),
                (6, 2, 0.0))


# (G, K) of the ragged placement case: the grids of SWEEP_SHAPES, raised to
# the least grid the placement takes (2 * ROW_PAD = 16 rows, where the halo
# mirrors every real row)
PLACE_SHAPES = tuple((max(g, 16), k) for g, k, _ in SWEEP_SHAPES)


def place_shape_case(g: int, k: int, seed: int, cell: float = 8.0) -> dict:
    """Seeded numpy particles for kernel A on a (g, g*k) grid: about half as
    many particles as slots, uniform over the torus and a little beyond it
    (the wrap), three crowds of 3K + 5 in one cell each (over budget: in the
    first row, the last row and the middle), the last tenth inactive.
    Returns ``pos``, ``inv_mass``, ``radius``, ``batch``, ``active``, ``aux``
    (N, 5) and ``cell``."""
    rng = np.random.default_rng(seed)
    n = g * g * k // 2
    pos = rng.uniform(-0.5, g + 0.5, (n, 2)) * cell
    crowd = 3 * k + 5
    for j, c in enumerate(((0, 0), (g - 1, g - 1), (g // 2, g // 3))):
        pos[j * crowd:(j + 1) * crowd] = (
            np.array(c, np.float64) + rng.uniform(0.05, 0.95, (crowd, 2))) * cell
    active = np.ones(n, bool)
    active[n - n // 10:] = False
    return dict(pos=pos.astype(np.float32),
                inv_mass=rng.uniform(0.5, 1.5, n).astype(np.float32),
                radius=rng.uniform(2.0, 4.0, n).astype(np.float32),
                batch=rng.integers(0, 4, n).astype(np.int32), active=active,
                aux=rng.normal(size=(n, 5)).astype(np.float32),
                cell=np.float32(cell))


def sweep_shape_case(g: int, k: int, seed: int, fresh_mod: float = 0.0,
                     cell: float = 8.0) -> dict:
    """Seeded numpy inputs of kernels B, D and E on a (g, g*k) grid that a
    tile of the kernels does not divide: ``xy`` (2, g, L), ``stat``
    (4, g, L), ``prev``, ``follow`` (3, g, L), ``aux`` (4,) for B; ``planes``
    (8, g + 16, L) with its halo rows for D and E; ``params`` (8,) for all.

    About 60% of the slots are occupied and every slot of row 0, row g-1,
    lane 0 and lane L-1 is. Particles sit up to 0.4 cell outside their cell
    (a stale layout); about half of those in row 0 and in cell column 0 lie
    one grid period further on, next to row g-1 and column g-1, so pairs
    collide across the torus seam in both directions. A few particles
    coincide with their lane neighbour (the tie direction). Collision reaches
    about 1.4 cells, cohesion 1.7; the ordered cutoff ``max_pairs`` binds for
    half the slots; FIELD_OCC holds cell counts up to 2k (the boost clip)."""
    rng = np.random.default_rng(seed)
    lanes = g * k
    occ = rng.random((g, lanes)) < 0.6
    occ[0] = occ[-1] = True
    occ[:, 0] = occ[:, -1] = True
    row = np.broadcast_to(np.arange(g, dtype=np.float64)[:, None], occ.shape)
    col = np.broadcast_to((np.arange(lanes) // k).astype(np.float64)[None, :],
                          occ.shape)
    row = np.where((row == 0) & (rng.random(occ.shape) < 0.5), float(g), row)
    col = np.where((col == 0) & (rng.random(occ.shape) < 0.5), float(g), col)
    x = (col + rng.uniform(-0.4, 1.4, occ.shape)) * cell
    y = (row + rng.uniform(-0.4, 1.4, occ.shape)) * cell
    twin = (rng.random(occ.shape) < 0.05) & occ & np.roll(occ, 1, axis=1)
    twin[:, 0] = False
    x = np.where(twin, np.roll(x, 1, axis=1), x)
    y = np.where(twin, np.roll(y, 1, axis=1), y)
    idx = rng.permutation(g * lanes).reshape(g, lanes).astype(np.float64)
    cum = idx * 3.0 + rng.uniform(0.0, 2.0, occ.shape)
    fields = dict(
        x=x, y=y, w=rng.uniform(0.5, 1.5, occ.shape),
        r=rng.uniform(2.0, 3.5, occ.shape),
        batch=rng.integers(0, 3, occ.shape).astype(np.float64),
        cum=cum, idx=idx,
        count=rng.integers(1, 2 * k + 1, occ.shape).astype(np.float64),
        boost=rng.uniform(1.0, 2.0, occ.shape),
        px=x - rng.uniform(-1.0, 1.0, occ.shape),
        py=y - rng.uniform(-1.0, 1.0, occ.shape),
        tx=np.full(occ.shape, 0.5 * g * cell), ty=np.full(occ.shape, 0.4 * g * cell),
        td=np.full(occ.shape, 0.25 * g * cell))
    f = {n: np.where(occ, v, 0.0).astype(np.float32) for n, v in fields.items()}
    core = np.stack([f["x"], f["y"], f["w"], f["r"], f["batch"], f["cum"],
                     f["idx"], f["count"]])
    halo = (np.arange(g + 16) - 8) % g          # ROW_PAD = 8 rows each side
    max_pairs = float(np.median(f["cum"][occ]))
    return dict(
        xy=np.stack([f["x"], f["y"]]),
        stat=np.stack([f["w"], f["r"], f["batch"], f["boost"]]),
        prev=np.stack([f["px"], f["py"]]),
        follow=np.stack([f["tx"], f["ty"], f["td"]]),
        planes=np.ascontiguousarray(core[:, halo]),
        params=np.array([10.0, 50.0, 2.0, 2.5, max_pairs, cell, fresh_mod,
                         1.5], np.float32),
        aux=np.array([0.98, 0.02, 0.5, 0.0], np.float32))


def lattice_handler(device, **overrides):
    """A calm 4k scene: 4096 whites on a 17 px hex lattice and 400 yolks on
    a 25 px grid (collision and cohesion reach 16 px), seeded velocities of
    up to 120 px/s, the follow pull off (a dead zone wider than the scene).
    Cells hold at most a few particles, so the rotating winner hash never
    chooses and the card and the CPU bin alike. ``overrides`` replace
    solver options."""
    import torch
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                SolverOptions,
                                                default_white_config,
                                                default_yolk_config)
    options = SolverOptions(**{**dict(
        engine="dense", budget_mode="off", dense_rebin="step",
        dense_grid_dim=(160, 64), dense_slots=4, pop_caps=(4096, 1024)),
        **overrides})
    h = SimulationHandler(default_white_config(), default_yolk_config(),
                          capacity=4096, max_batches=4, options=options,
                          device=device)
    h.add_many([dict(x=600.0, y=600.0, white_radius=256.0, yolk_radius=16.0,
                     white_n_particles=2048, yolk_n_particles=200)] * 2)
    rng = np.random.RandomState(SEED)
    st = h.state
    pos, vel = st.pos.cpu().numpy().copy(), st.vel.cpu().numpy().copy()
    s = 17.0
    ij = np.stack(np.meshgrid(np.arange(64), np.arange(64)), -1).reshape(-1, 2)
    pos[0, :4096] = ij * s + 40.0 + (ij[:, 1:2] % 2) * np.array([s / 2, 0.0])
    ij = np.stack(np.meshgrid(np.arange(20), np.arange(20)), -1).reshape(-1, 2)
    pos[1, :400] = ij * 25.0 + 150.0
    vel[0, :4096] = rng.uniform(-120.0, 120.0, (4096, 2))
    vel[1, :400] = rng.uniform(-120.0, 120.0, (400, 2))
    p = torch.from_numpy(pos.astype(np.float32)).to(device)
    h._state = st.replace(
        pos=p, prev=p.clone(), last_pos=p.clone(),
        vel=torch.from_numpy(vel.astype(np.float32)).to(device),
        batch_radius=torch.full_like(st.batch_radius, 65536.0))
    return h


def gather_handler(device):
    """An automatic handler at capacity 8192 (the gather engine, the JAX
    handler's rule) with 8 batches of 900 white + 90 yolk on a 4 x 2 grid
    200 px apart, each spawned a little denser than the default area per
    particle (a mild spawn transient)."""
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                default_white_config,
                                                default_yolk_config)
    h = SimulationHandler(default_white_config(), default_yolk_config(),
                          capacity=GATHER_CAPACITY, max_batches=16,
                          device=device)
    h.add_many([dict(x=100.0 + 200.0 * (b % 4), y=150.0 + 300.0 * (b // 4),
                     white_radius=100.0, yolk_radius=30.0,
                     white_n_particles=900, yolk_n_particles=90)
                for b in range(GATHER_BATCHES)])
    return h


def default_scene(device):
    """The default 4k scene: ``SimulationHandler(cfg)`` (capacity 4096, the
    gather engine) with four default-sized batches at seeded places."""
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                default_white_config,
                                                default_yolk_config)
    h = SimulationHandler(default_white_config(), default_yolk_config(),
                          device=device)
    rng = np.random.RandomState(SEED)
    h.add_many([dict(x=float(x), y=float(y))
                for x, y in rng.uniform(100.0, 700.0, (4, 2))])
    return h


def traced(fn, n: int) -> dict:
    """One block of ``fn`` (``n`` units of work) under
    ``utils.profiling.trace``: device ms (sum of the CUDA kernel events),
    kernels and busy share per unit, and the wall time of the block."""
    import tempfile
    import torch
    from egg_fluid_simulation_tpu_torch.utils.profiling import trace
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return dict(device_ms=dev_ms / n, kernels=len(kernels) / n,
                gemm=sum("gemm" in e.name.lower() for e in kernels) / n,
                profiled_wall_ms=wall / n,
                busy_share=dev_ms / wall if wall else None,
                by_kernel=kernel_counts(prof),
                top=[dict(name=name[:80], ms=round(ms / n, 4),
                          launches=count / n)
                     for name, (ms, count) in top])


def node_types(raw: int) -> dict:
    """The top-level nodes of the CUDA graph ``raw`` by type
    (``utils.profiling.graph_node_types``)."""
    from egg_fluid_simulation_tpu_torch.utils.profiling import \
        graph_node_types
    return graph_node_types(raw)


def body_nodes(body):
    """:func:`node_types` of ``body`` captured a second time, kept as a
    graph (``keep_graph``): what one replay of its capture launches,
    counted without a profiler. None where this PyTorch cannot keep a
    captured graph."""
    import torch
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        return None
    with torch.cuda.graph(graph):
        body()
    out = node_types(graph.raw_cuda_graph())
    del graph
    return out


def graph_nodes(h):
    """The nodes of the handler's captured step by type (:func:`body_nodes`)."""
    return body_nodes(next(reversed(h._step_graphs._graphs.values()))._body)


def resident_nodes(h):
    """The nodes of the handler's newest resident loop by type: its step
    (or frame) graph (:func:`body_nodes`, one conditional node a
    population) and each population's rebin branch, the body of its IF
    node (a kept graph)."""
    rg = next(reversed(h._resident._graphs.values()))
    out = {"advance": body_nodes(lambda: rg._advance(cond=rg._if_node))}
    for i in range(2):
        out[f"rebin.{i}"] = node_types(
            rg._graphs[f"rebin.{i}"].raw_cuda_graph())
    return out


@contextlib.contextmanager
def eager_graphs(h):
    """The handler's fixed steps and renders (a ``SpatialHandler``'s steps,
    resident steps and draws) run eagerly inside the block (one launch per
    op, as before they were captured); its captured graphs are kept for
    after."""
    from egg_fluid_simulation_tpu_torch.ops.step_graph import EAGER
    from egg_fluid_simulation_tpu_torch.parallel.spatial_handler import (
        SpatialHandler)
    names = (("_spatial",) if isinstance(h, SpatialHandler)
             else ("_step_graphs", "_render_graphs"))
    saved = [getattr(h, n) for n in names]
    for n in names:
        setattr(h, n, EAGER)
    try:
        yield
    finally:
        for n, v in zip(names, saved):
            setattr(h, n, v)


def check_step_graph(h, phase: str, updates: int = 2) -> dict:
    """``update(1/60)`` through the handler's captured step against
    ``solver.step`` run eagerly from the same state, ``updates`` times:
    pos, prev, vel, last_pos, inv_mass, radius and the wide-gate state bit
    for bit; the stats bit for bit but ``batch_pos_sum``, which
    ``index_add_`` sums with atomics in any order (``STATS_RTOL``)."""
    import dataclasses
    import torch
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    cfg2 = h._device_cfg2()
    dt, relax = h._step_scalars(1 / 60)
    unequal, stats_err = set(), 0.0
    for _ in range(updates):
        s0, w0 = h.state, h._wide_or_init()
        want, want_stats, want_wide = S.step(s0, cfg2, dt, relax, h._options,
                                             wide_state=w0)
        h.update(1 / 60)
        got, got_stats = h.state, h.stats
        if not torch.equal(got.last_pos, s0.pos):
            raise AssertionError(f"{phase}: update(1/60) ran other than one "
                                 "step")
        for f in ("pos", "prev", "vel", "last_pos", "inv_mass", "radius"):
            if not torch.equal(getattr(got, f), getattr(want, f)):
                unequal.add(f)
        if [[int(v) for v in w] for w in h._wide_state] != \
                [[int(v) for v in w] for w in want_wide]:
            unequal.add("wide_state")
        for f in dataclasses.fields(want_stats):
            a, b = getattr(got_stats, f.name), getattr(want_stats, f.name)
            if f.name == "batch_pos_sum":
                stats_err = max(stats_err, float(
                    ((a - b).abs() / b.abs().clamp(min=1.0)).max()))
            elif not torch.equal(a, b):
                unequal.add(f.name)
    graphs = h._step_graphs
    out = dict(updates=updates, captures=graphs.captures if graphs else 0,
               unequal=sorted(unequal), batch_sum_rel_err=stats_err,
               tol=f"bit for bit; batch_pos_sum rtol {STATS_RTOL}")
    log(f"step_graph.{phase}", **out)
    if unequal or stats_err > STATS_RTOL or not out["captures"]:
        raise AssertionError(f"{phase}: the replayed step differs from the "
                             f"eager step ({sorted(unequal)}, batch sums "
                             f"{stats_err}) or nothing was captured")
    return out


def resident_snapshot(h):
    """The handler's state and wide-gate state, to start loops from."""
    return h.state, tuple(tuple(t.clone() for t in w)
                          for w in h._wide_or_init())


def resident_restore(h, snap) -> None:
    h._state = snap[0]
    h._wide_state = tuple(tuple(t.clone() for t in w) for w in snap[1])


def resident_unequal(a, b) -> tuple:
    """``(fields that differ, batch_pos_sum's relative error)`` of two
    ``(state, stats or None, wide_state)``: state and gate state bit for
    bit, the stats too but ``batch_pos_sum`` (``index_add_``'s atomics sum
    in any order: ``STATS_RTOL``)."""
    import dataclasses
    import torch
    unequal, err = set(), 0.0
    for f in ("pos", "prev", "vel", "last_pos", "inv_mass", "radius"):
        if not torch.equal(getattr(a[0], f), getattr(b[0], f)):
            unequal.add(f)
    if not all(torch.equal(x, y) for wa, wb in zip(a[2], b[2])
               for x, y in zip(wa, wb)):
        unequal.add("wide_state")
    if a[1] is not None:
        for f in dataclasses.fields(a[1]):
            x, y = getattr(a[1], f.name), getattr(b[1], f.name)
            if f.name == "batch_pos_sum":
                err = max(err, float(((x - y).abs()
                                      / y.abs().clamp(min=1.0)).max()))
            elif not torch.equal(x, y):
                unequal.add(f.name)
    return sorted(unequal), err


def resident_run(h, phase: str, unit, n: int, want) -> dict:
    """``unit()`` (``n`` resident steps or frames of handler ``h``) through
    the handler's resident graphs against the eager loop
    (:func:`eager_graphs`) from one state. The first call of the phase
    builds the graphs (warm-up, capture; its wall time is ``first_call_s``),
    the second replays them from the same start, traced, under
    ``step_graph.sync_errors`` (a read of the device raises there); the
    eager one reads the rebin flag on the host. Checked: replayed = eager
    (:func:`resident_unequal`), no host read and no wrapper launch in the
    replayed run, rebins from the device counter = the eager loop's, and
    the trace's launches ``want(rebins)``. ``unit`` returns ``(state,
    stats or None, wide_state, total or None)``."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.step_graph import sync_errors
    snap = resident_snapshot(h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    unit()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graphs = h._resident
    resident_restore(h, snap)
    S.host_syncs = 0
    before = graphs.rebins.clone()
    with launches_run() as run:
        with sync_errors():
            got = unit()
    rebins = (graphs.rebins - before).tolist()
    syncs = S.host_syncs
    resident_restore(h, snap)
    S.rebins[:] = [0, 0]
    S.host_syncs = 0
    with eager_graphs(h):
        want_out = unit()
    unequal, stats_err = resident_unequal(got, want_out)
    if got[3] is not None and not torch.equal(got[3], want_out[3]):
        unequal.append("total")
    launches, expected = run["trace"], want(sum(rebins))
    rg = next(reversed(graphs._graphs.values()))
    out = dict(units=n, first_call_s=round(first_s, 3),
               total=None if got[3] is None else float(got[3]),
               capture_s=round(rg.capture_seconds, 3),
               pool_bytes=rg.pool_bytes,
               final_step_captures=graphs.final.captures,
               rebins_device=rebins, rebins_eager=list(S.rebins),
               host_syncs_replayed=syncs, host_syncs_eager=S.host_syncs,
               unequal=unequal, batch_sum_rel_err=stats_err,
               launches=launches, expected=expected,
               wrapper_counts=run["wrappers"],
               graph_nodes=resident_nodes(h),
               tol=f"bit for bit; batch_pos_sum rtol {STATS_RTOL}")
    log(f"resident_graph.{phase}", **out)
    if (unequal or stats_err > STATS_RTOL or rebins != list(S.rebins)
            or syncs != 0 or any(run["wrappers"].values())
            or any(launches[k] != v for k, v in expected.items())):
        raise AssertionError(f"resident_graph.{phase}: the replayed loop "
                             f"differs from the eager one or ran otherwise "
                             f"than expected ({out})")
    return out


def resident_steps(h, phase: str, steps: int) -> dict:
    """``run_steps(steps)`` of ``h``, replayed against eager
    (:func:`resident_run`), then timed both ways (:func:`graph_vs_eager`,
    per step)."""
    per = h._options.n_substeps * h._options.n_collision_steps * 2

    def unit():
        h.run_steps(steps)
        return h.state, h.stats, h._wide_state, None
    out = resident_run(h, f"{phase}.steps", unit, steps,
                       lambda rebins: {"substep_pass": per * steps,
                                       "place_planes": 2 + 2 + rebins})
    out["time"] = graph_vs_eager(
        h, f"{phase}.steps", lambda: h.run_steps(steps), 1, GRAPH_BLOCKS,
        expect={"substep_pass": per * steps}, line="resident_graph")
    per_unit(f"{phase}.steps", out["time"], steps, "step")
    return out


def resident_frames(h, phase: str, frames: int, frame_fn) -> dict:
    """``multi_step_frames(frames, frame_fn)`` of ``h`` through its
    resident graphs, replayed against eager (:func:`resident_run`; the
    eager loop renders eagerly too), then timed both ways, per frame."""
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    per = h._options.n_substeps * h._options.n_collision_steps * 2
    cfg2 = h._device_cfg2()
    dt, relax = h._step_scalars(1 / 60)

    def unit():
        h._state, total, h._wide_state = S.multi_step_frames(
            h.state, cfg2, dt, relax, h._options, frames, frame_fn,
            wide_state=h._wide_or_init(), graphs=h._resident_graphs())
        return h.state, None, h._wide_state, total
    out = resident_run(h, f"{phase}.frames", unit, frames,
                       lambda rebins: {"substep_pass": per * frames,
                                       "place_planes": 2 + rebins,
                                       "splat": 2 * frames})
    out["time"] = graph_vs_eager(
        h, f"{phase}.frames", unit, 1, GRAPH_BLOCKS,
        expect={"substep_pass": per * frames, "splat": 2 * frames},
        line="resident_graph")
    per_unit(f"{phase}.frames", out["time"], frames, "frame")
    return out


def per_unit(phase: str, timed: dict, n: int, unit: str,
             line: str = "resident_graph") -> None:
    """A :func:`graph_vs_eager` reading of ``n``-step (or frame) calls, per
    step (or frame): wall p50, device ms, kernels, busy share."""
    log(f"{line}.{phase}.per_{unit}", **{
        mode: dict(wall_ms=round(timed[mode]["wall_p50_ms"] / n, 4),
                   device_ms=round(timed[mode]["device_ms"] / n, 4),
                   kernels=round(timed[mode]["kernels"] / n, 1),
                   busy_share=timed[mode]["busy_share"])
        for mode in ("replay", "eager")}, card=nvidia_smi())


def graph_vs_eager(h, phase: str, unit, n: int, blocks: int = 2,
                   expect=None, count_nodes: bool = False,
                   line: str = "step_graph", eager=None) -> dict:
    """``unit`` (an ``update``, a draw, or an ``update`` and a draw) of
    handler ``h`` with its fixed step and render replayed and run eagerly
    (:func:`eager_graphs`; ``eager``, a context manager factory, replaces
    it for a unit that is not a handler's), in alternating blocks of ``n``: host-clock wall
    ms a unit (around work that ends in ``torch.cuda.synchronize()``) and
    CUDA-event ms between the block's ends; then one traced block of each
    (device ms, kernels, the library's kernels by symbol and busy share a
    unit). With ``expect`` (launches a unit of kernels of the library, by
    name) the traced blocks are checked against it: a block whose trace
    holds fewer of them than the unit ran lost records, and is traced again
    (up to three blocks; each attempt is printed, ``trace_attempts``); with
    ``count_nodes`` the replayed step's graph nodes are counted beside
    (:func:`graph_nodes`). Logged as ``<line>.<phase>.time``."""
    import torch
    walls = {"replay": [], "eager": []}
    events = {"replay": [], "eager": []}
    eager = eager or (lambda: eager_graphs(h))

    def block(mode):
        ctx = eager() if mode == "eager" else contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            ev0.record()
            for _ in range(n):
                unit()
            ev1.record()
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3 / n)
            events[mode].append(ev0.elapsed_time(ev1) / n)

    for b in range(blocks):
        for mode in (("replay", "eager") if b % 2 == 0
                     else ("eager", "replay")):
            block(mode)
    out = {}
    for mode in ("replay", "eager"):
        ctx = eager() if mode == "eager" else contextlib.nullcontext()
        attempts = []
        with ctx:
            for _ in range(3 if expect else 1):
                prof = traced(lambda: [unit() for _ in range(n)], n)
                per_unit = {k: v / n for k, v in prof["by_kernel"].items()
                            if v}
                attempts.append(dict(
                    kernels=prof["kernels"],
                    device_ms=round(prof["device_ms"], 4),
                    **{k: per_unit.get(k, 0.0) for k in expect or ()}))
                if all(per_unit.get(k, 0.0) == v
                       for k, v in (expect or {}).items()):
                    break
        out[mode] = dict(
            wall_p50_ms=float(np.median(walls[mode])),
            wall_ms=[round(x, 3) for x in walls[mode]],
            event_ms=[round(x, 3) for x in events[mode]],
            device_ms=round(prof["device_ms"], 4),
            kernels=prof["kernels"], by_kernel=per_unit,
            busy_share=round(prof["busy_share"], 3))
        if expect:
            out[mode]["trace_attempts"] = attempts
    extra = {}
    if count_nodes:
        extra["graph_nodes"] = graph_nodes(h)
    log(f"{line}.{phase}.time", n=n, blocks=blocks, **out, **extra,
        eager_over_replay_wall=round(out["eager"]["wall_p50_ms"]
                                     / out["replay"]["wall_p50_ms"], 3),
        card=nvidia_smi())
    return out


def draw_outputs(h, viewport, check_overflow: bool = True):
    """One fresh ``draw``: (frame, white canvas, yolk canvas, audit)."""
    h._frames = None
    frame = h.draw(viewport=viewport, check_overflow=check_overflow)
    return (frame, *h._canvases, h._render_budget.audit)


def check_draw_graph(h, scene: str, viewport) -> dict:
    """``draw`` replayed from the handler's render graph
    (``ops/render_graph.py``) against ``draw`` rendered eagerly on the same
    state: frame, canvases and audit bit for bit (else the largest
    difference is printed, and beyond ``DRAW_TOL`` it fails) at the
    interpolation alphas ``DRAW_ALPHAS`` and after an ``update``. Then per
    draw, replayed and eager in alternating blocks (:func:`graph_vs_eager`:
    wall ms, device ms, kernels, kernel C's launches by symbol, which must
    be 2 a replayed draw), ``render.host_reads`` a draw with the audit and
    without (2 and 1), and the render graphs' memory pools."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import render as R
    graphs = h._renderers()            # made at the first draw otherwise
    unequal, worst, replayed = [], 0.0, []
    for case in (*DRAW_ALPHAS, "update"):
        if case == "update":
            h.update(1 / 60)
        else:
            h._interpolation_alpha = case
        # an audited draw may raise the budget hint, which makes the next
        # draw's options a new key: draw until one replays a capture
        for _ in range(3):
            before = graphs.captures
            replay = draw_outputs(h, viewport)
            if graphs.captures == before:
                break
        replayed.append(graphs.captures == before)
        with eager_graphs(h):
            eager = draw_outputs(h, viewport)
        for name, a, b in zip(("frame", "white", "yolk", "audit"), replay,
                              eager):
            if not torch.equal(a, b):
                unequal.append(f"{case}.{name}")
                worst = max(worst, float((a.double() - b.double()).abs()
                                         .max()))
    finite = bool(torch.isfinite(replay[0]).all())
    dropped = int(replay[3][:, 0].sum())
    out = dict(particles=h.get_n_particles(), viewport=viewport,
               canvas=[o.canvas_size for o in h._frame_options()],
               cases=[*DRAW_ALPHAS, "update"], replayed=replayed,
               unequal=unequal,
               max_abs_err=worst, tol=f"bit for bit, fails beyond {DRAW_TOL}",
               captures=graphs.captures, frame_finite=finite,
               render_dropped=dropped)
    log(f"draw_graph.{scene}", **out)
    if (worst > DRAW_TOL or not finite or dropped or not graphs.captures
            or not all(replayed)):
        raise AssertionError(f"draw_graph.{scene}: the replayed draw differs "
                             f"from the eager draw ({unequal}, {worst}), is "
                             f"not finite, dropped {dropped} or was not "
                             f"replayed ({replayed})")

    def unit(check_overflow=True):
        draw_outputs(h, viewport, check_overflow)

    # kernel I: a composite a population, an upsample a raw canvas that
    # was evaluated below the canvas size
    expect = {"splat": 2, "composite": 2,
              "upsample": sum(o.downsample > 1 for o in h._frame_options())}
    timed = graph_vs_eager(h, f"{scene}.draw", unit, DRAW_UNITS, DRAW_BLOCKS,
                           expect=expect, line="draw_graph")
    # where a replayed draw's device time goes, kernel by kernel
    prof = traced(lambda: [unit() for _ in range(DRAW_UNITS)], DRAW_UNITS)
    top = prof["top"]
    reads = {}
    for audit in (True, False):
        R.host_reads = 0
        for _ in range(DRAW_UNITS):
            unit(audit)
        reads["audit" if audit else "no_audit"] = R.host_reads / DRAW_UNITS
    pools = [dict(canvas=[o.canvas_size for o in g.static["opts2"]],
                  K=[o.tile_capacity for o in g.static["opts2"]],
                  bytes=g.pool_bytes)
             for g in graphs._graphs.values()]
    splats = timed["replay"]["by_kernel"].get("splat", 0.0)
    replayed = {k: timed["replay"]["by_kernel"].get(k, 0.0) for k in expect}
    log(f"draw_graph.{scene}.reads", host_reads_per_draw=reads,
        splat_per_replayed_draw=splats, launches_per_replayed_draw=replayed,
        expected_launches=expect, gemm_per_draw=prof["gemm"],
        graphs=len(graphs._graphs),
        max_graphs=graphs.MAX_GRAPHS, pool_bytes=pools,
        pool_bytes_total=graphs.pool_bytes(), top_kernels_per_draw=top,
        card=nvidia_smi())
    if (reads != {"audit": 2.0, "no_audit": 1.0} or replayed != expect
            or prof["gemm"]):
        raise AssertionError(f"draw_graph.{scene}: host reads {reads} a draw "
                             f"(2 with the audit, 1 without expected), "
                             f"launches {replayed} a replayed draw ({expect}), "
                             f"{prof['gemm']} GEMMs a draw (none)")
    return dict(out, reads=reads, time=timed, pools=pools)


def overflow_handler(dev):
    """``tests/test_overflow.py``'s clustered scene with 300 white particles
    in the cluster (its 400 crowd one bin past the budget's cap of 256),
    stepped once: a dense cluster in a huge AABB, whose first draw
    overflows the budget sized from the AABB's mean density."""
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                SolverOptions,
                                                default_white_config,
                                                default_yolk_config)
    h = SimulationHandler(
        default_white_config(), default_yolk_config(), capacity=1024,
        max_batches=8, canvas_size=1024, device=dev,
        options=SolverOptions(engine="dense", budget_mode="off",
                              dense_rebin="step", dense_grid_dim=32,
                              dense_slots=8, adaptive_rebin=False))
    h.add(200.0, 200.0, 20.0, 8.0, None, None, 300, 20)
    h.add(5000.0, 5000.0, 8.0, 4.0, None, None, 10, 3)
    h.step_once()
    return h


def check_draw_overflow(dev) -> dict:
    """The overflow path of ``draw`` on the card: the clustered scene's
    first draw overflows, the audit bumps the budget (a new render key:
    an eager render and a capture) and the re-render drops nothing; the
    next draw replays with nothing dropped; the same draw run eagerly from
    the same budget state gives the same frame, canvases, audit and boost."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import render as R
    h = overflow_handler(dev)
    viewport = (0, 0, 256, 256)
    R.host_reads = 0
    first = draw_outputs(h, viewport)
    reads_first = R.host_reads
    boost = list(h._render_budget.k_boost)
    captures = h._render_graphs.captures
    R.host_reads = 0
    again = draw_outputs(h, viewport)
    reads_again = R.host_reads
    h._render_budget.k_boost = [1.0, 1.0]
    h._render_budget.peak_density = [None, None]
    with eager_graphs(h):
        eager = draw_outputs(h, viewport)
    # the first draw's renders were eager (the first of each key); the
    # second replays: both against the eager draw
    unequal = [f"{which}.{name}" for which, got in (("first", first),
                                                    ("again", again))
               for name, a, b in zip(("frame", "white", "yolk", "audit"),
                                     got, eager)
               if not torch.equal(a, b)]
    out = dict(boost=boost, eager_boost=list(h._render_budget.k_boost),
               captures=captures, captures_after=h._render_graphs.captures,
               host_reads_first=reads_first, host_reads_again=reads_again,
               dropped_first=first[3][:, 0].tolist(),
               dropped_again=again[3][:, 0].tolist(),
               peak_bin=first[3][:, 1].tolist(), unequal=unequal)
    log("draw_graph.overflow", **out)
    if not (max(boost) > 1.0 and boost == out["eager_boost"]
            and captures == 2 == out["captures_after"]
            and reads_first == 4 and reads_again == 2
            and sum(out["dropped_first"]) == sum(out["dropped_again"]) == 0
            and not unequal):
        raise AssertionError(f"draw_graph.overflow: {out}")
    return out


def state_err(a: dict, b: dict) -> dict:
    """Max abs difference of two host views' pos, prev, vel."""
    return {f: float(np.abs(a[f] - b[f]).max()) for f in ("pos", "prev", "vel")}


def population_inputs(h, pop: int, vel_seed: int):
    """Per-population step inputs of the handler's current state, with a
    seeded random velocity field so integration has work to do."""
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    st, opts = h.state, h._options
    dev = st.device
    cap = opts.pop_caps[pop]
    g, k = opts.dense_grid_dim[pop], opts.dense_slots[pop]
    cfg = population_config(h._device_cfg2(), pop)
    act = st.active_mask()[pop, :cap]
    pos = st.pos[pop, :cap]
    gen = torch.Generator(device=dev).manual_seed(vel_seed)
    vel = (torch.rand(pos.shape, generator=gen, device=dev) - 0.5) * 40.0
    mass = cfg.min_mass * (1 - st.mass_t[pop, :cap]) + cfg.max_mass * st.mass_t[pop, :cap]
    inv_mass = torch.where(act, 1.0 / torch.clamp(mass, min=1e-12), 0.0)
    radius = torch.where(act, st.radius[pop, :cap], 0.0)
    sub_dt = torch.tensor((1 / 60) / opts.n_substeps, dtype=torch.float32,
                          device=dev)
    cell_size, params = S._dense_params(
        cfg, act, S.strength_to_compliance(cfg.collision_strength, sub_dt),
        S.strength_to_compliance(cfg.cohesion_strength, sub_dt), opts)
    table = torch.cat([st.batch_target,
                       torch.sqrt(torch.clamp(st.batch_radius[pop], min=0.0))[:, None]], 1)
    rows3 = S.take_batch_rows(table, st.batch_slot[pop, :cap])
    aux = torch.stack([1.0 - torch.clamp(cfg.damping, 0.0, 1.0),
                       S.strength_to_compliance(cfg.follow_strength, sub_dt),
                       torch.tensor(1.0, device=dev),
                       torch.tensor(0.0, device=dev)]).to(torch.float32)
    return dict(pos=pos, vel=vel, inv_mass=inv_mass, radius=radius,
                batch=st.batch_slot[pop, :cap], act=act, cell_size=cell_size,
                params=params.pack(dev), aux=aux, tx=rows3[:, 0],
                ty=rows3[:, 1], td=2.0 * rows3[:, 2], sub_dt=sub_dt, g=g, k=k)


def on_stale_memory(fn, shape, dev):
    """``fn()`` with the caching allocator's next block of ``shape`` float32
    elements full of NaN: a kernel that leaves an element of an output it
    allocates with ``torch.empty`` unwritten shows it."""
    import torch
    stale = torch.full(shape, float("nan"), dtype=torch.float32, device=dev)
    del stale
    return fn()


def check_place(h, results) -> None:
    """Kernel A on the rotating-winner binning of both populations of the 1M
    scene (the fused path's inputs), bit-exact against its plain version on
    an output whose memory held NaN, and the whole binning against the
    golden scatter branch; timed beside its library yardstick."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    for pop, name in ((0, "white"), (1, "yolk")):
        p = population_inputs(h, pop, SEED + pop)
        aux_cols = torch.stack([p["pos"][:, 0] - p["sub_dt"] * p["vel"][:, 0],
                                p["pos"][:, 1] - p["sub_dt"] * p["vel"][:, 1],
                                p["tx"], p["ty"], p["td"]], dim=1)
        slot_sorted, pidx_sorted, _, pack, cell_sorted = D.sort_bin(
            p["pos"], p["inv_mass"], p["radius"], p["batch"], p["act"],
            p["cell_size"], grid_dim=p["g"], slots_per_cell=p["k"],
            aux_cols=aux_cols, rotate=True)
        args = (cell_sorted, slot_sorted, pidx_sorted, pack, p["g"], p["k"])
        want = PK.place_planes_plain(*args)
        got = on_stale_memory(lambda: PK.place_planes(*args), want.shape,
                              want.device)
        err = float((got - want).abs().max())
        exact = bool(torch.equal(got, want))
        # and the whole binning against the golden scatter branch
        gold = S._bin_components(p["pos"], p["vel"], p["inv_mass"], p["radius"],
                                 p["batch"], p["act"], p["cell_size"], p["tx"],
                                 p["ty"], p["td"], p["sub_dt"], p["g"], p["k"],
                                 use_placement=False)
        kern = S._bin_components(p["pos"], p["vel"], p["inv_mass"], p["radius"],
                                 p["batch"], p["act"], p["cell_size"], p["tx"],
                                 p["ty"], p["td"], p["sub_dt"], p["g"], p["k"])
        golden_exact = all(torch.equal(a, b) for a, b in zip(gold, kern))
        ms = graph_ms(lambda: PK.place_planes(*args), 20)
        host_ms = cuda_ms(lambda: PK.place_planes(*args), 20)
        plain_ms = cuda_ms(lambda: PK.place_planes_plain(*args), 20)
        # library yardstick, the same work as A: a zero fill, one
        # index_copy_ of the placed rows into the core rows, the halo fill
        # (the rows come pre-gathered, which A does itself)
        lanes = p["g"] * p["k"]
        ok = (slot_sorted >= 0) & (slot_sorted < p["g"] * lanes)
        idx = slot_sorted[ok] + D.ROW_PAD * lanes
        src = pack[pidx_sorted[ok]].T
        n_f, rows = got.shape[0], got.shape[1]

        def library_call():
            flat = torch.zeros((n_f, rows * lanes), device=got.device)
            flat.index_copy_(1, idx, src)
            return D.fill_halo(flat.view(n_f, rows, lanes))

        lib_ms = graph_ms(library_call, 20)
        lib_exact = bool(torch.equal(library_call(), want))
        # bytes: the slots, the particle indices and the payload rows read
        # once, the planes written once (the cell ids are only searched)
        b_ms, b_by = bound(0.0, nbytes(slot_sorted, pidx_sorted, pack, got))
        log("check.place_planes", pop=name, G=p["g"], K=p["k"],
            N=int(pack.shape[0]), F=int(pack.shape[1]),
            placed=int(ok.sum()), max_abs_err=err, bit_exact=exact,
            golden_bit_exact=golden_exact, library_bit_exact=lib_exact,
            ms=round(ms, 4), launched_one_by_one_ms=round(host_ms, 4),
            plain_ms=round(plain_ms, 4),
            library_ms=round(lib_ms, 4), bound_ms=round(b_ms, 4),
            bound_by=b_by)
        if not (exact and golden_exact and lib_exact and err <= PLACE_TOL):
            raise AssertionError(f"place_planes not bit-exact ({name})")
        r = results.setdefault("place_planes", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if pop == 0:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms)


def check_place_shapes(dev, results) -> None:
    """Kernel A against its plain version, and the placement binning against
    the golden scatter branch, at the ragged grids of ``PLACE_SHAPES``
    (``place_shape_case``: K = 1 to 8, chunks that straddle row ends, G =
    2*ROW_PAD, crowds past K in the first, last and a middle row, an
    inactive tail), with the rotating winners and the ordered layout; the
    kernel's output memory held NaN."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    for g, k in PLACE_SHAPES:
        c = {n: torch.from_numpy(np.asarray(v)).to(dev)
             for n, v in place_shape_case(g, k, SEED + g).items()}
        inputs = [c[n] for n in ("pos", "inv_mass", "radius", "batch",
                                 "active", "cell")]
        worst, golden_exact, over = 0.0, True, 0
        for rotate in (True, False):
            slot_sorted, pidx_sorted, _, pack, cell_sorted = D.sort_bin(
                *inputs, grid_dim=g, slots_per_cell=k, aux_cols=c["aux"],
                rotate=rotate)
            args = (cell_sorted, slot_sorted, pidx_sorted, pack, g, k)
            want = PK.place_planes_plain(*args)
            got = on_stale_memory(lambda: PK.place_planes(*args), want.shape,
                                  dev)
            worst = max(worst, float(torch.nan_to_num(
                (got - want).abs(), nan=float("inf")).max()))
            gold = D.bin_to_planes(*inputs, grid_dim=g, slots_per_cell=k,
                                   aux_cols=c["aux"], rotate=rotate)
            kern = D.bin_to_planes(*inputs, grid_dim=g, slots_per_cell=k,
                                   aux_cols=c["aux"], rotate=rotate,
                                   use_placement=True)
            golden_exact &= (torch.equal(gold.planes, kern.planes)
                             and torch.equal(gold.aux, kern.aux))
            over = int((slot_sorted == g * g * k).sum())
        torch.cuda.synchronize()
        log("check.place_shapes", G=g, K=k, lanes=g * k,
            N=int(pack.shape[0]), unplaced=over, max_abs_err=worst,
            golden_bit_exact=golden_exact)
        if not (worst <= PLACE_TOL and golden_exact):
            raise AssertionError(f"place_planes disagrees with its plain "
                                 f"version at G={g}, K={k}")
        r = results["place_planes"]
        r["max_abs_err"] = max(r["max_abs_err"], worst)


def check_substep(h, results) -> None:
    """Kernel B against its plain version on both populations of the 1M
    scene (white G=768, ~42% of the slots occupied; yolk G=512, ~10%), each
    timed."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    for pop, name in ((0, "white"), (1, "yolk")):
        p = population_inputs(h, pop, SEED + pop)
        xy, prev, stat, follow, _ = S._bin_components(
            p["pos"], p["vel"], p["inv_mass"], p["radius"], p["batch"],
            p["act"], p["cell_size"], p["tx"], p["ty"], p["td"], p["sub_dt"],
            p["g"], p["k"])
        # start the plain passes from a state one integrating pass in, so the
        # pair terms see moved particles
        xy1, prev1 = SK.substep_pass_plain(xy, stat, p["params"], p["aux"],
                                           p["k"], cohesion=True, prev=prev,
                                           follow=follow, integrate=True)
        occupied = float((stat[3] > 0).sum())
        for window, integrate in ((1, True), (1, False), (3, True), (3, False)):
            kw = dict(cohesion=True, window=window, fresh_mask=window == 3,
                      integrate=integrate)
            if integrate:
                args = (xy, stat, p["params"], p["aux"], p["k"])
                kw.update(prev=prev, follow=follow)
            else:
                args = (xy1, stat, p["params"], p["aux"], p["k"])
            got = SK.substep_pass(*args, **kw)
            want = SK.substep_pass_plain(*args, **kw)
            if integrate:
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            else:
                err = float((got - want).abs().max())
            ms = cuda_ms(lambda: SK.substep_pass(*args, **kw), 10)
            plain_ms = cuda_ms(lambda: SK.substep_pass_plain(*args, **kw), 2)
            # the device-flag form of the gate selects the same window
            flag = torch.tensor(window == 3, device=xy.device)
            kw_flag = {k_: v for k_, v in kw.items()
                       if k_ not in ("window", "fresh_mask")}
            got_flag = SK.substep_pass(*args, wide=flag, **kw_flag)
            same_flag = all(torch.equal(a, b) for a, b in
                            zip(got if integrate else [got],
                                got_flag if integrate else [got_flag]))
            flag_ms = cuda_ms(lambda: SK.substep_pass(*args, wide=flag,
                                                      **kw_flag), 10)
            log("check.substep_pass", pop=name, G=p["g"], K=p["k"],
                occupied=int(occupied), window=window,
                fresh_mask=window == 3, integrate=integrate, max_abs_err=err,
                tol=SUBSTEP_TOL, device_flag_same=same_flag, ms=round(ms, 4),
                device_flag_ms=round(flag_ms, 4), plain_ms=round(plain_ms, 4))
            if not (err <= SUBSTEP_TOL and same_flag):
                raise AssertionError("substep_pass disagrees with its plain "
                                     "version")
            r = results.setdefault("substep_pass", dict(max_abs_err=0.0))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if pop == 0 and (window, integrate) == (1, True):
                # the function needs the prologue once per occupied slot
                ops = (window_pairs(stat[3], p["k"], 1) * PAIR_OPS
                       + occupied * PROLOGUE_OPS)
                b_ms, b_by = bound(ops, nbytes(xy, stat, prev, follow, *got))
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)


def check_sweep_shapes(dev, results) -> None:
    """Kernels B, D, E and F against their plain versions (and E against D)
    on small grids that a tile of the kernels does not divide, with occupied
    edges and pairs that collide across the torus seam
    (``sweep_shape_case``): windows 1 and 3 (fresh mask), B with and without
    ``integrate``, D and E with and without the ordered cutoff, each through
    the static window and the device flag; F (window 1 only) on an output
    whose memory held NaN."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    for g, k, fresh_mod in SWEEP_SHAPES:
        c = {n: torch.from_numpy(v).to(dev)
             for n, v in sweep_shape_case(g, k, SEED + g, fresh_mod).items()}
        worst = dict(B=0.0, D=0.0, E=0.0, E_vs_D=0.0)
        # kernel F on the same planes, its output memory holding NaN
        want_f = SK.count_planes_plain(c["planes"], k)
        got_f = on_stale_memory(lambda: SK.count_planes(c["planes"], k),
                                want_f.shape, dev)
        worst["F"] = float(torch.nan_to_num((got_f - want_f).abs(),
                                            nan=float("inf")).max())
        moved = []
        for window in (1, 3):
            static = dict(window=window, fresh_mask=window == 3)
            flag = dict(wide=torch.tensor(window == 3, device=dev))
            for integrate in (True, False):
                kw = dict(cohesion=True, integrate=integrate)
                if integrate:
                    kw.update(prev=c["prev"], follow=c["follow"])
                args = (c["xy"], c["stat"], c["params"], c["aux"], k)
                want = SK.substep_pass_plain(*args, **kw, **static)
                moved.append(float(((want[0] if integrate else want)
                                    - c["xy"]).abs().max()))
                for gate in (static, flag):
                    got = SK.substep_pass(*args, **kw, **gate)
                    worst["B"] = max([worst["B"]] + [
                        float((a - b).abs().max()) for a, b in
                        zip(got if integrate else [got],
                            want if integrate else [want])])
            for ordered in (True, False):
                kw = dict(cohesion=True, ordered_budget=ordered)
                want = SK.sweep_planes_plain(c["planes"], c["params"], k,
                                             **kw, **static)
                moved.append(float(want.abs().max()))
                want_sym = SK.sweep_planes_sym_plain(c["planes"], c["params"],
                                                     k, **kw, **static)
                for gate in (static, flag):
                    got = SK.sweep_planes(c["planes"], c["params"], k, **kw,
                                          **gate)
                    worst["D"] = max(worst["D"],
                                     float((got - want).abs().max()))
                    sym = SK.sweep_planes(c["planes"], c["params"], k,
                                          symmetric=True, **kw, **gate)
                    worst["E"] = max(worst["E"],
                                     float((sym - want_sym).abs().max()))
                    worst["E_vs_D"] = max(worst["E_vs_D"],
                                          float((sym - got).abs().max()))
        torch.cuda.synchronize()
        log("check.sweep_shapes", G=g, K=k, lanes=g * k, fresh_mod=fresh_mod,
            occupied=int((c["stat"][3] > 0).sum()),
            substep_pass_max_abs_err=worst["B"],
            sweep_planes_max_abs_err=worst["D"],
            sweep_planes_sym_max_abs_err=worst["E"],
            sym_vs_one_sided=worst["E_vs_D"], tol=SWEEP_TOL,
            count_planes_max_abs_err=worst["F"], count_tol=COUNT_TOL,
            pairs_counted=int(want_f.to(torch.float64).sum()),
            least_correction_px=round(min(moved), 4))
        if not (worst["B"] <= SUBSTEP_TOL
                and max(worst["D"], worst["E"], worst["E_vs_D"]) <= SWEEP_TOL
                and worst["F"] <= COUNT_TOL and float(want_f.max()) > 0.0
                and min(moved) > 0.0):
            raise AssertionError(f"sweep kernels disagree with their plain "
                                 f"versions at G={g}, K={k}")
        for n, e in (("substep_pass", worst["B"]), ("sweep_planes", worst["D"]),
                     ("sweep_planes_sym", worst["E"]),
                     ("count_planes", worst["F"])):
            results[n]["max_abs_err"] = max(results[n]["max_abs_err"], e)


def splat_case(h, pop: int, post_mode: str, use_rgb: bool):
    """Kernel C's inputs from the handler's current state: the render
    payload, its audit and the per-bin counts of population ``pop`` at the
    handler's render options with ``post_mode`` and seeded particle colours
    (``use_rgb``). Returns (payload, counts, opts, audit)."""
    import dataclasses
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import render as R
    st = h.state
    dev = st.device
    cap = h._options.pop_caps[pop]
    cfg = population_config(h._device_cfg2(), pop)
    gen = torch.Generator(device=dev).manual_seed(SEED + pop)
    color = torch.cat([torch.rand((cap, 3), generator=gen, device=dev),
                       torch.ones((cap, 1), device=dev)], 1)
    opts = dataclasses.replace(h._frame_options()[pop], post_mode=post_mode,
                               use_particle_color=use_rgb)
    payload, audit, counts = R._splat_payload(
        st.pos[pop, :cap], st.last_pos[pop, :cap], st.vel[pop, :cap],
        st.radius[pop, :cap], color, st.active_mask()[pop, :cap],
        h.stats.centroid[pop], torch.tensor(0.5, device=dev),
        cfg.texture_scale, cfg.motion_blur, opts)
    return payload, counts, opts, audit


def check_path_splat(h, phase: str, results) -> None:
    """Kernel C against its plain version on the inputs ``draw`` gives it at
    the handler's current state: each population's payload at the frame's
    render options (budget boost included), with the state's colours, the
    interpolation alpha and the interpolated centroid. Alpha as the frame
    draws it (rgb when the handler accumulates particle colour), then once
    more with rgb on the state's colours (the demo's per-batch yolk
    colours). Raises on a disagreement beyond ``SPLAT_TOL``."""
    import dataclasses
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    st, stats = h.state, h.stats
    a = torch.tensor(h.interpolation_alpha, dtype=torch.float32,
                     device=st.device)
    active = st.active_mask()
    opts2 = h._frame_options()
    errs = {}
    for pop, name in ((0, "white"), (1, "yolk")):
        cap = min(h._options.pop_caps[pop], st.capacity)
        cfg = population_config(h._device_cfg2(), pop)
        frame_opts = opts2[pop]
        center = (stats.last_centroid[pop]
                  + (stats.centroid[pop] - stats.last_centroid[pop]) * a)
        for use_rgb in sorted({frame_opts.use_particle_color, True}):
            opts = dataclasses.replace(frame_opts, use_particle_color=use_rgb)
            payload, audit, counts = R._splat_payload(
                st.pos[pop, :cap], st.last_pos[pop, :cap], st.vel[pop, :cap],
                st.radius[pop, :cap], st.color[pop, :cap], active[pop, :cap],
                center, a, cfg.texture_scale, cfg.motion_blur, opts)
            got = SPK.splat(payload, counts, opts, use_rgb)
            want = SPK.splat_plain(payload, counts, opts, use_rgb)
            err = float((got[0] - want[0]).abs().max())
            if use_rgb:
                err = max(err, float((got[1] - want[1]).abs().max()))
            errs[f"{name}{'.rgb' if use_rgb else ''}"] = err
            if not (err <= SPLAT_TOL and int(audit[0]) == 0
                    and float(want[0].max()) > 0.0):
                raise AssertionError(
                    f"{phase}: splat disagrees with its plain version "
                    f"({name}, rgb={use_rgb}, err {err}, dropped "
                    f"{int(audit[0])})")
    log(f"check.splat.{phase}", canvas=[o.canvas_size for o in opts2],
        tile=[f"{o.tile_h}x{o.tile_w}" for o in opts2],
        K=[o.tile_capacity for o in opts2], post_mode=opts2[0].post_mode,
        max_abs_err=errs, tol=SPLAT_TOL)
    r = results.setdefault("splat", dict(max_abs_err=0.0))
    r["max_abs_err"] = max([r["max_abs_err"], *errs.values()])


def gather_pass_inputs(h, pop: int, table_size: int = 0, slots: int = 0):
    """One collision pass's inputs of population ``pop`` at the handler's
    state, as ``solver.substep`` gives them to ``solve_pairs`` at
    ``update(1/60)``: fields, config, compliances at the substep's dt; the
    pass's record, bucket and slot table as ``solve_pairs`` builds them (kernel H's front on the card; ``hgrid`` is the table with
    the record's cells); and ``grid``, ``build_grid``'s plain build of the
    same table. ``table_size`` / ``slots`` replace the handler's."""
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import grid as G
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    st, opts = h.state, h._options
    ts = table_size or opts.table_size
    k = slots or opts.slots_per_cell
    cap = S._pop_caps(opts, st.capacity)[pop]
    cfg = population_config(h._device_cfg2(), pop)
    dt, relax = h._step_scalars(1 / 60)
    sub_dt = torch.clamp(dt / opts.n_substeps, min=1e-8)
    act = st.active_mask()[pop, :cap]
    cell = torch.clamp(cfg.max_radius
                       * torch.maximum(cfg.collision_overlap_factor,
                                       cfg.cohesion_interaction_distance_factor),
                       min=1.0)
    pos = st.pos[pop, :cap].contiguous()
    fields = dict(pos=pos, inv_mass=st.inv_mass[pop, :cap].contiguous(),
                  radius=st.radius[pop, :cap].contiguous(),
                  batch_slot=st.batch_slot[pop, :cap].contiguous(),
                  active=act)
    record, bucket = GK.gather_front(*fields.values(), cell, ts)
    table = G.slot_table(bucket, ts, k)
    return dict(**fields, cell=cell, record=record, bucket=bucket,
                table_size=ts,
                hgrid=G.CellGrid(table=table, cell_xy=GK.record_cells(record),
                                 table_size=ts),
                grid=G.build_grid(pos, act, cell, table_size=ts,
                                  slots_per_cell=k),
                cfg=cfg, relaxation=relax,
                collision_c=S.strength_to_compliance(cfg.collision_strength,
                                                     sub_dt),
                cohesion_c=S.strength_to_compliance(cfg.cohesion_strength,
                                                    sub_dt))


def front_exact(d) -> dict:
    """Kernel H's front on the card against the plain build, bit for bit:
    the record's cells against ``build_grid``'s ``cell_xy`` and the plain
    front's, its bucket against ``grid.cells_and_buckets``'s, the slot
    table of its buckets against ``build_grid``'s, the record's other
    fields against their inputs (as int32 bits: an int field's bits may
    read as a float NaN) and the whole record against
    ``gather_front_plain``'s."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import grid as G
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    rec, bits = d["record"], d["record"].view(torch.int32)
    cells, bucket = G.cells_and_buckets(d["pos"], d["active"], d["cell"],
                                        d["table_size"])
    plain, plain_bucket = GK.gather_front_plain(
        d["pos"], d["inv_mass"], d["radius"], d["batch_slot"], d["active"],
        d["cell"], d["table_size"])

    def same_bits(a, b):
        return bool(torch.equal(a.contiguous().view(torch.int32),
                                b.contiguous().view(torch.int32)))

    return dict(
        cells=bool(torch.equal(GK.record_cells(rec), d["grid"].cell_xy)
                   and torch.equal(GK.record_cells(rec), cells)),
        bucket=bool(torch.equal(d["bucket"], bucket)
                    and torch.equal(d["bucket"], plain_bucket)),
        table=bool(torch.equal(d["hgrid"].table, d["grid"].table)),
        fields=all(same_bits(rec[:, i], f) for i, f in enumerate(
            (d["pos"][:, 0], d["pos"][:, 1], d["inv_mass"], d["radius"])))
        and bool(torch.equal(bits[:, 6], d["batch_slot"])
                 and torch.equal(bits[:, 7], d["active"].to(torch.int32))),
        record=same_bits(rec, plain))


def check_gather_pairs(h, phase: str, results) -> None:
    """Kernel H (``csrc/gather_pairs.cu``) against its plain versions on the
    inputs of one collision pass at the handler's state, both populations:
    the front (record, bucket; bit for bit, :func:`front_exact`); the count
    (bit for bit) and the sweep (within ``GATHER_TOL``: the candidate sums
    run in another order) at the handler's options (ordered budget, spacing
    cohesion) and with the budget off; then where the scene's own pass
    leaves branches idle: the budget set to half the pass's pairs (it
    binds), the literal cohesion mode, a grid of the same positions with
    ``STRESS_TABLE`` buckets of ``STRESS_SLOTS`` slots (buckets repeated
    among a particle's nine, buckets crowded past K, far cells sharing a
    bucket), budget on and off, a table of ``ODD_SLOTS`` slots a bucket (a
    K read at run time), and the owned range of the particle-sharded step
    (the second half of the particles, budget off) on the scene's grid and
    the stress grid. Every launch is the one ``solve_pairs`` and the
    sharded step make. Times from a CUDA graph of 20 calls (a launch takes
    a few microseconds) with the one-by-one time beside, and an empty
    kernel's time from a graph of 20 as the latency floor. The bound
    counts PAIR_OPS for each candidate pair in the true 3x3 cells (this
    data's work) and the table, the records and the output once. Every
    count and sweep runs with a row of the budget's cut counter, as a
    step's pass does, and the kernel's row must move as the plain
    version's (the half budget cuts, the budget off never does); the times
    are of the launches with the row."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    opts = h._options
    errs, count_exact, rows, stress, fronts = {}, True, [], {}, {}
    cut_moves, cuts_equal = {}, True
    for pop, name in ((0, "white"), (1, "yolk")):
        d = gather_pass_inputs(h, pop)
        small = gather_pass_inputs(h, pop, STRESS_TABLE, STRESS_SLOTS)
        odd = gather_pass_inputs(h, pop, slots=ODD_SLOTS)
        fronts[name] = front_exact(d)
        fronts[name + ".small_table"] = front_exact(small)
        rec, grid, act = d["record"], d["hgrid"], d["active"]
        want_n = GK.gather_count_plain(rec, grid)
        cum = torch.cumsum(want_n, 0) - want_n
        want_s = GK.gather_count_plain(small["record"], small["hgrid"])
        cum_s = torch.cumsum(want_s, 0) - want_s
        want_o = GK.gather_count_plain(odd["record"], odd["hgrid"])
        cum_o = torch.cumsum(want_o, 0) - want_o
        max_pairs = S._max_pairs(act)
        half = want_n.sum() * 0.5
        cfg = d["cfg"]
        scal = (d["collision_c"], d["cohesion_c"],
                cfg.collision_overlap_factor,
                cfg.cohesion_interaction_distance_factor, d["relaxation"])
        spacing = opts.cohesion_mode == "spacing"
        n = act.shape[0]
        owned = (n // 2, n - n // 2)

        def held(key, dd, cm, spacing, own=None):
            """H against plain on one variant of the pass (count, when the
            budget is on, and sweep): the sweep's error."""
            nonlocal count_exact, cuts_equal
            cut_k, cut_p = (torch.zeros((3,), dtype=torch.int32,
                                        device=rec.device) for _ in range(2))
            if cm[0] is not None:
                got_c = GK.gather_count(dd["record"], dd["hgrid"], cut_k)
                count_exact &= bool(torch.equal(
                    got_c, GK.gather_count_plain(dd["record"], dd["hgrid"],
                                                 cut_p)))
            got = GK.gather_sweep(dd["record"], dd["hgrid"], *cm, *scal,
                                  spacing=spacing, owned=own, cuts=cut_k)
            want = GK.gather_sweep_plain(dd["record"], dd["hgrid"], *cm,
                                         *scal, spacing=spacing, owned=own,
                                         cuts=cut_p)
            errs[f"{name}.{key}"] = float((got - want).abs().max())
            cut_moves[f"{name}.{key}"] = cut_k[:2].tolist()
            cuts_equal &= bool(torch.equal(cut_k[:2], cut_p[:2]))
            return want

        for budget in ("ordered", "off"):
            cm = (cum, max_pairs) if budget == "ordered" else (None, None)
            want = held(budget, d, cm, spacing)
            if not float((want - d["pos"]).abs().max()) > 0.0:
                raise AssertionError(f"{phase}: the pass moved nothing")
        held("budget_half", d, (cum, half), True)
        held("literal", d, (cum, max_pairs), False)
        held("small_table.ordered", small, (cum_s, max_pairs), True)
        held("small_table.off", small, (None, None), True)
        held("owned_half", d, (None, None), spacing, own=owned)
        held("small_table.owned_half", small, (None, None), True, own=owned)
        held("odd_slots.ordered", odd, (cum_o, max_pairs), spacing)
        live = int(act.sum())
        stress[name] = dict(
            pairs=float(want_n.sum()), half_budget=float(half),
            cut_particles=int(((cum >= half) & act).sum()),
            small_table_pairs=float(want_s.sum()), live=live,
            crowded=live > STRESS_TABLE * STRESS_SLOTS,
            owned=owned)
        if not (stress[name]["cut_particles"] > 0 and stress[name]["crowded"]
                and stress[name]["small_table_pairs"] > 0):
            raise AssertionError(f"{phase}: a stress case of kernel H does "
                                 f"not stress it ({stress[name]})")
        if not (cut_moves[f"{name}.budget_half"] == [1, 1]
                and cut_moves[f"{name}.off"] == [0, 0]):
            raise AssertionError(f"{phase}: the cut counter of kernel H "
                                 f"misses a cut or counts one ({cut_moves})")
        cand, valid = GK.candidates(grid, act)
        near = GK.in_cells(grid.cell_xy, torch.clamp(cand, min=0).long())
        pairs = int((valid & near).sum())
        k = grid.table.shape[1]
        cut_row = torch.zeros((3,), dtype=torch.int32, device=rec.device)

        def sweep():
            GK.gather_sweep(rec, grid, cum, max_pairs, *scal, spacing=True,
                            cuts=cut_row)

        def sweep_plain():
            GK.gather_sweep_plain(rec, grid, cum, max_pairs, *scal,
                                  spacing=True)

        fields = (d["pos"], d["inv_mass"], d["radius"], d["batch_slot"],
                  act)
        ms = graph_ms(sweep, 20)
        one_by_one = cuda_ms(sweep, 20)
        count_ms = graph_ms(lambda: GK.gather_count(rec, grid, cut_row), 20)
        front_ms = graph_ms(lambda: GK.gather_front(
            *fields, d["cell"], d["table_size"]), 20)
        plain_ms = cuda_ms(sweep_plain, 5)
        count_plain_ms = cuda_ms(lambda: GK.gather_count_plain(rec, grid), 5)
        front_plain_ms = cuda_ms(lambda: GK.gather_front_plain(
            *fields, d["cell"], d["table_size"]), 5)
        b_ms, b_by = bound(pairs * PAIR_OPS,
                           nbytes(grid.table, rec, cum) + n * 8)
        c_ms, c_by = bound(pairs * COUNT_OPS,
                           nbytes(grid.table) + n * 16 + n * 4)
        f_ms, f_by = bound(n * FRONT_OPS,
                           nbytes(*fields, rec, d["bucket"]))
        rows.append(dict(pop=name, n=n, k=k, slots=n * 9 * k,
                         pairs_in_cells=pairs, ms=ms, one_by_one_ms=one_by_one,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         count_ms=count_ms, count_plain_ms=count_plain_ms,
                         count_bound_ms=c_ms, count_bound_by=c_by,
                         front_ms=front_ms, front_plain_ms=front_plain_ms,
                         front_bound_ms=f_ms, front_bound_by=f_by))
    err = max(errs.values())
    lib = library.load()
    stream = library.stream_handle(torch.device("cuda"))
    floor_ms = graph_ms(lambda: library.check("empty", lib.egg_empty(stream)),
                        20)
    front_ok = all(all(v.values()) for v in fronts.values())
    log(f"check.gather_pairs.{phase}", table_size=opts.table_size,
        slots_per_cell=opts.slots_per_cell, max_abs_err=errs, tol=GATHER_TOL,
        count_bit_exact=count_exact, front_bit_exact=fronts, stress=stress,
        cut_moves=cut_moves, cuts_equal=cuts_equal,
        stress_grid=dict(table_size=STRESS_TABLE, slots=STRESS_SLOTS),
        launch_floor_ms=round(floor_ms, 5),
        per_pop=[{k_: (float(f"{v:.6g}") if isinstance(v, float) else v)
                  for k_, v in r.items()} for r in rows],
        card=nvidia_smi())
    if not (err <= GATHER_TOL and count_exact and front_ok and cuts_equal):
        raise AssertionError(f"{phase}: kernel H disagrees with its plain "
                             f"version (err {errs}, count exact "
                             f"{count_exact}, front {fronts}, cuts "
                             f"{cut_moves})")
    white = rows[0]
    for key, pre, err_k in (("gather_sweep", "", err),
                            ("gather_count", "count_", 0.0),
                            ("gather_front", "front_", 0.0)):
        r = results.setdefault(key, dict(max_abs_err=0.0, library_ms=None))
        if "ms" not in r:           # the first scene's (gather_path) times
            r.update(ms=white[pre + "ms"], plain_ms=white[pre + "plain_ms"],
                     bound_ms=white[pre + "bound_ms"],
                     bound_by=white[pre + "bound_by"],
                     launch_floor_ms=floor_ms)
        r["max_abs_err"] = max(r["max_abs_err"], err_k)


def splat_inside_pairs(payload, counts, opts) -> float:
    """The (candidate, pixel) pairs of the splat whose factor is not 1.0 by
    construction: occupied candidates of a tile's window at the pixels of
    the tile that pass the plain version's ``inside`` test (quad extent and
    static cap), summed over the tiles. Everywhere else ``g = 0``."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import render as R
    dev = payload.device
    s, th, tw = opts.eff_size, opts.tile_h, opts.tile_w
    ntx = s // tw
    msp = float(opts.max_splat_px)
    nb = R._tile_bins(opts, dev)                           # (T, W)
    filled = torch.clamp(counts.to(torch.int64), max=opts.tile_capacity)
    k_used = max(int(filled.max()), 1)
    occ = torch.arange(k_used, device=dev)[None, :] < filled[:, None]
    fields = payload[:, :k_used, :6]
    n_tiles, n_cand = nb.shape[0], nb.shape[1] * k_used
    pix = torch.arange(th * tw, device=dev)
    px_t = ((pix % tw).to(torch.float32) + 0.5)[None, :, None]
    py_t = ((pix // tw).to(torch.float32) + 0.5)[None, :, None]
    tc = max(1, (16 << 20) // (th * tw * n_cand))          # tiles per chunk
    total = 0.0
    for t0 in range(0, n_tiles, tc):
        ids = torch.arange(t0, min(t0 + tc, n_tiles), device=dev)
        m = ids.shape[0]
        win = fields[nb[ids]].reshape(m, 1, n_cand, 6)
        live = occ[nb[ids]].reshape(m, 1, n_cand)
        dx = px_t + ((ids % ntx) * tw).to(torch.float32)[:, None, None] - win[..., 0]
        dy = py_t + ((ids // ntx) * th).to(torch.float32)[:, None, None] - win[..., 1]
        ca, sa = win[..., 2], win[..., 3]
        d_par = dx * ca + dy * sa
        d_perp = -dx * sa + dy * ca
        inside = ((torch.abs(d_par) <= win[..., 5]) & (torch.abs(d_perp) <= win[..., 4])
                  & (torch.abs(dx) <= msp) & (torch.abs(dy) <= msp) & live)
        total += float(inside.sum())
    return total


def check_splat(h, results) -> None:
    """Kernel C against its plain version on the render payloads of both
    populations of the 1M scene: alpha and rgb, the three post modes (white),
    and once on tiles of 32 x 64 pixels over the same bins (8 pixels a
    thread, 256 threads a tile). Each line carries the share of the window's
    occupied candidates that the kernel's cull stages and the share of the
    staged (candidate, pixel) pairs that lie inside the candidate's quad,
    which is the work the bound counts."""
    import dataclasses
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    cases = [(0, "white", mode, rgb, None) for mode in ("coarse", "full", "super")
             for rgb in (False, True)]
    cases += [(1, "yolk", "coarse", False, None), (1, "yolk", "coarse", True, None),
              (0, "white", "coarse", True, (32, 64))]
    for pop, name, post_mode, use_rgb, tile in cases:
        payload, counts, opts, audit = splat_case(h, pop, post_mode, use_rgb)
        if tile is not None:
            opts = dataclasses.replace(opts, tile_h=tile[0], tile_w=tile[1])
        main = (name, post_mode, use_rgb, tile) == ("white", "coarse", False, None)
        got = SPK.splat(payload, counts, opts, use_rgb)
        want = SPK.splat_plain(payload, counts, opts, use_rgb)
        err = float((got[0] - want[0]).abs().max())
        if use_rgb:
            err = max(err, float((got[1] - want[1]).abs().max()))
        ms = cuda_ms(lambda: SPK.splat(payload, counts, opts, use_rgb), 10)
        plain_ms = cuda_ms(lambda: SPK.splat_plain(payload, counts, opts,
                                                   use_rgb), 2 if main else 1,
                           warmup=int(main))
        in_window, staged = SPK.cull_counts(payload, counts, opts)
        n_window = float(in_window.to(torch.float64).sum())
        n_staged = float(staged.to(torch.float64).sum())
        n_inside = splat_inside_pairs(payload, counts, opts)
        # work the function needs: one box test a window candidate and tile,
        # and the full term only where a pixel lies inside the candidate's
        # quad (elsewhere the factor is 1.0 by the test alone). Beside it the
        # counts that charge every pixel of the tile: to the staged
        # candidates (what the kernel evaluates), and to every occupied
        # window candidate (the count before the cull)
        npix = opts.tile_h * opts.tile_w
        filled = torch.clamp(counts, max=opts.tile_capacity)
        moved = (float(filled[:-1].sum()) * payload.shape[-1] * 4
                 + nbytes(counts, *(t for t in got if t is not None)))
        b_ms, b_by = bound(n_inside * SPLAT_OPS + n_window * SPLAT_BOX_OPS,
                           moved)
        b_staged_ms, _ = bound(n_staged * npix * SPLAT_OPS, moved)
        b_window_ms, _ = bound(n_window * npix * SPLAT_OPS, moved)
        log("check.splat", pop=name, post_mode=post_mode, use_rgb=use_rgb,
            canvas=opts.canvas_size, eff=opts.eff_size,
            tile=f"{opts.tile_h}x{opts.tile_w}",
            bin=f"{opts.bin_h}x{opts.bin_w}", K=opts.tile_capacity,
            max_splat_px=opts.max_splat_px, dropped=int(audit[0]),
            peak_bin=int(audit[1]),
            window_candidates_per_tile=round(n_window / in_window.numel(), 1),
            staged_share=round(n_staged / max(n_window, 1.0), 4),
            inside_share_of_staged_pixels=round(
                n_inside / max(n_staged * npix, 1.0), 4),
            max_abs_err=err, tol=SPLAT_TOL,
            alpha_max=round(float(want[0].max()), 4), ms=round(ms, 4),
            plain_ms=round(plain_ms, 4), bound_ms=round(b_ms, 4),
            bound_staged_ms=round(b_staged_ms, 4),
            bound_before_cull_ms=round(b_window_ms, 4), bound_by=b_by)
        if not (err <= SPLAT_TOL and float(want[0].max()) > 0.5
                and 0.0 < n_staged <= n_window
                and 0.0 < n_inside <= n_staged * npix):
            raise AssertionError("splat disagrees with its plain version")
        r = results.setdefault("splat", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None)


# kernel I's cases: (name, viewport (vh, vw), white and yolk canvas sizes):
# the 1M draw's (eggs_1m.frames), the heap's (eggs_64.frames) and the
# default handler's (default_4k.frames; the demo's window)
COMPOSITE_SHAPES = (("1m", (2560, 2560), (2560, 2560)),
                    ("heap", (2048, 2048), (2048, 1024)),
                    ("default", (800, 800), (512, 256)),
                    ("demo", (600, 800), (512, 256)))


def composite_corners(vh: int, vw: int, s: int) -> dict:
    """White canvas corners (x, y) inside, partly off every edge, wholly
    off, and whole, with fractional parts."""
    mx, my = (vw - s) / 2, (vh - s) / 2
    return {"inside": (mx + 0.37, my + 0.81),
            "off_left": (-s / 2 - 0.25, my + 0.5),
            "off_right": (vw - s / 2 + 0.75, my + 0.125),
            "off_top": (mx + 0.5, -s / 2 - 0.999),
            "off_bottom": (mx + 0.25, vh - s / 2 + 0.125),
            "off_top_left": (-s / 3 - 0.5, -s / 5 - 0.75),
            "gone": (vw + 3.5, -s - 10.25),
            "whole": (float(int(mx)) - 3.0, float(int(my)) + 5.0)}


def composite_case(dev, seed: int, vh: int, vw: int, sizes, factor: int,
                   corner):
    """Seeded straight RGBA (colour below 0 and alpha past 1, as the
    lighting gives them) of both populations at ``canvas / factor``, the
    yolk's corner centred on the white's, as (rgba, s, corner) pairs."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    pops = []
    for i, s in enumerate(sizes):
        src = torch.rand((s // factor, s // factor, 4), generator=g) * 1.3 - 0.1
        off = (sizes[0] - s) / 2 + (0.3 if i else 0.0)
        c = torch.tensor([corner[0] + off, corner[1] + off + 0.3 * i],
                         dtype=torch.float32)
        pops.append((src.to(dev), s, c.to(dev)))
    return pops


def composite_frame(fn, pops, vh: int, vw: int):
    """White over zero, then yolk over white, through ``fn``."""
    import torch
    frame = torch.empty((vh, vw, 4), dtype=torch.float32,
                        device=pops[0][0].device)
    for i, (rgba, s, corner) in enumerate(pops):
        fn(frame, rgba, s, corner, over_zero=i == 0)
    return frame


def check_composite(dev, results) -> None:
    """Kernel I (``csrc/composite.cu``) against its plain version (the
    matrix route, cuBLAS's FP32 products) on the card: the composite of
    both populations, white over zero then yolk over white, at the 1M
    draw's, the heap's, the default handler's and the demo's shapes,
    factors 1, 2 and 4, corners inside, off every edge and wholly off; the
    upsample of one and of three channels at factors 2 and 4. Then the 1M
    draw's tail timed as it runs there (two composites and the two raw
    alpha canvases at factor 4) against the plain route, and against the
    upsamples through the matrix products alone (``library_ms``)."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import composite_kernel as CK
    worst, n = 0.0, 0
    for name, (vh, vw), sizes in COMPOSITE_SHAPES:
        errs = {}
        for factor in (1, 2, 4):
            for cname, corner in composite_corners(vh, vw, sizes[0]).items():
                pops = composite_case(dev, SEED + n, vh, vw, sizes, factor,
                                      corner)
                n += 1
                got = composite_frame(CK.composite, pops, vh, vw)
                want = composite_frame(CK.composite_plain, pops, vh, vw)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"composite {name} x{factor} "
                                         f"{cname}: frame not finite")
                errs[f"x{factor}.{cname}"] = float((got - want).abs().max())
        for factor in (2, 4):
            for channels in (1, 3):
                s_in = sizes[0] // factor
                shape = (s_in, s_in) if channels == 1 else (s_in, s_in, channels)
                img = torch.rand(shape, device=dev)
                errs[f"upsample.x{factor}.c{channels}"] = float(
                    (CK.upsample(img, sizes[0])
                     - CK.upsample_plain(img, sizes[0])).abs().max())
        same = CK.upsample(img, s_in) is img
        err = max(errs.values())
        worst = max(worst, err)
        log("check.composite", shape=name, viewport=f"{vh}x{vw}",
            canvases=sizes, max_abs_err=err,
            worst_case=max(errs, key=errs.get), tol=COMPOSITE_TOL,
            factor_1_upsample_is_input=same)
        if not (err <= COMPOSITE_TOL and same):
            raise AssertionError(f"composite {name} disagrees with its plain "
                                 f"version: {errs}")

    # the 1M draw's tail: white and yolk composited, both raw canvases
    (vh, vw), sizes = COMPOSITE_SHAPES[0][1:]
    pops = composite_case(dev, SEED, vh, vw, sizes, 4,
                          composite_corners(vh, vw, sizes[0])["inside"])
    alphas = [rgba[..., 3].contiguous() for rgba, _, _ in pops]

    def tail(comp, up):
        composite_frame(comp, pops, vh, vw)
        for a, (_, s, _) in zip(alphas, pops):
            up(a, s)

    ms = cuda_ms(lambda: tail(CK.composite, CK.upsample), 20, warmup=2)
    plain_ms = cuda_ms(lambda: tail(CK.composite_plain, CK.upsample_plain),
                       10, warmup=2)
    library_ms = cuda_ms(lambda: [CK.upsample_plain(rgba, s) for rgba, s, _
                                  in pops] + [CK.upsample_plain(a, s) for a, s
                                              in zip(alphas, sizes)], 10,
                         warmup=2)
    covered = vh * vw              # both canvases cover the 2560 px viewport
    moved = (vh * vw * 16          # the white's frame writes
             + 2 * covered * 16    # the yolk's frame reads and writes
             + sum(s * s * 4 for s in sizes)       # the raw canvases
             + 2 * sum(nbytes(rgba) for rgba, _, _ in pops)  # each source
             )                                     # read by two launches
    ops = 2 * covered * COMPOSITE_OPS + sum(s * s for s in sizes) * UPSAMPLE_OPS
    b_ms, b_by = bound(ops, moved)
    log("check.composite.time", viewport=f"{vh}x{vw}", canvases=sizes,
        factor=4, launches=4, ms=round(ms, 4), plain_ms=round(plain_ms, 4),
        library_ms=round(library_ms, 4), bound_ms=round(b_ms, 4),
        bound_by=b_by, share=round(b_ms / ms, 4), bytes=moved)
    results["composite"] = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms)


def slot_major_candidates(payload, counts, opts):
    """Kernel G's input from the render payload: per tile, its window
    candidates stable-compacted (occupied slots first, raster bin order),
    in chunks of 128 with the fields on the middle axis, (T, n_chunks, 9,
    128), ``trips = ceil(n_occupied / 128)`` and the occupied count per
    tile."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import render as R
    dev = payload.device
    k = opts.tile_capacity
    nb = R._tile_bins(opts, dev)                           # (T, W)
    n_tiles, w_bins = nb.shape
    n_cand = w_bins * k
    occ = (torch.arange(k, device=dev)[None, None, :]
           < counts[nb].to(torch.int64)[..., None]).reshape(n_tiles, n_cand)
    order = torch.sort((~occ).to(torch.int32), dim=1, stable=True).indices
    win = payload[:, :, :9][nb].reshape(n_tiles, n_cand, 9)
    win = torch.gather(win, 1, order[..., None].expand(-1, -1, 9))
    n_occ = occ.sum(dim=1)
    live = torch.arange(n_cand, device=dev)[None, :] < n_occ[:, None]
    win = torch.where(live[..., None], win, 0.0)
    n_chunks = -(-n_cand // 128)
    win = torch.cat([win, win.new_zeros((n_tiles, n_chunks * 128 - n_cand,
                                         9))], dim=1)
    cand = win.reshape(n_tiles, n_chunks, 128, 9).permute(0, 1, 3, 2)
    trips = ((n_occ + 127) // 128).to(torch.int32)
    return cand.contiguous(), trips, n_occ


def splat_tiles_case(h):
    """Kernel G's arguments ``(cand, trips, th, tw, ntx, max_splat_px)``
    on the white render payload of handler ``h`` at its render options
    (:func:`slot_major_candidates`), then the occupied count a tile and the
    options."""
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import render as R
    st = h.state
    cap = h._options.pop_caps[0]
    cfg = population_config(h._device_cfg2(), 0)
    opts = h._frame_options()[0]
    payload, _, counts = R._splat_payload(
        st.pos[0, :cap], st.last_pos[0, :cap], st.vel[0, :cap],
        st.radius[0, :cap], st.color[0, :cap], st.active_mask()[0, :cap],
        h.stats.centroid[0], torch.tensor(0.5, device=st.device),
        cfg.texture_scale, cfg.motion_blur, opts)
    cand, trips, n_occ = slot_major_candidates(payload, counts, opts)
    return (cand, trips, opts.tile_h, opts.tile_w,
            opts.eff_size // opts.tile_w, int(opts.max_splat_px), n_occ,
            opts)


def tiles_work(cand, n_occ, th: int, tw: int, ntx: int, msp: int):
    """What kernel G's function needs on its slot-major input: ``(staged,
    inside)``, the occupied candidates that its cull keeps
    (``splat_kernel.tiles_cull``) and the (candidate, pixel) pairs that
    pass the exact test (``max(|nx|, |ny|, max(|dx|, |dy|) / msp) <= 1``),
    summed over the tiles."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    dev = cand.device
    n_tiles, n_chunks = cand.shape[0], cand.shape[1]
    n_cand = n_chunks * 128
    f = cand.permute(0, 1, 3, 2).reshape(n_tiles, n_cand, 9)
    keep = SPK.tiles_cull(cand, th, tw, ntx, msp) & (
        torch.arange(n_cand, device=dev)[None, :] < n_occ[:, None])
    pix = torch.arange(th * tw, device=dev)
    px_t = ((pix % tw).to(torch.float32) + 0.5)[None, :, None]
    py_t = ((pix // tw).to(torch.float32) + 0.5)[None, :, None]
    icap = 1.0 / float(msp)
    tc = max(1, (8 << 20) // (th * tw * n_cand))           # tiles per chunk
    inside = 0.0
    for t0 in range(0, n_tiles, tc):
        ids = torch.arange(t0, min(t0 + tc, n_tiles), device=dev)
        w = f[ids]
        dx = (px_t + ((ids % ntx) * tw).to(torch.float32)[:, None, None]
              - w[:, None, :, 0])
        dy = (py_t + ((ids // ntx) * th).to(torch.float32)[:, None, None]
              - w[:, None, :, 1])
        cax = (w[..., 2] * w[..., 6])[:, None, :]
        sax = (w[..., 3] * w[..., 6])[:, None, :]
        cay = (w[..., 2] * w[..., 7])[:, None, :]
        say = (w[..., 3] * w[..., 7])[:, None, :]
        nx = dx * cax + dy * sax
        ny = dy * cay - dx * say
        m = torch.maximum(torch.maximum(nx.abs(), ny.abs()),
                          icap * torch.maximum(dx.abs(), dy.abs()))
        inside += float(((m <= 1.0) & keep[ids][:, None, :]).sum())
    return float(keep.sum()), inside


def check_splat_tiles(h, results) -> None:
    """Kernel G against its plain version on slot-major candidates built
    from the 1M scene's render payload at the main path's render options;
    once more with garbage in every chunk past a tile's trips. Prints the
    share of the occupied candidates G's cull stages and the share of the
    staged (candidate, pixel) pairs that pass the exact test (what
    ``bound_ms`` counts, :func:`tiles_work`)."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    dev = h.state.device
    cand, trips, th, tw, ntx, msp, n_occ, opts = splat_tiles_case(h)
    SPK.tiles_launches = 0
    got = SPK.splat_tiles(cand, trips, th, tw, ntx, msp)
    want = SPK.splat_tiles_plain(cand, trips, th, tw, ntx, msp)
    err = float((got - want).abs().max())
    # garbage past trips: never read, so the kernel's output is unchanged
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    chunk_ids = torch.arange(cand.shape[1], device=dev)
    past = (chunk_ids[None, :] >= trips[:, None].to(torch.int64))[..., None, None]
    noise = torch.rand(cand.shape, generator=gen, device=dev) * 64.0 - 16.0
    garbage = torch.where(past, noise, cand)
    got_g = SPK.splat_tiles(garbage, trips, th, tw, ntx, msp)
    want_g = SPK.splat_tiles_plain(garbage, trips, th, tw, ntx, msp)
    err_g = float((got_g - want_g).abs().max())
    same_g = bool(torch.equal(got_g, got))
    ms = cuda_ms(lambda: SPK.splat_tiles(cand, trips, th, tw, ntx, msp), 10)
    plain_ms = cuda_ms(lambda: SPK.splat_tiles_plain(cand, trips, th, tw,
                                                     ntx, msp), 2)
    launches = SPK.tiles_launches
    # work, as kernel C's bound counts it: the full term at the (candidate,
    # pixel) pairs that pass the exact test and the cull a candidate (the
    # zero tail of a tile's last chunk is not part of the function); the
    # wider counts beside: every staged candidate, every occupied one, at
    # every pixel of the tile
    occupied = float(n_occ.to(torch.float64).sum())
    staged, inside = tiles_work(cand, n_occ, th, tw, ntx, msp)
    read = occupied * 7 * 4
    out_bytes = nbytes(trips, got)
    b_ms, b_by = bound(inside * TILES_OPS + occupied * TILES_CULL_OPS,
                       read + out_bytes)
    staged_ms, _ = bound(staged * th * tw * TILES_OPS, read + out_bytes)
    all_ms, _ = bound(occupied * th * tw * TILES_OPS, read + out_bytes)
    log("check.splat_tiles", eff=opts.eff_size, tile=f"{th}x{tw}",
        tiles=int(cand.shape[0]), n_chunks=int(cand.shape[1]),
        trips_max=int(trips.max()), trips_mean=round(float(trips.float().mean()), 3),
        max_abs_err=err, garbage_max_abs_err=err_g,
        garbage_unchanged=same_g, tol=SPLAT_TOL,
        alpha_max=round(float(want.max()), 4), ms=round(ms, 4),
        plain_ms=round(plain_ms, 4), bound_ms=round(b_ms, 4), bound_by=b_by,
        bound_staged_pixels_ms=round(staged_ms, 4),
        bound_all_pixels_ms=round(all_ms, 4),
        staged_share=round(staged / occupied, 4),
        inside_share=round(inside / max(staged * th * tw, 1.0), 4),
        launches=launches, card=nvidia_smi())
    if not (err <= SPLAT_TOL and err_g <= SPLAT_TOL and same_g
            and float(want.max()) > 0.5):
        raise AssertionError("splat_tiles disagrees with its plain version")
    results["splat_tiles"] = dict(max_abs_err=max(err, err_g), ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None,
                                  launches=launches)


def check_count(h, results):
    """Kernel F on the ordered-layout planes of both populations, bit-exact.
    Returns per population (inputs, planes with the examined-pair prefix and
    positions drifted by up to 0.4 cell, as a substep's passes leave them)."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    out = []
    for pop, name in ((0, "white"), (1, "yolk")):
        p = population_inputs(h, pop, SEED + pop)
        g, k = p["g"], p["k"]
        b = D.bin_to_planes(p["pos"], p["inv_mass"], p["radius"], p["batch"],
                            p["act"], p["cell_size"], grid_dim=g,
                            slots_per_cell=k)
        want = SK.count_planes_plain(b.planes, k)
        got = on_stale_memory(lambda: SK.count_planes(b.planes, k),
                              want.shape, want.device)
        err = float((got - want).abs().max())
        exact = bool(torch.equal(got, want))
        ms = graph_ms(lambda: SK.count_planes(b.planes, k), 20)
        host_ms = cuda_ms(lambda: SK.count_planes(b.planes, k), 20)
        plain_ms = cuda_ms(lambda: SK.count_planes_plain(b.planes, k), 3)
        b = S._dense_add_cum(b, k)
        cum_max = float(b.planes[D.FIELD_CUM].max())
        rp = D.ROW_PAD
        log("check.count_planes", pop=name, G=g, K=k,
            occupied=int((b.planes[D.FIELD_OCC, rp:rp + g] > 0).sum()),
            total=int(got.to(torch.float64).sum()), cum_max=cum_max,
            cum_exact_in_f32=cum_max < CUM_EXACT,
            cum_headroom=round(CUM_EXACT / max(cum_max, 1.0), 3),
            max_abs_err=err, bit_exact=exact, ms=round(ms, 4),
            launched_one_by_one_ms=round(host_ms, 4),
            plain_ms=round(plain_ms, 4))
        if not (exact and err <= COUNT_TOL):
            raise AssertionError(f"count_planes not bit-exact ({name})")
        if not cum_max < CUM_EXACT:
            raise AssertionError(f"FIELD_CUM reaches 2^24 ({name}): the "
                                 f"ordered cutoff is no longer exact")
        r = results.setdefault("count_planes", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if pop == 0:
            # F reads two fields, occupancy and index, of the core rows and
            # the one halo row on each side
            ops = window_pairs(b.planes[D.FIELD_OCC, rp:rp + g], k, 1) * COUNT_OPS
            read = 2 * (g + 2) * b.planes.shape[2] * b.planes.element_size()
            b_ms, b_by = bound(ops, read + nbytes(got))
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None)
        planes = b.planes.clone()
        occ = planes[D.FIELD_OCC] > 0.0
        gen = torch.Generator(device=planes.device).manual_seed(SEED + 10 + pop)
        drift = (torch.rand((2,) + occ.shape, generator=gen,
                            device=planes.device) * 0.8 - 0.4) * p["cell_size"]
        planes[:2] = torch.where(occ, planes[:2] + drift, planes[:2])
        out.append((p, D.refresh_halo_xy(planes), cum_max))
    return out


def check_sweep(ordered_planes, results) -> None:
    """Kernels D and E against their plain versions (and E against D) on the
    1M scene's drifted ordered planes; the ordered cutoff set to bind for
    about half the slots."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    for pop, (p, planes, cum_max) in enumerate(ordered_planes):
        name = ("white", "yolk")[pop]
        k = p["k"]
        params = p["params"].clone()
        params[4] = 0.5 * cum_max              # max_pairs: binds
        dev = planes.device
        rp = D.ROW_PAD
        pairs = window_pairs(planes[D.FIELD_OCC, rp:rp + p["g"]], k, 1)
        for window in (1, 3):
            flag = torch.tensor(window == 3, device=dev)
            for ordered in (False, True):
                kw = dict(cohesion=True, ordered_budget=ordered)
                static = dict(kw, window=window, fresh_mask=window == 3)
                got = SK.sweep_planes(planes, params, k, **static)
                want = SK.sweep_planes_plain(planes, params, k, **static)
                err = float((got - want).abs().max())
                same_flag = bool(torch.equal(
                    got, SK.sweep_planes(planes, params, k, wide=flag, **kw)))
                ms = cuda_ms(lambda: SK.sweep_planes(planes, params, k,
                                                     **static), 10)
                flag_ms = cuda_ms(lambda: SK.sweep_planes(
                    planes, params, k, wide=flag, **kw), 10)
                plain_ms = cuda_ms(lambda: SK.sweep_planes_plain(
                    planes, params, k, **static), 2)
                log("check.sweep_planes", pop=name, G=p["g"], K=k,
                    occupied=int((planes[D.FIELD_OCC, rp:rp + p["g"]]
                                  > 0).sum()), window=window,
                    fresh_mask=window == 3, ordered_budget=ordered,
                    max_pairs=float(params[4]) if ordered else "off",
                    corr_max=round(float(want.abs().max()), 4),
                    max_abs_err=err, tol=SWEEP_TOL,
                    device_flag_same=same_flag, ms=round(ms, 4),
                    device_flag_ms=round(flag_ms, 4),
                    plain_ms=round(plain_ms, 4))
                if not (err <= SWEEP_TOL and same_flag
                        and float(want.abs().max()) > 0.0):
                    raise AssertionError("sweep_planes disagrees with its "
                                         "plain version")
                r = results.setdefault("sweep_planes", dict(max_abs_err=0.0))
                r["max_abs_err"] = max(r["max_abs_err"], err)
                if pop == 0 and (window, ordered) == (1, True):
                    b_ms, b_by = bound(pairs * PAIR_OPS, nbytes(planes, got))
                    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
            # kernel E: each unordered pair once, ordered budget, cohesion
            static = dict(cohesion=True, ordered_budget=True, window=window,
                          fresh_mask=window == 3)
            flagged = dict(cohesion=True, ordered_budget=True, wide=flag)
            got = SK.sweep_planes(planes, params, k, symmetric=True, **static)
            want = SK.sweep_planes_sym_plain(planes, params, k, **static)
            one_sided = SK.sweep_planes(planes, params, k, **static)
            err = float((got - want).abs().max())
            err_d = float((got - one_sided).abs().max())
            err_flag = float((got - SK.sweep_planes(
                planes, params, k, symmetric=True, **flagged)).abs().max())
            # the wrapper's call: the memset of the output and the kernel
            ms = cuda_ms(lambda: SK.sweep_planes(planes, params, k,
                                                 symmetric=True, **static), 10)
            flag_ms = cuda_ms(lambda: SK.sweep_planes(
                planes, params, k, symmetric=True, **flagged), 10)
            d_ms = cuda_ms(lambda: SK.sweep_planes(planes, params, k,
                                                   **static), 10)
            plain_ms = cuda_ms(lambda: SK.sweep_planes_sym_plain(
                planes, params, k, **static), 2 if pop == 0 else 1,
                warmup=int(pop == 0))
            log("check.sweep_planes_sym", pop=name, G=p["g"], K=k, window=window,
                fresh_mask=window == 3, max_abs_err=err, vs_one_sided=err_d,
                device_flag_err=err_flag, tol=SWEEP_TOL, ms=round(ms, 4),
                device_flag_ms=round(flag_ms, 4), one_sided_ms=round(d_ms, 4),
                plain_ms=round(plain_ms, 4))
            if not max(err, err_d, err_flag) <= SWEEP_TOL:
                raise AssertionError("sweep_planes_sym disagrees with its "
                                     "plain version or with kernel D")
            r = results.setdefault("sweep_planes_sym", dict(max_abs_err=0.0))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if pop == 0 and window == 1:
                # each unordered pair once, two adds for the partner's side
                b_ms, b_by = bound(pairs / 2 * (PAIR_OPS + 2),
                                   nbytes(planes, got))
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=None)


def reset_counters() -> None:
    from egg_fluid_simulation_tpu_torch.ops.kernels import composite_kernel as CK
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    CK.launches = CK.upsample_launches = 0
    PK.launches = SPK.launches = SPK.tiles_launches = 0
    SK.launches = SK.sweep_launches = SK.sweep_sym_launches = 0
    SK.count_launches = GK.launches = GK.count_launches = 0
    GK.front_launches = 0


def read_counters() -> dict:
    from egg_fluid_simulation_tpu_torch.ops.kernels import composite_kernel as CK
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    return {"place_planes": PK.launches, "substep_pass": SK.launches,
            "splat": SPK.launches, "count_planes": SK.count_launches,
            "sweep_planes": SK.sweep_launches,
            "sweep_planes_sym": SK.sweep_sym_launches,
            "splat_tiles": SPK.tiles_launches,
            "gather_sweep": GK.launches, "gather_count": GK.count_launches,
            "gather_front": GK.front_launches,
            "composite": CK.launches, "upsample": CK.upsample_launches}


# each kernel's symbol in csrc/, as a profiler trace names its launches
KERNEL_SYMBOLS = {"place_planes": "place_planes_kernel",
                  "substep_pass": "substep_pass_kernel",
                  "splat": "splat_kernel",
                  "count_planes": "count_planes_kernel",
                  "sweep_planes": "sweep_planes_kernel",
                  "sweep_planes_sym": "sweep_planes_sym_kernel",
                  "splat_tiles": "splat_tiles_kernel",
                  "gather_sweep": "gather_sweep_kernel",
                  "gather_count": "gather_count_kernel",
                  "gather_front": "gather_front_kernel",
                  "composite": "composite_kernel",
                  "upsample": "upsample_kernel"}


def kernel_counts(prof) -> dict:
    """Launches of each kernel of the library in a ``torch.profiler`` trace,
    by symbol (``utils.profiling.kernel_launches``): what ran on the card,
    the kernels of replayed CUDA graphs included."""
    from egg_fluid_simulation_tpu_torch.utils.profiling import \
        kernel_launches
    return kernel_launches(prof, KERNEL_SYMBOLS)


@contextlib.contextmanager
def launches_run():
    """The block's launches, counted two ways into the dict it yields:
    ``wrappers``, the wrappers' counters from 0 (an eager step, or a
    capture, which records its launches and runs none; a replay moves no
    counter), and ``trace``, the launches that ran on the card, from a
    ``torch.profiler`` trace of the block (:func:`kernel_counts`)."""
    import torch
    out = {}
    torch.cuda.synchronize()
    reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        torch.cuda.synchronize()
    out["wrappers"] = read_counters()
    out["trace"] = kernel_counts(prof)


def plane_launches(opts, n_steps: int) -> dict:
    """Expected launches of the plane-resident step and the per-pass route
    over ``n_steps`` steps of both populations (no draw)."""
    n_sub, n_pass = opts.n_substeps, opts.n_collision_steps
    passes = n_sub * n_pass
    if opts.stale_hash_compat:
        passes -= n_sub - 1                 # one pass fewer after the first
    bins = {"step": 1, "substep": n_sub, "pass": n_sub * n_pass}[
        opts.dense_rebin]
    sweep = 2 * n_steps * passes
    ordered = opts.budget_mode == "ordered"
    return {"place_planes": 0 if ordered else 2 * n_steps * bins,
            "substep_pass": 0, "splat": 0, "splat_tiles": 0,
            "gather_sweep": 0, "gather_count": 0, "gather_front": 0,
            "composite": 0, "upsample": 0,
            "count_planes": 2 * n_steps * bins if ordered else 0,
            "sweep_planes": 0 if opts.sweep_symmetric else sweep,
            "sweep_planes_sym": sweep if opts.sweep_symmetric else 0}


def gather_phases(dev, results) -> None:
    """``gather_path``, ``gather_reference``, ``demo`` and ``checkpoint``:
    the gather engine (plain PyTorch) on the card, with kernel C in every
    draw, held against its plain version on the draw's own inputs. Each
    raises on a failed check."""
    import os
    import tempfile
    import torch
    from egg_fluid_simulation_tpu_torch import checkpoint
    from egg_fluid_simulation_tpu_torch.demo import DemoState
    from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
    from egg_fluid_simulation_tpu_torch.utils.profiling import (
        collision_drop_stats, validate_state)

    # ---- gather path: kernel H on the scene, then update x10 + draw, then
    # run_steps, each counted from 0 and traced (the step captured at the
    # first update, replayed after); the replayed step against the eager
    # one ----
    hg = gather_handler(dev)
    opts = hg._options
    check_gather_pairs(hg, "gather_path", results)
    wall_ms, host_ms = [], []
    with launches_run() as run:
        for _ in range(GATHER_UPDATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            hg.update(1 / 60)
            ev1.record()
            torch.cuda.synchronize()
            wall_ms.append(ev0.elapsed_time(ev1))
            host_ms.append((time.perf_counter() - t0) * 1e3)
        frame = hg.draw(viewport=(0, 0, 800, 600))
    path_launches, path_wrappers = run["trace"], run["wrappers"]
    audit = hg.render_audit
    validate_state(hg)
    check_path_splat(hg, "gather_path", results)
    with launches_run() as run:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        hg.run_steps(GATHER_RESIDENT)
        ev1.record()
    run_steps_ms = ev0.elapsed_time(ev1) / GATHER_RESIDENT
    res_launches, res_wrappers = run["trace"], run["wrappers"]
    validate_state(hg)
    prof = traced(lambda: [hg.update(1 / 60) for _ in range(5)], 5)
    drops = collision_drop_stats(hg)
    log("gather_path", engine=opts.engine, table_size=opts.table_size,
        slots_per_cell=opts.slots_per_cell, budget_mode=opts.budget_mode,
        pop_caps=opts.pop_caps, particles=hg.get_n_particles(),
        update_wall_ms=[round(x, 3) for x in wall_ms],
        update_wall_p50_ms=round(float(np.median(wall_ms)), 3),
        update_host_p50_ms=round(float(np.median(host_ms)), 3),
        run_steps_ms_per_step=round(run_steps_ms, 3),
        device_ms_per_update=round(prof["device_ms"], 3),
        launches_per_update=prof["kernels"],
        busy_share=round(prof["busy_share"], 3),
        profiled_wall_ms=round(prof["profiled_wall_ms"], 3),
        budget_dropped_pairs={k: v["budget_dropped_pairs"]
                              for k, v in drops.items()},
        budget_pairs={k: v["budget_pairs"] for k, v in drops.items()},
        slot_drop_pct={k: round(v["drop_pct"], 3) for k, v in drops.items()},
        frame=tuple(frame.shape),
        frame_finite=bool(torch.isfinite(frame).all()),
        render_dropped=audit[:, 0].tolist(), launches=path_launches,
        wrapper_counts=path_wrappers, run_steps_launches=res_launches,
        run_steps_wrapper_counts=res_wrappers, profiled=True)
    if not (opts.engine == "gather" and opts.table_size == 16384
            and sum(hg.get_n_particles()) >= 7900):
        raise AssertionError(f"gather path: options {opts}")
    if int(audit[:, 0].sum()) != 0 or not bool(torch.isfinite(frame).all()):
        raise AssertionError("gather path: render dropped particles or the "
                             "frame is not finite")
    # kernel H alone: a sweep each collision pass of each population and,
    # under the ordered budget, a count before it, in the trace; the
    # wrappers ran at the first update (its eager step and the capture),
    # and run_steps replayed the capture without them
    passes = 2 * opts.n_substeps * opts.n_collision_steps
    counted = opts.budget_mode == "ordered"

    render = ("splat", "composite", "upsample")    # the draw's C and I

    def want_h(n_steps):
        return {n: (passes * n_steps if n in ("gather_sweep", "gather_front")
                    or (n == "gather_count" and counted) else 0)
                for n in path_launches if n not in render}

    if (path_launches["splat"] < 2
            or path_launches["composite"] != path_launches["splat"]
            or {n: v for n, v in path_launches.items() if n not in render}
            != want_h(GATHER_UPDATES)
            or res_launches != {**want_h(GATHER_RESIDENT),
                                **dict.fromkeys(render, 0)}
            or {n: v for n, v in path_wrappers.items() if n not in render}
            != want_h(2) or any(res_wrappers.values())):
        raise AssertionError(f"gather path: launch counts {path_launches}, "
                             f"after run_steps {res_launches}, expected "
                             f"{want_h(GATHER_UPDATES)} and "
                             f"{want_h(GATHER_RESIDENT)}; wrappers "
                             f"{path_wrappers} (expected {want_h(2)}: the "
                             f"first step and its capture), after run_steps "
                             f"{res_wrappers} (expected none)")
    for n in ("gather_sweep", "gather_count", "gather_front"):
        results[n]["launches"] = path_launches[n]
    check_step_graph(hg, "gather_path")
    graph_vs_eager(hg, "gather_path.update", lambda: hg.update(1 / 60),
                   GRAPH_UNITS, GRAPH_BLOCKS,
                   expect={"gather_sweep": passes}, count_nodes=True)
    del hg

    # ---- gather reference: the default 4k scene, card vs CPU, one step ----
    out = []
    for device in (dev, torch.device("cpu")):
        hr = default_scene(device)
        hr.step_once()
        validate_state(hr)
        out.append(state_to_numpy(hr.state))
    err = state_err(*out)
    moved = float(np.abs(out[0]["pos"] - out[0]["last_pos"]).max())
    log("gather_reference", engine=hr._options.engine,
        table_size=hr._options.table_size, particles=int(out[0]["count"].sum()),
        max_abs_err=err, tol=f"pos/prev {REF_TOL} px, vel {VEL_TOL} px/s",
        moved_px=moved)
    if not (err["pos"] <= REF_TOL and err["prev"] <= REF_TOL
            and err["vel"] <= VEL_TOL and moved > 0.0
            and hr._options.engine == "gather"):
        raise AssertionError("gather engine on the card disagrees with the CPU")

    # ---- demo: the run_demo session on the card, a draw every 10th frame ----
    demo = DemoState(seed=SEED, capacity=GATHER_CAPACITY, device=dev)
    drawn = []
    draw = demo.draw

    def checked_draw():
        f = draw()
        drawn.append((bool(np.isfinite(f).all()),
                      int(demo.handler.render_audit[:, 0].sum())))
        return f

    demo.draw = checked_draw
    t0 = time.perf_counter()
    stats = demo.run(DEMO_FRAMES, draw_every=DEMO_DRAW_EVERY)
    torch.cuda.synchronize()
    demo_s = time.perf_counter() - t0
    validate_state(demo.handler)
    n_drawn = len(drawn)
    check_gather_pairs(demo.handler, "demo", results)

    def frames(n):
        for _ in range(n):
            demo.update(1 / 60)
            demo.draw()

    frame_ms = []
    for _ in range(3):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        frames(1)
        ev1.record()
        torch.cuda.synchronize()
        frame_ms.append(ev0.elapsed_time(ev1))
    prof = traced(lambda: frames(3), 3)
    check_path_splat(demo.handler, "demo", results)     # after a draw
    check_draw_graph(demo.handler, "demo",
                     (0.0, 0.0, demo.width, demo.height))
    d_opts = demo.handler._options
    graph_vs_eager(demo.handler, "demo.frame", lambda: frames(1),
                   GRAPH_UNITS, GRAPH_BLOCKS,
                   expect={"gather_sweep": 2 * d_opts.n_substeps
                           * d_opts.n_collision_steps, "splat": 2},
                   count_nodes=True)
    log("demo", frames=DEMO_FRAMES, engine=demo.handler._options.engine,
        seconds=round(demo_s, 3), overlay=stats, draws=n_drawn,
        frames_finite=all(d[0] for d in drawn),
        render_dropped=sum(d[1] for d in drawn),
        frame_wall_ms=[round(x, 3) for x in frame_ms],
        device_ms_per_frame=round(prof["device_ms"], 3),
        launches_per_frame=prof["kernels"],
        busy_share=round(prof["busy_share"], 3))
    if not (n_drawn == DEMO_FRAMES // DEMO_DRAW_EVERY
            and all(d[0] and d[1] == 0 for d in drawn)
            and demo.handler._options.engine == "gather"):
        raise AssertionError(f"demo: draws {drawn}")

    # ---- checkpoint: the demo's card handler, loaded on the CPU and on the
    # card, bit for bit; one step on each, card vs CPU ----
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo.npz")
        checkpoint.save(demo.handler, path)
        saved = state_to_numpy(demo.handler.state)
        loaded = {"card": checkpoint.load(path, device=dev),
                  "cpu": checkpoint.load(path, device="cpu")}
    exact = all(np.array_equal(state_to_numpy(h.state)[f], v)
                and state_to_numpy(h.state)[f].dtype == v.dtype
                for h in loaded.values() for f, v in saved.items())
    same_opts = all(h._options == demo.handler._options
                    for h in loaded.values())
    for h in loaded.values():
        h.update(1 / 60)
        validate_state(h)
    after = [state_to_numpy(loaded[d].state) for d in ("card", "cpu")]
    err = state_err(*after)
    log("checkpoint", loaded_bit_exact=exact, same_options=same_opts,
        particles=demo.handler.get_n_particles(), max_abs_err=err,
        tol=f"pos/prev {REF_TOL} px, vel {VEL_TOL} px/s")
    if not (exact and same_opts and err["pos"] <= REF_TOL
            and err["prev"] <= REF_TOL and err["vel"] <= VEL_TOL):
        raise AssertionError("checkpoint: the loaded state differs, or card "
                             "and CPU disagree after a step")


def spatial_window_cases(torus, lay_shape, lay_k: int):
    """The local windows of a ``(db, dx)`` layout cut from the torus planes
    ``torus`` (8, G, G*K) with their halos: ROW_PAD rows above and below
    from the neighbouring bands (the torus wrap in y) and ``lp`` lanes a
    side from the neighbouring blocks, as the halo exchange fills them."""
    import torch
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    g, lanes = torus.shape[1], torus.shape[2]
    db, dx = lay_shape
    lay = S.SpatialLayout(g, lay_k, db=db, dx=dx, migrate_cap=64)
    lay.check()
    dev = torus.device
    for b in range(db):
        rows = (b * lay.gb - S.RP + torch.arange(lay.rows, device=dev)) % g
        for x in range(dx):
            cols = (x * lay.lb - lay.lp
                    + torch.arange(lay.width, device=dev)) % lanes
            yield (b, x), torus[:, rows][:, :, cols].contiguous()


def bench_phase() -> dict:
    """``bench``: ``python bench_torch.py --quick`` in a subprocess under
    ``BENCH_TIMEOUT_S`` (killed past it). Fails on a non-zero exit, a final
    line that lacks a key of ``bench.py``'s set, of the port's or of a
    timed key's spread, a number that is not finite (a list's elements
    included) or a render drop. Returns the final line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "bench_torch.py", "--quick"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    seconds = round(time.perf_counter() - t0, 1)
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    final = lines[-1] if lines and lines[-1]["stage"] == "final" else {}
    log("bench.stages", rc=proc.returncode, seconds=seconds,
        stages=[(x["stage"], x["wall_s"]) for x in lines])
    if proc.returncode != 0 or not final:
        raise AssertionError(f"bench: exit {proc.returncode}, stderr "
                             f"{proc.stderr[-4000:]}")
    want = (set(BENCH.BENCH_KEYS) | set(BENCH.PORT_KEYS)
            | {f"{k}_{s}" for k in BENCH.TIMED_KEYS
               for s in ("p25", "p75", "blocks")})
    missing = sorted(want - set(final))

    def finite(v):
        if isinstance(v, str):
            return True
        if isinstance(v, list):
            return bool(v) and all(finite(x) for x in v)
        return isinstance(v, (int, float)) and math.isfinite(v)
    bad = sorted(k for k in want & set(final) if not finite(final[k]))
    log("bench", card=nvidia_smi(), seconds=seconds,
        final=json.dumps(final))
    if (missing or bad or final.get("render_overflow_dropped") != 0
            or not finite(final["value"])):
        raise AssertionError(f"bench: missing keys {missing}, non-finite "
                             f"{bad}, render dropped "
                             f"{final.get('render_overflow_dropped')}")
    return final


def spatial_snapshot(hs):
    """What a spatial handler's step, resident steps or draw reads and
    writes (the inner handler's render budget and audit too), to start two
    runs from."""
    budget = hs._inner._render_budget
    return (hs._sp_state, hs._sp_stats, hs._sp_wide, hs._elapsed,
            hs._interpolation_alpha, hs._redistribute_count, hs._last_info,
            list(budget.k_boost), list(budget.peak_density), budget.audit)


def spatial_restore(hs, snap) -> None:
    budget = hs._inner._render_budget
    (hs._sp_state, hs._sp_stats, hs._sp_wide, hs._elapsed,
     hs._interpolation_alpha, hs._redistribute_count, hs._last_info,
     budget.k_boost, budget.peak_density, budget.audit) = snap


def spatial_unequal(a, b) -> tuple:
    """``(fields that differ, batch_pos_sum's relative error, the frames'
    largest difference)`` of two ``(state, stats, wide_state, info, frame,
    render audit)``: the state's fields a step writes, the wide-gate state,
    the migration counters and the draw's render-budget audit bit for bit,
    the stats too but ``batch_pos_sum`` (``index_add_``'s atomics:
    ``STATS_RTOL``)."""
    import torch
    from egg_fluid_simulation_tpu_torch.parallel.spatial_graph import \
        STATE_OUT
    unequal = {f for f in STATE_OUT
               if not torch.equal(getattr(a[0], f), getattr(b[0], f))}
    if (a[2] is None) != (b[2] is None) or (a[2] is not None and not all(
            torch.equal(x, y) for wa, wb in zip(a[2], b[2])
            for x, y in zip(wa, wb))):
        unequal.add("wide_state")
    if not np.array_equal(a[3], b[3]):
        unequal.add("info")
    if (a[5] is None) != (b[5] is None) or (
            a[5] is not None and not torch.equal(a[5], b[5])):
        unequal.add("render_audit")
    more, err = resident_unequal((a[0], a[1], ()), (b[0], b[1], ()))
    unequal |= set(more)
    frame_err = (0.0 if a[4] is None
                 else float((a[4] - b[4]).abs().max()))
    return sorted(unequal), err, frame_err


def check_spatial_graph(hs, viewport) -> dict:
    """The 1 x 1 spatial handler's ``step_once``, ``run_steps`` and
    ``draw`` replayed from its graphs (``parallel/spatial_graph.py``)
    against the eager route (:func:`eager_graphs`) from one state
    (:func:`spatial_unequal`: bit for bit, ``batch_pos_sum`` within
    ``STATS_RTOL``, the frame within ``DRAW_TOL``): a step, a block of
    resident steps that takes the rebin branch (1/60 s steps of the
    settled scene) and one that does not (``CALM_DT`` steps), a draw. The
    replayed run is traced: D and C counted by symbol (12 D a step, 2 C a
    draw, nothing else of the library, no wrapper launch); rebins from the
    device counter = the eager loop's host decisions; 0 host reads of the
    rebin decision replayed. Then the graphs' own calls under
    ``sync_errors`` (no device read), and each part's graph nodes, capture
    seconds and pool bytes. Returns each unit's traced launches."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.step_graph import sync_errors
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    graphs = hs._spatial_graphs()
    opts = hs._options
    per = 2 * opts.n_substeps * opts.n_collision_steps
    n = SPATIAL_GRAPH_STEPS
    units = (("step_once", hs.step_once, {"sweep_planes": per}),
             ("run_steps.rebin", lambda: hs.run_steps(n),
              {"sweep_planes": per * n}),
             ("run_steps.calm", lambda: hs.run_steps(n, step_delta=CALM_DT),
              {"sweep_planes": per * n}),
             # the spatial draw returns no raw canvas: no upsample
             ("draw", lambda: hs.draw(viewport=viewport),
              {"splat": 2, "composite": 2}))
    traced_launches, taken = {}, {}
    for name, unit, want in units:
        if name == "draw":
            hs.draw(viewport=viewport)       # this state's draw key built
        snap = spatial_snapshot(hs)
        S.host_reads = 0
        S.rebins[:] = [0, 0]
        before = graphs.rebins.clone()
        with launches_run() as run:
            frame = unit()
        torch.cuda.synchronize()
        rebins = (graphs.rebins - before).tolist()
        reads = S.host_reads
        got = (hs.state, hs.stats, hs._sp_wide, hs.last_migration_info,
               frame, hs._inner._render_budget.audit)
        spatial_restore(hs, snap)
        S.host_reads = 0
        S.rebins[:] = [0, 0]
        with eager_graphs(hs):
            frame = unit()
        want_out = (hs.state, hs.stats, hs._sp_wide, hs.last_migration_info,
                    frame, hs._inner._render_budget.audit)
        unequal, stats_err, frame_err = spatial_unequal(got, want_out)
        launches = run["trace"]
        wrong = {k: v for k, v in launches.items() if v != want.get(k, 0)}
        out = dict(unequal=unequal, batch_sum_rel_err=stats_err,
                   frame_max_abs_err=frame_err, rebins_device=rebins,
                   rebins_eager=list(S.rebins), host_reads_replayed=reads,
                   host_reads_eager=S.host_reads, launches=launches,
                   expected=want, wrapper_counts=run["wrappers"],
                   tol=f"bit for bit; batch_pos_sum rtol {STATS_RTOL}, "
                       f"frame {DRAW_TOL}")
        log(f"spatial_graph.{name}", **out)
        if (unequal or stats_err > STATS_RTOL or frame_err > DRAW_TOL
                or rebins != list(S.rebins) or reads != 0 or wrong
                or any(run["wrappers"].values())):
            raise AssertionError(f"spatial_graph.{name}: the replay differs "
                                 f"from the eager route or ran otherwise "
                                 f"than expected ({out})")
        traced_launches[name], taken[name] = launches, sum(rebins)
    if not (taken["run_steps.rebin"] > 0 and taken["run_steps.calm"] == 0):
        raise AssertionError(f"spatial_graph: the blocks did not take both "
                             f"branches ({taken})")

    # the graphs' own calls read nothing from the device
    snap = spatial_snapshot(hs)
    cfg2 = hs._inner._device_cfg2()
    dt, relax = hs._inner._step_scalars(1 / 60)
    with sync_errors():
        graphs.step(hs._sp_state, cfg2, dt, relax)
        graphs.steps(hs._sp_state, cfg2, dt, relax, 2, hs._sp_wide)
    torch.cuda.synchronize()
    spatial_restore(hs, snap)
    parts, capture_s, pools = {}, {}, {}
    for g in graphs._graphs.values():
        capture_s[g.kind], pools[g.kind] = (round(g.capture_seconds, 3),
                                            g.pool_bytes)
        for part, graph in g._graphs.items():
            parts[f"{g.kind}.{part}"] = node_types(graph.raw_cuda_graph())
    draw_g = next(reversed(graphs._draws.values()))
    parts["draw"] = body_nodes(draw_g._body)
    pools["draw"] = draw_g.pool_bytes
    log("spatial_graph.parts", route=next(iter(
        graphs._graphs.values())).route, graph_nodes=parts,
        capture_s=capture_s, pool_bytes=pools, captures=graphs.captures,
        no_device_read=True)
    return traced_launches


def spatial_phase(dev, results) -> dict:
    """``spatial_1x1``: the 2D spatial layer on a one-rank mesh (a 1-rank
    NCCL group started in the process over an in-memory store: every halo a
    copy, no collective) at the bench.py scene of ``build_handler(65536,
    spatial=1)``, against the dense handler on the same scene. The spatial
    handler's step, resident steps and draw replay from its graphs
    (``parallel/spatial_graph.py``): the first call of each is timed, the
    replays are held against the eager route and timed against it
    (:func:`check_spatial_graph`, :func:`graph_vs_eager`). Kernel D on the
    run's own local window and on windows of 2 x 2 and 4 x 2 layouts of the
    same grid, kernel C on a ``SpatialHandler.draw`` payload, each against
    its plain version. ``SpatialHandler.draw`` is audited: the phase fails
    unless its frames drop no splat (the boost the first draw took and the
    drops before it are printed). In transit counts only particles outside
    a rank's window, so the one-rank scene must never redistribute: the
    phase fails if the handler's host redistribute runs. Returns the
    launches of the replayed resident steps and draw, from their traces."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    from egg_fluid_simulation_tpu_torch.parallel import spatial as S
    from egg_fluid_simulation_tpu_torch.parallel.mesh import init_single_rank
    from egg_fluid_simulation_tpu_torch.utils.profiling import validate_state

    t_phase = time.perf_counter()
    init_single_rank(dev)
    # every host redistribute of a spatial state (the handler's recovery
    # path; not the layout's first establishment), counted until the phase
    # times the function alone
    redistributed = []
    redistribute = S.redistribute

    def counted_redistribute(*args, **kw):
        if kw.get("from_spatial"):
            redistributed.append(1)
        return redistribute(*args, **kw)

    S.redistribute = counted_redistribute
    hs = build_handler(N_SPATIAL, dev, spatial=True)
    hd = build_handler(N_SPATIAL, dev)
    torch.cuda.synchronize()
    log("spatial_1x1.scene", backend=dist.get_backend(),
        world=dist.get_world_size(), particles=hs.get_n_particles(),
        grid=hs.layout.grid_dim, window=(hs.layout.rows, hs.layout.width),
        dense_grids=hd._options.dense_grid_dim)
    first_s = {}

    def first_call(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        first_s[name] = round(time.perf_counter() - t0, 3)

    # ---- the spatial step against the dense step, three free-running
    # steps, held after 1 and 3. The reference is the dense handler on its
    # plane-resident route (kernel D, the spatial step's sweep and summation
    # order; ``hp``). The automatic fused route (kernel B, ``hd``) sums each
    # slot's pairs in another order, which the packed spawn's explosion
    # amplifies, so it is held after the first step at FUSED_TOL; past K a
    # cell's rotating winner hash reads position bits, so an ulp picks
    # other winners and the routes part by more over later steps (ROADMAP
    # Queue 3): its difference after steps 2 and 3 is printed. The first
    # step builds the step's graph ----
    from egg_fluid_simulation_tpu_torch.ops import solver as SO

    def plane_route(fn):
        fused = SO._fused_component_path
        SO._fused_component_path = lambda options: False
        try:
            return fn()
        finally:
            SO._fused_component_path = fused

    hp = build_handler(N_SPATIAL, dev)

    def state_err(a, b):
        act = b.active_mask()
        err = {}
        for f in ("pos", "prev", "vel"):
            err[f] = 0.0
            for i in range(2):
                live = a.batch_slot[i] >= 0
                # one rank: redistribute keeps the prefix order and nothing
                # migrates, so the point sets align slot for slot
                if not torch.equal(live, act[i]):
                    raise AssertionError("spatial_1x1: the 1 x 1 layout "
                                         "lost the prefix order")
                err[f] = max(err[f], float((getattr(a, f)[i][live]
                                            - getattr(b, f)[i][live])
                                           .abs().max()))
        return err

    for k in range(1, SPATIAL_CHECK_STEPS + 1):
        if k == 1:
            first_call("step_once", hs.step_once)
        else:
            hs.step_once()
        plane_route(hp.step_once)
        hd.step_once()
        fused_err = state_err(hs.state, hd.state)
        log("spatial_1x1.fused_route", steps=k, max_abs_err=fused_err,
            tol=(f"pos/prev {FUSED_TOL} px, vel {FUSED_VEL_TOL} px/s"
                 if k == 1 else "printed"))
        if k == 1 and not (fused_err["pos"] <= FUSED_TOL
                           and fused_err["prev"] <= FUSED_TOL
                           and fused_err["vel"] <= FUSED_VEL_TOL):
            raise AssertionError("spatial_1x1: the spatial step disagrees "
                                 "with the dense handler's fused route")
        if k not in (1, SPATIAL_CHECK_STEPS):
            continue
        err = state_err(hs.state, hp.state)
        ss, ds = hs.stats, hp.stats
        cent = float((ss.centroid - ds.centroid).abs().max())
        bsum = float(((ss.batch_pos_sum - ds.batch_pos_sum).abs()
                      - 1e-4 * ds.batch_pos_sum.abs()).max())
        same_counts = bool(torch.equal(ss.batch_count, ds.batch_count))
        moved = float((hs.state.pos - hs.state.last_pos).abs().max())
        log("spatial_1x1.check", steps=k, max_abs_err=err, centroid_err=cent, batch_sum_excess=bsum,
            batch_counts_equal=same_counts, moved_px=moved,
            tol=f"pos/prev {REF_TOL} px, vel {VEL_TOL} px/s, centroid "
                f"1e-3, batch sums rtol 1e-4 atol 1e-2")
        if not (err["pos"] <= REF_TOL and err["prev"] <= REF_TOL
                and err["vel"] <= VEL_TOL and cent <= 1e-3
                and bsum <= 1e-2 and same_counts and moved > 0.0):
            raise AssertionError(f"spatial_1x1: the spatial step disagrees "
                                 f"with the dense step after {k} steps")
    del hp

    # ---- settle (the first resident call builds its graphs), then one
    # eager step that keeps the run's own local window for kernel D ----
    first_call("run_steps(2)", lambda: hs.run_steps(2))
    hs.run_steps(SPATIAL_SETTLE - 2)
    hd.run_steps(SPATIAL_SETTLE)
    seen = []
    sweep_local = S._sweep_local

    def sweep_kept(planes, params, lay, cohesion, wide=False):
        if not seen:
            seen.append((planes.clone(), params.clone()))
        return sweep_local(planes, params, lay, cohesion, wide=wide)

    S._sweep_local = sweep_kept
    try:
        with eager_graphs(hs):
            hs.step_once()
    finally:
        S._sweep_local = sweep_local
    viewport = (0, 0, 1800, 1800)
    # the first draw's audits as read (before and after a boost)
    audits_read = []
    read_audits = R._read_audits

    def kept_audits(t):
        audits_read.append(read_audits(t))
        return audits_read[-1]

    R._read_audits = kept_audits
    try:
        first_call("draw", lambda: hs.draw(viewport=viewport))
    finally:
        R._read_audits = read_audits
    first_audit = hs._inner.render_audit
    log("spatial_graph.first_call", seconds=first_s,
        capture_s={g.kind: round(g.capture_seconds, 3)
                   for g in hs._spatial_graphs()._graphs.values()})
    log("spatial_1x1.draw_audit",
        dropped_before_boost=audits_read[0][:, 0].tolist(),
        peak_bin_occupancy=audits_read[0][:, 1].tolist(),
        boost=hs._inner._render_budget.k_boost,
        peak_density=hs._inner._render_budget.peak_density,
        renders=len(audits_read), dropped=first_audit[:, 0].tolist())
    if first_audit[:, 0].sum() != 0:
        raise AssertionError("spatial_1x1: the audited draw dropped splats "
                             f"after its boost ({first_audit.tolist()})")

    # ---- replayed against eager from one state, both branches ----
    launches = check_spatial_graph(hs, viewport)

    # ---- replayed against eager, timed: wall and device ms ----
    per = hs._options.n_substeps * hs._options.n_collision_steps * 2
    timed = graph_vs_eager(
        hs, "spatial_1x1.run_steps", lambda: hs.run_steps(SPATIAL_CHAIN), 1,
        GRAPH_BLOCKS, expect={"sweep_planes": per * SPATIAL_CHAIN},
        line="spatial_graph")
    per_unit("spatial_1x1.run_steps", timed, SPATIAL_CHAIN, "step",
             line="spatial_graph")
    step_once = graph_vs_eager(
        hs, "spatial_1x1.step_once", hs.step_once, GRAPH_UNITS, GRAPH_BLOCKS,
        expect={"sweep_planes": per}, line="spatial_graph")
    draw = graph_vs_eager(
        hs, "spatial_1x1.draw", lambda: hs.draw(viewport=viewport),
        DRAW_UNITS, GRAPH_BLOCKS, expect={"splat": 2}, line="spatial_graph")

    # ---- per-step time of resident steps, in turns: the spatial
    # handler's run_steps, the bare replayed resident steps under it
    # (without the handler's read of the migration counters) and the dense
    # handler's run_steps; the host redistribute alone (host-clock ms a
    # call, its result dropped), which the handler no longer runs here;
    # then one traced block of each handler ----
    S.host_reads = 0
    graphs = hs._spatial_graphs()
    dt, relax = hs._inner._step_scalars(1 / 60)

    def bare():
        hs._sp_state, hs._sp_stats, _, hs._sp_wide, _ = graphs.steps(
            hs._sp_state, hs._inner._device_cfg2(), dt, relax, SPATIAL_CHAIN,
            wide_state=hs._sp_wide)

    times = {"spatial": [], "spatial_multi_step": [], "dense": []}
    for _ in range(SPATIAL_BLOCKS):
        for name, fn in (("spatial", lambda: hs.run_steps(SPATIAL_CHAIN)),
                         ("spatial_multi_step", bare),
                         ("dense", lambda: hd.run_steps(SPATIAL_CHAIN))):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / SPATIAL_CHAIN)
    reads = S.host_reads / (2 * SPATIAL_BLOCKS * SPATIAL_CHAIN)
    S.redistribute = redistribute
    if redistributed or hs._redistribute_count:
        raise AssertionError(f"spatial_1x1: the handler ran the host "
                             f"redistribute {len(redistributed)} times on "
                             f"one rank")
    redistribute_ms = []
    for _ in range(SPATIAL_BLOCKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S.redistribute(hs._sp_state, hs._cell_sizes(), hs.layout, hs._mesh,
                       from_spatial=True)
        torch.cuda.synchronize()
        redistribute_ms.append((time.perf_counter() - t0) * 1e3)
    sp_trace = traced(lambda: hs.run_steps(SPATIAL_CHAIN), SPATIAL_CHAIN)
    dn_trace = traced(lambda: hd.run_steps(SPATIAL_CHAIN), SPATIAL_CHAIN)
    validate_state(hd)
    frame = hs.draw(viewport=viewport)
    torch.cuda.synchronize()
    p50 = {n: float(np.median(v)) for n, v in times.items()}
    log("spatial_1x1", spatial_1x1_step_ms_65k=round(p50["spatial"], 4),
        dense_step_ms_65k=round(p50["dense"], 4),
        spatial_1x1_vs_dense=round(p50["spatial"] / p50["dense"], 4),
        spatial_multi_step_ms=round(p50["spatial_multi_step"], 4),
        step_once_replay_wall_ms=round(step_once["replay"]["wall_p50_ms"],
                                       4),
        draw_replay_wall_ms=round(draw["replay"]["wall_p50_ms"], 4),
        redistribute_ms=round(float(np.median(redistribute_ms)), 4),
        blocks_ms={n: [round(x, 4) for x in v] for n, v in times.items()},
        redistribute_blocks_ms=[round(x, 4) for x in redistribute_ms],
        chain=SPATIAL_CHAIN, settle_steps=SPATIAL_SETTLE,
        rebin_host_reads_per_step=reads,
        redistributes=len(redistributed), card=nvidia_smi())
    log("spatial_1x1.trace",
        spatial={k: round(v, 4) for k, v in sp_trace.items()
                 if k not in ("by_kernel", "top")},
        dense={k: round(v, 4) for k, v in dn_trace.items()
               if k not in ("by_kernel", "top")},
        spatial_launches=sp_trace["by_kernel"])
    audit = hs._inner.render_audit
    log("spatial_1x1.draw", frame=tuple(frame.shape),
        frame_finite=bool(torch.isfinite(frame).all()),
        alpha_max=round(float(frame[..., 3].max()), 4),
        render_audit=audit.tolist())
    if not (bool(torch.isfinite(frame).all())
            and float(frame[..., 3].max()) > 0.5):
        raise AssertionError("spatial_1x1: frame is not finite or empty")
    if audit[:, 0].sum() != 0:
        raise AssertionError(f"spatial_1x1: the draw dropped splats "
                             f"({audit.tolist()})")
    if reads != 0 or sp_trace["by_kernel"]["sweep_planes"] \
            != per * SPATIAL_CHAIN:
        raise AssertionError(f"spatial_1x1: {reads} host reads of the rebin "
                             f"decision a replayed step, or D launched "
                             f"{sp_trace['by_kernel']} in {SPATIAL_CHAIN} "
                             f"steps")

    # ---- kernel D on the run's local window: window 1, window 3 with the
    # fresh mask, each static and through the device flag ----
    planes, params = seen[0]
    k = hs.layout.slots_per_cell
    rp, g, lp, lb = S.RP, hs.layout.grid_dim, hs.layout.lp, hs.layout.lb
    errs = {}
    r = results.setdefault("sweep_planes.spatial_1x1",
                           dict(max_abs_err=0.0, library_ms=None))

    def d_check(name, window_planes):
        """D against plain on one window; returns the largest correction."""
        worst, largest = 0.0, 0.0
        for window in (1, 3):
            kw = dict(cohesion=True, ordered_budget=False)
            static = dict(kw, window=window, fresh_mask=window == 3)
            want = SK.sweep_planes_plain(window_planes, params, k, **static)
            largest = max(largest, float(want.abs().max()))
            for gate in (static, dict(kw, wide=torch.tensor(
                    window == 3, device=dev))):
                got = SK.sweep_planes(window_planes, params, k, **gate)
                worst = max(worst, float((got - want).abs().max()))
        errs[name] = worst
        r["max_abs_err"] = max(r["max_abs_err"], worst)
        return largest

    fired = {"1x1": d_check("1x1", planes)}
    static1 = dict(cohesion=True, ordered_budget=False, window=1)
    got = SK.sweep_planes(planes, params, k, **static1)
    ms = cuda_ms(lambda: SK.sweep_planes(planes, params, k, **static1), 10)
    plain_ms = cuda_ms(lambda: SK.sweep_planes_plain(planes, params, k,
                                                     **static1), 2)
    pairs = window_pairs(planes[D.FIELD_OCC, rp:rp + g, lp:lp + lb], k, 1)
    b_ms, b_by = bound(pairs * PAIR_OPS, nbytes(planes, got))
    r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    torus = planes[:, rp:rp + g, lp:lp + lb]
    shapes = {}
    for shape in ((2, 2), (4, 2)):
        name = f"{shape[0]}x{shape[1]}"
        fired[name] = 0.0
        for (b, x), win in spatial_window_cases(torus, shape, k):
            fired[name] = max(fired[name], d_check(f"{name}.{b}{x}", win))
            shapes[name] = tuple(win.shape)
    torch.cuda.synchronize()
    log("check.sweep_planes.spatial_1x1", window=tuple(planes.shape),
        cut_windows=shapes, occupied=int((planes[D.FIELD_OCC] > 0).sum()),
        fresh_mod=float(params[6]), largest_correction=fired,
        max_abs_err=errs, tol=SWEEP_TOL,
        ms=round(ms, 4), plain_ms=round(plain_ms, 4), bound_ms=round(b_ms, 4),
        bound_by=b_by)
    if not (max(errs.values()) <= SWEEP_TOL and min(fired.values()) > 0.0):
        raise AssertionError("spatial_1x1: kernel D disagrees with its plain "
                             "version on a local window, or no pair fired")

    # ---- kernel C on the payload of SpatialHandler.draw ----
    st, stats = hs.state, hs.stats
    a = torch.tensor(hs.interpolation_alpha, dtype=torch.float32, device=dev)
    opts2 = hs._inner._frame_options(hs.stats)
    rc = results.setdefault("splat.spatial_1x1",
                            dict(max_abs_err=0.0, library_ms=None))
    cerrs, dropped = {}, {}
    for pop, name in ((0, "white"), (1, "yolk")):
        cfg = population_config(hs._inner._device_cfg2(), pop)
        center = (stats.last_centroid[pop]
                  + (stats.centroid[pop] - stats.last_centroid[pop]) * a)
        for use_rgb in (False, True):
            opts = dataclasses.replace(opts2[pop], use_particle_color=use_rgb)
            payload, audit, counts = R._splat_payload(
                st.pos[pop], st.last_pos[pop], st.vel[pop], st.radius[pop],
                st.color[pop], st.batch_slot[pop] >= 0, center, a,
                cfg.texture_scale, cfg.motion_blur, opts)
            got = SPK.splat(payload, counts, opts, use_rgb)
            want = SPK.splat_plain(payload, counts, opts, use_rgb)
            err = float((got[0] - want[0]).abs().max())
            if use_rgb:
                err = max(err, float((got[1] - want[1]).abs().max()))
            cerrs[f"{name}{'.rgb' if use_rgb else ''}"] = err
            # the draw's options carry the boost its audit took: nothing
            # past a bin's budget
            dropped[name] = int(audit[0])
            if not (err <= SPLAT_TOL and float(want[0].max()) > 0.0):
                raise AssertionError(f"spatial_1x1: splat disagrees with its "
                                     f"plain version ({name}, rgb={use_rgb})")
            rc["max_abs_err"] = max(rc["max_abs_err"], err)
            if (pop, use_rgb) == (0, False):
                ms = cuda_ms(lambda: SPK.splat(payload, counts, opts, False),
                             10)
                plain_ms = cuda_ms(lambda: SPK.splat_plain(
                    payload, counts, opts, False), 2)
                in_window, _ = SPK.cull_counts(payload, counts, opts)
                n_window = float(in_window.to(torch.float64).sum())
                n_inside = splat_inside_pairs(payload, counts, opts)
                filled = torch.clamp(counts, max=opts.tile_capacity)
                moved = (float(filled[:-1].sum()) * payload.shape[-1] * 4
                         + nbytes(counts, got[0]))
                b_ms, b_by = bound(n_inside * SPLAT_OPS
                                   + n_window * SPLAT_BOX_OPS, moved)
                rc.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
    log("check.splat.spatial_1x1", canvas=[o.canvas_size for o in opts2],
        K=[o.tile_capacity for o in opts2], render_dropped=dropped,
        max_abs_err=cerrs, tol=SPLAT_TOL,
        ms=round(rc["ms"], 4), plain_ms=round(rc["plain_ms"], 4),
        bound_ms=round(rc["bound_ms"], 4), bound_by=rc["bound_by"],
        seconds=round(time.perf_counter() - t_phase, 2))
    if any(dropped.values()):
        raise AssertionError(f"spatial_1x1: the draw's payload drops splats "
                             f"past the boosted budget ({dropped})")
    del hs, hd
    dist.destroy_process_group()
    return {"sweep_planes": launches["run_steps.rebin"]["sweep_planes"],
            "splat": launches["draw"]["splat"]}


def check_sharded_pass(calls, results) -> dict:
    """Kernel H's front and sweep against their plain versions on the
    arguments the eager sharded step gave them in its first collision pass
    (``calls``: entry point -> (args, kwargs)): the front bit for bit
    (record as int32 bits, bucket), the sweep of the owned range within
    ``GATHER_TOL``; each timed from a CUDA graph of 20 calls, its plain
    version by CUDA events; the bound counts PAIR_OPS for each candidate
    pair of the owned particles in their true 3x3 cells, the front
    FRONT_OPS a particle. The sweep sums a particle's pair terms in
    another order than the plain version, which can round ``pos + total``
    to the neighbouring float: held to ``GATHER_TOL`` plus one ulp of the
    position (``ULP``). Results go to ``gather_front.sharded`` and
    ``gather_sweep.sharded``."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    fa, fk = calls["gather_front"]
    sa, sk = calls["gather_sweep"]
    rec, bucket = GK.gather_front(*fa, **fk)
    prec, pbucket = GK.gather_front_plain(*fa, **fk)
    front_exact = bool(torch.equal(rec.view(torch.int32),
                                   prec.view(torch.int32))
                       and torch.equal(bucket, pbucket))
    got = GK.gather_sweep(*sa, **sk)
    want = GK.gather_sweep_plain(*sa, **sk)
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - ULP * want.abs()).max())
    record, grid = sa[0], sa[1]
    off, cnt = sk["owned"]
    act = GK.record_active(record)
    cand, valid = GK.candidates(grid, act)
    near = GK.in_cells(grid.cell_xy, torch.clamp(cand, min=0).long())
    pairs = int((valid & near)[off:off + cnt].sum())
    n = record.shape[0]
    sweep_ms = graph_ms(lambda: GK.gather_sweep(*sa, **sk), 20)
    front_ms = graph_ms(lambda: GK.gather_front(*fa, **fk), 20)
    sweep_plain_ms = cuda_ms(lambda: GK.gather_sweep_plain(*sa, **sk), 3)
    front_plain_ms = cuda_ms(lambda: GK.gather_front_plain(*fa, **fk), 3)
    s_ms, s_by = bound(pairs * PAIR_OPS,
                       nbytes(grid.table, record) + cnt * 8)
    f_ms, f_by = bound(n * FRONT_OPS,
                       nbytes(*(t for t in fa if torch.is_tensor(t)), rec,
                              bucket))
    results["gather_sweep.sharded"] = dict(
        max_abs_err=err, ms=sweep_ms, plain_ms=sweep_plain_ms,
        bound_ms=s_ms, bound_by=s_by, library_ms=None)
    results["gather_front.sharded"] = dict(
        max_abs_err=0.0, ms=front_ms, plain_ms=front_plain_ms,
        bound_ms=f_ms, bound_by=f_by, library_ms=None)
    out = dict(particles=n, owned=(off, cnt), k=grid.table.shape[1],
               table_size=grid.table_size, pairs_in_cells=pairs,
               front_bit_exact=front_exact, sweep_max_abs_err=err,
               sweep_err_past_one_ulp=excess,
               tol=f"{GATHER_TOL} px + one ulp of the position",
               sweep_ms=round(sweep_ms, 5),
               sweep_plain_ms=round(sweep_plain_ms, 4),
               sweep_bound_ms=round(s_ms, 5), sweep_bound_by=s_by,
               front_ms=round(front_ms, 5),
               front_plain_ms=round(front_plain_ms, 4),
               front_bound_ms=round(f_ms, 5), front_bound_by=f_by,
               card=nvidia_smi())
    log("check.gather_pairs.sharded", **out)
    if not (front_exact and excess <= GATHER_TOL
            and float((want - record[off:off + cnt, 0:2]).abs().max()) > 0.0):
        raise AssertionError(f"sharded pass: kernel H disagrees with its "
                             f"plain version, or the pass moved nothing "
                             f"({out})")
    return out


def sharded_phase(dev, results) -> dict:
    """``sharded_graph``: the 1D particle-sharded step
    (``parallel/sharding.py``) on a one-rank mesh (a 1-rank NCCL group
    started in the process over an in-memory store; its all-gather returns
    its input and its all-reduces are nothing), replayed from its CUDA graph
    (``parallel/sharding_graph.py``), on the scene of :func:`gather_handler`
    and on bench.py's 65,536-white scene (``dryrun.N_TIMED``) with the
    gather engine, budget off. On each: the first call (eager warm-up and
    capture) timed; the first replayed step against the single-device
    gather step (``solver.step``, same options) on the live particles within
    ``SHARDED_TOL``; ``SHARDED_STEPS`` chained replays, traced and under
    ``sync_errors`` (no host read), against the eager route from the same
    state (``dryrun.chains_unequal``: bit for bit, ``batch_pos_sum`` within
    ``STATS_RTOL``, the bytes a step equal), H's launches a step from the
    trace (a front and a sweep a pass: 24) and no wrapper launch; the
    graph's nodes, capture seconds and pool bytes; replayed against eager
    timed (:func:`graph_vs_eager`: wall, device ms, kernels, busy share).
    On the 65k scene kernel H against its plain version at the sharded
    pass's own arguments (:func:`check_sharded_pass`). Returns H's launches
    of the 65k scene's replayed run."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from egg_fluid_simulation_tpu_torch.ops import solver as SO
    from egg_fluid_simulation_tpu_torch.ops.kernels import gather_kernel as GK
    from egg_fluid_simulation_tpu_torch.ops.step_graph import (EAGER,
                                                               sync_errors)
    from egg_fluid_simulation_tpu_torch.parallel import dryrun as DR
    from egg_fluid_simulation_tpu_torch.parallel import sharding as SH
    from egg_fluid_simulation_tpu_torch.parallel.mesh import init_single_rank
    from egg_fluid_simulation_tpu_torch.parallel.sharding_graph import \
        ShardedGraphs
    from egg_fluid_simulation_tpu_torch.utils.profiling import \
        graph_node_types

    t_phase = time.perf_counter()
    init_single_rank(dev)
    mesh = SH.make_mesh(dev)
    scenes = (("gather_8k", lambda: gather_handler(dev)),
              ("65k", lambda: build_handler(DR.N_TIMED, dev, engine="gather",
                                            budget_mode="off")))
    launches = None
    for scene, make in scenes:
        h = make()
        opts = dataclasses.replace(h._options, budget_mode="off")
        cfg2 = h._device_cfg2()
        dt, relax = h._step_scalars(1 / 60)
        st0 = SH.shard_state(h.state, mesh)
        graphs = ShardedGraphs(mesh, opts)
        replay = SH.sharded_step(mesh, opts, graphs=graphs)
        eager = SH.sharded_step(mesh, opts, graphs=EAGER)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, _ = replay(st0, cfg2, dt, relax)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0

        # ---- the one-rank step against the single-device gather step ----
        ref, _ = SO.step(h.state, cfg2, dt, relax, opts)
        act = h.state.active_mask()
        rtol, atol = SHARDED_TOL
        ref_err = {f: float(((getattr(first, f) - getattr(ref, f)).abs()
                             - rtol * getattr(ref, f).abs())[act].max())
                   for f in ("pos", "prev")}
        moved = float((first.pos - st0.pos).abs()[act].max())

        # ---- replayed (traced, no device read) against eager; a trace
        # that lost kernel records is taken again (up to three) ----
        passes = 2 * opts.n_substeps * opts.n_collision_steps
        expected = {"gather_front": passes, "gather_sweep": passes}
        for attempt in range(1, 4):
            with launches_run() as run:
                with sync_errors():
                    got = DR.chain(replay, st0, cfg2, dt, relax,
                                   SHARDED_STEPS, mesh)
            per_step = {k: v / SHARDED_STEPS
                        for k, v in run["trace"].items() if v}
            if per_step == expected:
                break
        want = DR.chain(eager, st0, cfg2, dt, relax, SHARDED_STEPS, mesh)
        bad, err = DR.chains_unequal(got, want)
        g = graphs.graph()
        out = dict(particles=h.get_n_particles(), capacity=st0.capacity,
                   table_size=opts.table_size, k=opts.slots_per_cell,
                   first_call_s=round(first_s, 3),
                   capture_s=round(g.capture_seconds, 3),
                   pool_bytes=graphs.pool_bytes(),
                   graph_nodes=graph_node_types(g._graph.raw_cuda_graph()),
                   reference_excess=ref_err, moved_px=moved,
                   reference_tol=f"rtol {rtol}, atol {atol} px",
                   unequal=bad, batch_sum_rel_err=err,
                   bytes_per_step=got[0][2], launches_per_step=per_step,
                   h_per_step=sum(per_step.get(k, 0) for k in (
                       "gather_front", "gather_sweep", "gather_count")),
                   trace_attempts=attempt, wrapper_counts=run["wrappers"],
                   host_reads_replayed=0,
                   tol=f"bit for bit; batch_pos_sum rtol {STATS_RTOL}")
        log(f"sharded_graph.{scene}", **out)
        if (bad or err > STATS_RTOL or max(ref_err.values()) > atol
                or not moved > 0.0 or graphs.captures != 1
                or per_step != expected or any(run["wrappers"].values())):
            raise AssertionError(f"sharded_graph.{scene}: the replayed step "
                                 f"differs from the eager step or the "
                                 f"single-device step, or ran otherwise than "
                                 f"expected ({out})")

        # ---- replayed against eager, timed ----
        route = {"step": replay}
        carry = {"st": first}

        def unit():
            carry["st"], _ = route["step"](carry["st"], cfg2, dt, relax)

        @contextlib.contextmanager
        def eager_route():
            route["step"] = eager
            try:
                yield
            finally:
                route["step"] = replay

        graph_vs_eager(None, f"{scene}.step", unit, GRAPH_UNITS, GRAPH_BLOCKS,
                       expect=expected, line="sharded_graph",
                       eager=eager_route)
        if scene == "65k":
            launches = run["trace"]
            # H's arguments in the eager step's first pass
            calls = {}
            orig = {n: getattr(GK, n) for n in ("gather_front",
                                                "gather_sweep")}

            def keep(name):
                def fn(*a, **k):
                    calls.setdefault(name, (a, k))
                    return orig[name](*a, **k)
                return fn

            for name in orig:
                setattr(GK, name, keep(name))
            try:
                eager(st0, cfg2, dt, relax)
            finally:
                for name, fn in orig.items():
                    setattr(GK, name, fn)
            check_sharded_pass(calls, results)
        del h, graphs, replay, eager
    log("sharded_graph", seconds=round(time.perf_counter() - t_phase, 2),
        card=nvidia_smi())
    dist.destroy_process_group()
    return {"gather_front.sharded": launches["gather_front"],
            "gather_sweep.sharded": launches["gather_sweep"]}


# ---------------------------------------------------------- scenarios --

SCENARIO_WORKERS = 6        # CPU processes that step the scenarios' twins
#                             (of the card machine's 8 cores; the main
#                             process drives the card meanwhile)
SCENARIO_FRAME_TOL = 1e-4   # per channel, a frame drawn from one state

_scenario_twins = {}        # a worker's CPU handlers, one a scenario


def _scenario_take(h, snap) -> None:
    """A handler takes a snapshot (:func:`scenario_snapshot`): state,
    stats, wide-gate episode state, accumulator and render budget; its own
    pending targets are dropped (the snapshot holds the flushed ones)."""
    import torch
    from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
    from egg_fluid_simulation_tpu_torch.state import StepStats
    h._state = state_from_numpy(snap["state"])
    h._stats = StepStats(**{k: torch.from_numpy(v)
                            for k, v in snap["stats"].items()})
    h._wide_state = tuple(tuple(torch.from_numpy(x) for x in w)
                          for w in snap["wide"])
    h._elapsed, h._interpolation_alpha = snap["elapsed"], snap["alpha"]
    h._render_budget.k_boost = list(snap["boost"])
    h._render_budget.peak_density = list(snap["peak"])
    h._targets_dirty = False
    h._frames = None


def scenario_snapshot(h) -> dict:
    """Everything a handler's next update reads, on the host."""
    from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
    return dict(state=state_to_numpy(h.state),
                stats={k: v.cpu().numpy() for k, v in vars(h.stats).items()},
                wide=[[x.cpu().numpy() for x in w] for w in h._wide_or_init()],
                elapsed=h._elapsed, alpha=h.interpolation_alpha,
                boost=list(h._render_budget.k_boost),
                peak=list(h._render_budget.peak_density))


def scenario_cpu_step(task) -> dict:
    """One step of scenario ``name`` on the CPU from the card's snapshot
    ``before`` (a worker process: one handler a scenario, one thread);
    with a frame (config 5), the CPU's draw from the card's pre-draw
    snapshot ``after``, against the card's frame."""
    import torch
    import egg_fluid_simulation_tpu_torch as T
    from egg_fluid_simulation_tpu_torch import scenarios
    from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
    name, before, after, frame = task
    if name not in _scenario_twins:
        torch.set_num_threads(1)
        # the card's build printed the spawn warnings already
        with contextlib.redirect_stderr(io.StringIO()):
            _scenario_twins[name] = scenarios.build(
                scenarios.SCENARIOS[name], T, device="cpu")[0]
    h = _scenario_twins[name]
    _scenario_take(h, before)
    t0 = time.perf_counter()
    h.update(1 / 60)
    out = dict(view=state_to_numpy(h.state), alpha=h.interpolation_alpha,
               elapsed=h._elapsed, cpu_step_s=time.perf_counter() - t0)
    if frame is not None:
        _scenario_take(h, after)
        f = h.draw(viewport=scenarios.SCENARIOS[name].viewport).numpy()
        out.update(frame_err=float(np.abs(f - frame).max()),
                   boost=list(h._render_budget.k_boost),
                   dropped=int(h.render_audit[:, 0].sum()))
    return out


def scenario_card_run(name, dev, pool) -> dict:
    """Scenario ``name`` through ``update`` (and ``draw``) on ``dev``: a
    snapshot before each update and after it, each update's wall time;
    the CPU twin of each step submitted to ``pool``."""
    import torch
    import egg_fluid_simulation_tpu_torch as T
    from egg_fluid_simulation_tpu_torch import scenarios
    sc = scenarios.SCENARIOS[name]
    h, ids = scenarios.build(sc, T, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    befores, afters, walls, futures, frames = [], [], [], [], []
    for i in range(max(sc.steps, sc.frames)):
        if sc.drive is not None:
            sc.drive(h, ids, i)
        h._flush_targets()
        before = scenario_snapshot(h)
        sync()
        t0 = time.perf_counter()
        h.update(1 / 60)
        sync()
        walls.append(time.perf_counter() - t0)
        after = scenario_snapshot(h)
        frame = None
        if sc.frames:
            frame = h.draw(viewport=sc.viewport).cpu().numpy()
            frames.append(dict(boost=list(h._render_budget.k_boost),
                               dropped=int(h.render_audit[:, 0].sum())))
        befores.append(before)
        afters.append(after)
        futures.append(pool.submit(scenario_cpu_step,
                                   (name, before, after if sc.frames else None,
                                    frame)))
    return dict(h=h, befores=befores, afters=afters, walls=walls,
                futures=futures, frames=frames)


def scenario_check(name, run, dev) -> dict:
    """Hold each card step of ``run`` to its CPU twin: the host-decided
    fields bit for bit, pos / prev / last_pos within ``REF_TOL`` px and vel
    within ``VEL_TOL``, or a rounding flip ``lockstep.explain`` names
    (kernel H's front against the plain front); frames within
    ``SCENARIO_FRAME_TOL``, the same boosts, nothing dropped."""
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    from egg_fluid_simulation_tpu_torch.utils.profiling import validate_state
    h = run["h"]
    worst = dict(pos=0.0, vel=0.0, frame=0.0)
    flips, cpu_steps = [], []
    for i, fut in enumerate(run["futures"]):
        cpu = fut.result()
        cpu_steps.append(cpu["cpu_step_s"])
        card = run["afters"][i]
        a, b = cpu["view"], card["state"]
        for f in lockstep.HOST_FIELDS:
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"scenarios.{name}: step {i}: {f} "
                                     f"differs between card and CPU")
        if (cpu["alpha"], cpu["elapsed"]) != (card["alpha"], card["elapsed"]):
            raise AssertionError(f"scenarios.{name}: step {i}: accumulator")
        err = lockstep.live_errors(a, b)
        pos = max(err["pos"], err["prev"], err["last_pos"])
        if pos <= REF_TOL and err["vel"] <= VEL_TOL:
            worst["pos"] = max(worst["pos"], pos)
            worst["vel"] = max(worst["vel"], err["vel"])
        else:
            opts, cfg2 = h._options, h._device_cfg2()
            flip = lockstep.explain(lockstep.PortSide(cfg2, opts, "cpu"),
                                    lockstep.PortSide(cfg2, opts, dev),
                                    run["befores"][i]["state"], 1 / 60)
            flips.append(dict(step=i, pop=("white", "yolk")[flip.pop],
                              substep=flip.substep, collision_pass=flip.pass_index,
                              decision=flip.decision,
                              particles=flip.particles, ulps=flip.ulps,
                              part_px=flip.part_px, moved=len(flip.moved)))
        if "frame_err" in cpu:
            card_frame = run["frames"][i]
            worst["frame"] = max(worst["frame"], cpu["frame_err"])
            if not (cpu["frame_err"] <= SCENARIO_FRAME_TOL
                    and cpu["boost"] == card_frame["boost"]
                    and card_frame["dropped"] == 0 == cpu["dropped"]):
                raise AssertionError(
                    f"scenarios.{name}: frame {i}: card vs CPU frame "
                    f"{cpu['frame_err']} (tol {SCENARIO_FRAME_TOL}), boosts "
                    f"{card_frame['boost']} / {cpu['boost']}, dropped "
                    f"{card_frame['dropped']} / {cpu['dropped']}")
    walls = run["walls"]
    out = dict(steps=len(walls), particles=h.get_n_particles(),
               engine=h._options.engine, budget=h._options.budget_mode,
               worst_pos_px=worst["pos"], worst_vel_px_s=worst["vel"],
               flips=flips, first_update_s=round(walls[0], 4),
               update_wall_ms_p50=round(1e3 * float(np.median(walls[1:])), 4),
               update_wall_ms_max=round(1e3 * max(walls[1:]), 4),
               cpu_twin_step_s=round(float(np.median(cpu_steps)), 4),
               validate_state=validate_state(h))
    if run["frames"]:
        out.update(frame_max_abs_err=worst["frame"],
                   render_dropped=[f["dropped"] for f in run["frames"]],
                   boosts=run["frames"][-1]["boost"])
    return out


def scenarios_phase(dev) -> dict:
    """``scenarios``: the five baseline configs (``egg_fluid_simulation_
    tpu_torch/scenarios.py``, the sizes and steps of ``tests/test_baseline_
    scenarios.py``) through ``update`` and ``draw`` on the card, each
    update step-locked to the port on the CPU (the card runs free; each of
    its steps is replayed on the CPU from the card's snapshot, in
    ``SCENARIO_WORKERS`` processes, while the card goes on). One line a
    config; config 5's launches of H and C counted from a trace. Any
    departure the flip rule does not explain raises."""
    import concurrent.futures
    import multiprocessing
    from egg_fluid_simulation_tpu_torch import scenarios
    t0 = time.perf_counter()
    names = list(scenarios.SCENARIOS)
    ctx = multiprocessing.get_context("spawn")
    lines = {}
    with concurrent.futures.ProcessPoolExecutor(SCENARIO_WORKERS,
                                                mp_context=ctx) as pool:
        runs = {}
        for name in names:
            if name == "5" and dev.type == "cuda":
                with launches_run() as traced:
                    runs[name] = scenario_card_run(name, dev, pool)
                runs[name]["launches"] = {
                    k: traced["trace"][k] for k in ("gather_front",
                                                    "gather_count",
                                                    "gather_sweep", "splat")}
            else:
                runs[name] = scenario_card_run(name, dev, pool)
        card_s = time.perf_counter() - t0
        for name in names:
            lines[name] = scenario_check(name, runs[name], dev)
            if "launches" in runs[name]:
                lines[name]["launches"] = runs[name]["launches"]
            log(f"scenarios.{name}", **lines[name])
    for name, line in lines.items():
        if not line["validate_state"]:
            raise AssertionError(f"scenarios.{name}: non-finite state")
        if any(n == 0 for n in line.get("launches", {}).values()):
            raise AssertionError(f"scenarios.{name}: a kernel of the path "
                                 f"never ran: {line['launches']}")
    out = dict(configs=len(lines), seconds=round(time.perf_counter() - t0, 2),
               card_seconds=round(card_s, 2),
               flips=sum(len(line["flips"]) for line in lines.values()),
               workers=SCENARIO_WORKERS)
    log("scenarios", **out)
    return out


# -------------------------------------------------------- dense twins --

DENSE_WORKERS = 6           # CPU processes that step the 65k twins (of
#                             the card machine's 8 cores)
DENSE_65K_STEPS = 8         # updates of bench_65k's spawn transient held
DENSE_1M_UPDATES = 2        # settled updates of headline_1m: the first
#                             captures the step, the rest are replayed
DENSE_RESIDENT_STEPS = 4    # resident steps of the settled 65k scene held
DENSE_FRAME_TOL = 1e-4      # per channel, a frame drawn from one state

_dense_cpu = {}             # a worker's CPU handlers, one a scene


def _dense_cpu_handler(name):
    """The CPU twin of bench scene ``name`` (built unsettled: every step
    takes the card's snapshot)."""
    if name not in _dense_cpu:
        from egg_fluid_simulation_tpu_torch import scenarios
        sc = scenarios.BENCH_SCENES[name]
        with contextlib.redirect_stderr(io.StringIO()):
            _dense_cpu[name] = build_handler(sc.n_white, "cpu",
                                             wide_default=sc.wide_default)
    return _dense_cpu[name]


def dense_cpu_frame(task) -> dict:
    """The CPU port's draw of bench scene ``name`` at ``viewport`` from the
    card's snapshot ``after``, against the card's frame: the largest
    difference a channel, the boosts, the splats dropped."""
    import torch
    name, after, viewport, card_frame = task
    torch.set_num_threads(1)
    h = _dense_cpu_handler(name)
    _scenario_take(h, after)
    t0 = time.perf_counter()
    f = h.draw(viewport=viewport).numpy()
    return dict(frame_err=float(np.abs(f - card_frame).max()),
                boost=list(h._render_budget.k_boost),
                dropped=int(h.render_audit[:, 0].sum()),
                cpu_draw_s=time.perf_counter() - t0)


def dense_cpu_step(task) -> dict:
    """One update of bench scene ``name`` on the CPU port from the card's
    snapshot ``before`` (``threads`` torch threads), held against the
    card's ``after``: the host-decided fields bit for bit, the largest
    live pos / prev / last_pos and vel differences, the episode states;
    where they part past ``REF_TOL`` / ``VEL_TOL`` or the episode states
    differ, the step replayed substep by substep (``lockstep.
    replay_dense``) for the card side's explanation."""
    import torch
    from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    name, before, after, threads = task
    torch.set_num_threads(threads)
    h = _dense_cpu_handler(name)
    _scenario_take(h, before)
    t0 = time.perf_counter()
    h.update(1 / 60)
    cpu_s = time.perf_counter() - t0
    a, b = state_to_numpy(h.state), after["state"]
    host = [f for f in lockstep.HOST_FIELDS if not np.array_equal(a[f], b[f])]
    err = lockstep.live_errors(a, b)
    wide = lockstep.wide_host(h._wide_state)
    parted = (max(err["pos"], err["prev"], err["last_pos"]) > REF_TOL
              or err["vel"] > VEL_TOL or wide != lockstep.wide_host(
                  after["wide"]))
    out = dict(host_unequal=host, err=err, wide=wide, parted=parted,
               cpu_step_s=cpu_s, accumulator=(h.interpolation_alpha,
                                              h._elapsed))
    if parted:
        t0 = time.perf_counter()
        replay = lockstep.replay_dense(
            lockstep.DensePortSide(h._device_cfg2(), h._options, "cpu"),
            before["state"], lockstep.wide_host(before["wide"]))
        for r in replay:
            r.start = None      # the second side's layout is the card's
        out.update(replay=replay, after=a,
                   replay_s=time.perf_counter() - t0)
    return out


def dense_hold(name, h, befores, afters, cpu, dev) -> dict:
    """Hold each card update of ``h`` to its CPU twin (``cpu``: the
    :func:`dense_cpu_step` results): the host fields and accumulator
    equal, and within ``REF_TOL`` / ``VEL_TOL`` with equal episode states,
    or explained by ``lockstep.explain_dense`` (the CPU's replay the first
    side, the card's the second: its substeps on the CPU's inputs and its
    1-ulp envelopes run on the card), each replay held first to the step
    that ran on its side: the CPU's bit for bit to the CPU's update, the
    card's (the step's own code, eagerly) to the replayed graph's output
    within the pass tolerance. Returns the worst errors and the findings;
    raises on a departure."""
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    card = lockstep.DensePortSide(h._device_cfg2(), h._options, dev)
    sub_dt = (1 / 60) / h._options.n_substeps
    worst, found, replay_s = dict(pos=0.0, vel=0.0), [], []
    reproduced = 0.0
    for i, out in enumerate(cpu):
        if out["host_unequal"]:
            raise AssertionError(f"dense_twins.{name}: step {i}: "
                                 f"{out['host_unequal']} differ")
        if out["accumulator"] != (afters[i]["alpha"], afters[i]["elapsed"]):
            raise AssertionError(f"dense_twins.{name}: step {i}: accumulator")
        err = out["err"]
        worst["pos"] = max(worst["pos"], err["pos"], err["prev"],
                           err["last_pos"])
        worst["vel"] = max(worst["vel"], err["vel"])
        if not out["parted"]:
            continue
        replay_s.append(out["replay_s"])
        wide_in = lockstep.wide_host(befores[i]["wide"])
        mine = lockstep.replay_dense(card, befores[i]["state"], wide_in)
        ran = afters[i]["state"]
        tol = lockstep.step_tol(lockstep.pass_tol(ran["pos"]), sub_dt)
        reproduced = max(reproduced, lockstep.reproduces(
            mine, ran, afters[i]["wide"], tol))
        found += [(i, f) for f in lockstep.explain_dense(
            None, card, befores[i]["state"], wide_in,
            ((out["after"], out["wide"], None),
             (ran, afters[i]["wide"], tol)),
            replays=(out["replay"], mine))]
    return dict(worst_pos_px=worst["pos"], worst_vel_px_s=worst["vel"],
                parted_steps=len(replay_s), card_replay_vs_graph_px=reproduced,
                **finding_counts(found),
                cpu_replay_s=round(float(np.median(replay_s)), 3)
                if replay_s else None)


def finding_counts(found) -> dict:
    """What the dense rule named in ``(step, finding)`` pairs: the
    substeps it explained as rounding amplified by the scene
    (``lockstep.Amplified``: their count, the most the sides part on one
    input, the largest 1-ulp envelope and the most a slot's error past the
    pass tolerance is of its own envelope), and each threshold flip."""
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    amp = [f for _, f in found if isinstance(f, lockstep.Amplified)]
    flips = [dict(step=i, pop=("white", "yolk")[f.pop], decision=f.decision,
                  substep=f.substep, slots=len(f.particles), ulps=f.ulps,
                  counts=f.counts) for i, f in found
             if isinstance(f, lockstep.DenseFlip)]
    return dict(amplified_substeps=len(amp),
                worst_same_input_px=max((f.err_px for f in amp), default=0.0),
                worst_envelope_px=max((f.envelope_px for f in amp),
                                      default=0.0),
                worst_envelope_ratio=max((f.ratio for f in amp),
                                         default=0.0),
                flips=flips)


def dense_arithmetic(before, h, dev) -> dict:
    """Where the card and the CPU part on one input: kernel B and its plain
    version on the card, and the plain version on the card and on the CPU,
    one integrating window-3 pass of white from ``before``'s binning (the
    spawn's first step), slot positions; and ``torch.rsqrt`` (the pair
    term's inverse distance) on the card and on the CPU over 2^20 float32
    values from 1e-3 to 1e3: the share that differ and the most float32
    steps apart."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    side = lockstep.DensePortSide(h._device_cfg2(), h._options, dev)
    (P, grid), _ = side.bin(0, before)
    aux = torch.stack([P.damp, P.follow_c, P.relaxation.to(dev),
                       torch.zeros((), device=dev)])
    args = (grid[0], grid[2], P.params_packed, aux, P.k)
    kw = dict(cohesion=True, window=3, fresh_mask=True, prev=grid[1],
              follow=grid[3], integrate=True)
    kernel = SK.substep_pass(*args, **kw)[0]
    plain = SK.substep_pass_plain(*args, **kw)[0]
    host = [t.cpu() if isinstance(t, torch.Tensor) else t for t in args]
    kw_host = {k: v.cpu() if isinstance(v, torch.Tensor) else v
               for k, v in kw.items()}
    cpu = SK.substep_pass_plain(*host, **kw_host)[0]
    occ = (grid[2][3] > 0).cpu()
    x = torch.logspace(-3, 3, 1 << 20, dtype=torch.float32)
    steps = lockstep.float_steps(torch.rsqrt(x).numpy(),
                                 torch.rsqrt(x.to(dev)).cpu().numpy())
    return dict(
        kernel_vs_plain_card_px=float((kernel - plain).abs().max()),
        plain_card_vs_cpu_px=float((plain.cpu() - cpu).abs()[:, occ].max()),
        slots_differ_card_vs_cpu=int(((plain.cpu() != cpu)[:, occ]).any(0)
                                     .sum()), slots=int(occ.sum()),
        rsqrt_differ_share=float((steps > 0).mean()),
        rsqrt_max_float_steps=int(steps.max()))


def dense_card_steps(name, h, n, submit, threads, sync) -> dict:
    """``n`` updates of ``h`` on the card, a snapshot before and after
    each; ``submit`` takes each CPU twin's task (:func:`dense_cpu_step`)
    as the card goes on."""
    befores, afters, walls, futures = [], [], [], []
    for _ in range(n):
        h._flush_targets()
        befores.append(scenario_snapshot(h))
        sync()
        t0 = time.perf_counter()
        h.update(1 / 60)
        sync()
        walls.append(time.perf_counter() - t0)
        afters.append(scenario_snapshot(h))
        futures.append(submit((name, befores[-1], afters[-1], threads)))
    return dict(befores=befores, afters=afters, walls=walls, futures=futures)


def dense_resident(dev, steps: int) -> dict:
    """The settled 65k scene's resident loop on the card through its
    captured parts (``ResidentGraphs``: enter, then ``steps`` replayed
    advances), the carry of each step (``lockstep.resident_carry``) and
    its rebins from the device counter; each step stepped again from the
    card's carry by the loop's own code, eagerly on the card (held to the
    graph's carry within the pass tolerance, rebins equal) and on the CPU
    (``solver.ResidentSteps``), the two held by
    ``lockstep.hold_resident_step``."""
    import torch
    from egg_fluid_simulation_tpu_torch import scenarios
    from egg_fluid_simulation_tpu_torch.interop import (state_from_numpy,
                                                        state_to_numpy)
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    sc = scenarios.BENCH_SCENES["bench_65k"]
    h = scenarios.build_bench(sc, dev)
    h.run_steps(BENCH.SETTLE)
    cfg2 = h._device_cfg2()
    dt, relax = h._step_scalars(1 / 60)
    wide = h._wide_or_init()
    rgs = h._resident_graphs()
    g = rgs._graph("steps", h.state, cfg2, dt, relax, h._options, wide)
    g.enter()
    torch.cuda.synchronize()
    carries, taken, walls = [lockstep.resident_carry(g.loop)], [], []
    for _ in range(steps):
        start = rgs.rebins.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.advance()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        taken.append((rgs.rebins - start).tolist())
        carries.append(lockstep.resident_carry(g.loop))
    state = state_to_numpy(h.state)
    cpu = torch.device("cpu")
    cfg2_cpu = type(cfg2)(**{f: getattr(cfg2, f).cpu() for f in vars(cfg2)})
    wide_cpu = [[t.cpu() for t in w] for w in wide]
    cpu_rs = S.ResidentSteps(state_from_numpy(state), cfg2_cpu, dt.cpu(),
                             relax.cpu(), h._options, wide_cpu)
    card_rs = S.ResidentSteps(h.state, cfg2, dt, relax, h._options, wide)
    sides = [lockstep.DensePortSide(c, h._options, d)
             for c, d in ((cfg2_cpu, cpu), (cfg2, dev))]
    found, errs, cpu_s, reproduced = [], [], [], 0.0
    sub_dt = (1 / 60) / h._options.n_substeps
    for i in range(steps):
        t0 = time.perf_counter()
        tol = lockstep.step_tol(lockstep.pass_tol(carries[i + 1][0]["xy"]),
                                sub_dt)
        f, _, err, rep = lockstep.hold_resident_step(
            sides[0], cpu_rs, sides[1], card_rs, carries[i], carries[i + 1],
            taken[i], i, tol)
        cpu_s.append(time.perf_counter() - t0)
        found += [(i, x) for x in f]
        errs += err
        reproduced = max(reproduced, rep)
    return dict(source=sc.source + ", settled", steps=steps,
                settle_steps=BENCH.SETTLE,
                particles=h.get_n_particles(),
                rebins_card=[sum(t[p] for t in taken) for p in range(2)],
                rebins_by_step=taken,
                worst_pos_px=max((e["pos"] for e in errs), default=0.0),
                worst_vel_px_s=max((e["vel"] for e in errs), default=0.0),
                card_replay_vs_graph_px=reproduced,
                **finding_counts(found),
                replayed_advance_ms_p50=round(
                    1e3 * float(np.median(walls)), 4),
                captures=rgs.captures,
                cpu_s_per_step=round(float(np.median(cpu_s)), 3))


def dense_twins_phase(dev) -> dict:
    """``dense_twins``: the main path, the dense engine's replayed
    ``update``, step-locked to the port on the CPU at the bench's scenes
    (``scenarios.BENCH_SCENES``). The card runs free; each update's
    snapshot (state, stats, episode state) is stepped again on the CPU and
    held by the dense rule (``lockstep.explain_dense``):

    - ``bench_65k``: ``DENSE_65K_STEPS`` updates of the spawn transient
      (the CPU twins in ``DENSE_WORKERS`` processes while the card goes
      on), then one ``draw`` at the bench's canvas viewport from the last
      state on both sides (``DENSE_FRAME_TOL``, nothing dropped, the same
      boosts); kernels A, B and C counted from the trace of the card's run;
    - ``headline_1m``: settled ``bench.SETTLE`` steps, then
      ``DENSE_1M_UPDATES`` updates (the first captures, the rest replay),
      each stepped on the CPU with every core;
    - ``resident_65k``: the settled 65k scene's resident loop
      (:func:`dense_resident`).

    One line a scene and a summary; any departure raises."""
    import concurrent.futures
    import multiprocessing
    import torch
    from egg_fluid_simulation_tpu_torch import scenarios
    from egg_fluid_simulation_tpu_torch.utils import lockstep
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    ctx = multiprocessing.get_context("spawn")
    lines = {}
    with concurrent.futures.ProcessPoolExecutor(DENSE_WORKERS,
                                                mp_context=ctx) as pool:
        sc = scenarios.BENCH_SCENES["bench_65k"]
        h = scenarios.build_bench(sc, dev)
        with launches_run() as traced:
            run = dense_card_steps(sc.name, h, DENSE_65K_STEPS,
                                   lambda t: pool.submit(dense_cpu_step, t),
                                   1, sync)
            viewport = BENCH._canvas_viewport(h)
            frame = h.draw(viewport=viewport)
            sync()
        card_frame = dict(boost=list(h._render_budget.k_boost),
                          dropped=int(h.render_audit[:, 0].sum()))
        arith = dense_arithmetic(run["befores"][0]["state"], h, dev)
        frame_fut = pool.submit(dense_cpu_frame, (
            sc.name, run["afters"][-1], viewport, frame.cpu().numpy()))
        launches = {k: traced["trace"][k]
                    for k in ("place_planes", "substep_pass", "splat")}
        card_65k_s = time.perf_counter() - t_phase

        # headline_1m: settled on the card meanwhile
        t0 = time.perf_counter()
        sc1 = scenarios.BENCH_SCENES["headline_1m"]
        h1 = scenarios.build_bench(sc1, dev)
        h1.update(1 / 60)               # captures the step
        captures = h1._step_graphs.captures
        # the 1M CPU twins run here once the workers are done, every core
        b1 = dense_card_steps(sc1.name, h1, DENSE_1M_UPDATES - 1,
                              lambda t: t, os.cpu_count(), sync)
        if h1._step_graphs.captures != captures:
            raise AssertionError("dense_twins.headline_1m: the update was "
                                 "not replayed")
        card_1m_s = time.perf_counter() - t0

        # the resident loop of the settled 65k scene (card, then CPU)
        t0 = time.perf_counter()
        resident = dense_resident(dev, DENSE_RESIDENT_STEPS)
        resident["seconds"] = round(time.perf_counter() - t0, 2)

        t0 = time.perf_counter()
        cpu = [f.result() for f in run["futures"]]
        fr = frame_fut.result()
        wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    held = dense_hold(sc.name, h, run["befores"], run["afters"], cpu, dev)
    lines[sc.name] = dict(
        source=sc.source, steps=DENSE_65K_STEPS,
        particles=h.get_n_particles(),
        wide_state=[list(w) for w in lockstep.wide_host(h._wide_state)],
        **held, update_wall_ms=[round(1e3 * w, 3) for w in run["walls"]],
        cpu_step_s=[round(c["cpu_step_s"], 3) for c in cpu],
        frame_max_abs_err=fr["frame_err"], frame_viewport=viewport,
        boosts=(card_frame["boost"], fr["boost"]),
        render_dropped=(card_frame["dropped"], fr["dropped"]),
        cpu_draw_s=round(fr["cpu_draw_s"], 3), launches=launches,
        card_seconds=round(card_65k_s, 2), wait_seconds=round(wait_s, 2),
        hold_seconds=round(time.perf_counter() - t0, 2))
    log("dense_twins.bench_65k", **lines[sc.name])
    if not (fr["frame_err"] <= DENSE_FRAME_TOL
            and card_frame["boost"] == fr["boost"]
            and card_frame["dropped"] == 0 == fr["dropped"]):
        raise AssertionError(f"dense_twins.bench_65k: frame {fr} against "
                             f"the card's {card_frame}")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"dense_twins.bench_65k: a kernel of the path "
                             f"never ran: {launches}")

    t0 = time.perf_counter()
    cpu1 = [dense_cpu_step(task) for task in b1["futures"]]
    held = dense_hold(sc1.name, h1, b1["befores"], b1["afters"], cpu1, dev)
    lines[sc1.name] = dict(
        source=sc1.source, updates=DENSE_1M_UPDATES, held=len(cpu1),
        settle_steps=sc1.settle, particles=h1.get_n_particles(), **held,
        update_wall_ms=[round(1e3 * w, 3) for w in b1["walls"]],
        cpu_step_s=[round(c["cpu_step_s"], 3) for c in cpu1],
        cpu_threads=os.cpu_count(), card_seconds=round(card_1m_s, 2),
        hold_seconds=round(time.perf_counter() - t0, 2))
    log("dense_twins.headline_1m", **lines[sc1.name])
    log("dense_twins.resident_65k", **resident)
    lines["resident_65k"] = resident
    lines["arithmetic"] = arith
    log("dense_twins.arithmetic", **arith)
    out = dict(scenes=list(lines),
               flips=sum(len(v.get("flips", ())) for v in lines.values()),
               amplified_substeps=sum(v.get("amplified_substeps", 0)
                                      for v in lines.values()),
               seconds=round(time.perf_counter() - t_phase, 2),
               workers=DENSE_WORKERS, card=nvidia_smi())
    log("dense_twins", **out)
    return out


def main() -> int:
    import torch
    card = nvidia_smi()
    log("device", nvidia_smi=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, available=torch.cuda.is_available())
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to check", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    from egg_fluid_simulation_tpu_torch.utils.profiling import (
        collision_drop_stats, validate_state)

    library.load()
    log("build", seconds=round(library.load_seconds, 2),
        built=bool(library.last_build_log),
        flags=" ".join(library.NVCC_FLAGS),
        ptxas={n: f"{r['registers']} regs, {r['spill_bytes']} B spilled"
               for n, r in sorted(library.kernel_resources().items())})

    t0 = time.perf_counter()
    h = build_handler(N_WHITE, dev)
    torch.cuda.synchronize()
    log("scene", particles=h.get_n_particles(), grids=h._options.dense_grid_dim,
        caps=h._options.pop_caps, seconds=round(time.perf_counter() - t0, 2))
    h.seed_render_budget()
    t0 = time.perf_counter()
    hp = build_handler(N_WHITE, dev, wide_default=True, budget_mode="ordered")
    torch.cuda.synchronize()
    log("scene.ordered", particles=hp.get_n_particles(),
        budget_mode=hp._options.budget_mode,
        wide_budget_substeps=hp._options.wide_budget_substeps,
        seconds=round(time.perf_counter() - t0, 2))
    hp.seed_render_budget()

    results = {}
    check_place(h, results)
    check_place_shapes(dev, results)
    check_substep(h, results)
    check_splat(h, results)
    check_composite(dev, results)
    check_splat_tiles(h, results)
    check_sweep(check_count(hp, results), results)
    check_sweep_shapes(dev, results)

    # ---- main path: update(1/60) x N + draw, counters from zero and a
    # trace of the run; the step captured inside it (the first update) ----
    step_ms, frame_ms = [], []
    viewport = (0, 0, 2560, 2560)
    h._step_graphs = None
    with launches_run() as run:
        for i in range(MAIN_UPDATES):
            torch.cuda.synchronize()
            t_start = torch.cuda.Event(enable_timing=True)
            t_step = torch.cuda.Event(enable_timing=True)
            t_draw = torch.cuda.Event(enable_timing=True)
            t_start.record()
            h.update(1 / 60)
            t_step.record()
            frame = h.draw(viewport=viewport)
            t_draw.record()
            torch.cuda.synchronize()
            step_ms.append(t_start.elapsed_time(t_step))
            frame_ms.append(t_start.elapsed_time(t_draw))
    launches = run["trace"]
    validate_state(h)
    audit = h.render_audit
    drops = collision_drop_stats(h)
    n_steps = MAIN_UPDATES
    log("main_path", updates=n_steps, step_ms=[round(x, 3) for x in step_ms],
        step_render_ms=[round(x, 3) for x in frame_ms],
        frame=tuple(frame.shape), frame_finite=bool(torch.isfinite(frame).all()),
        alpha_max=round(float(frame[..., 3].max()), 4),
        render_dropped=audit[:, 0].tolist(), peak_bin=audit[:, 1].tolist(),
        drop_pct_white=round(drops["white"]["drop_pct"], 3),
        drop_pct_yolk=round(drops["yolk"]["drop_pct"], 3),
        max_cell_occupancy=(drops["white"]["max_cell_occupancy"],
                            drops["yolk"]["max_cell_occupancy"]),
        launches=launches, wrapper_counts=run["wrappers"], profiled=True)
    if int(audit[:, 0].sum()) != 0:
        raise AssertionError("render overflow dropped particles")
    if not (bool(torch.isfinite(frame).all()) and float(frame[..., 3].max()) > 0.5):
        raise AssertionError("frame is not finite or empty")
    per = h._options.n_substeps * h._options.n_collision_steps * 2
    if not (launches["place_planes"] == 2 * n_steps
            and launches["substep_pass"] == per * n_steps
            and launches["splat"] >= 2 * n_steps
            and launches["composite"] == launches["splat"]
            and launches["upsample"] == launches["splat"]
            and launches["count_planes"] == launches["sweep_planes"]
            == launches["sweep_planes_sym"] == launches["splat_tiles"] == 0
            and all(run["wrappers"][n] > 0
                    for n in ("place_planes", "substep_pass", "splat",
                              "composite", "upsample"))):
        raise AssertionError(f"unexpected kernel launch counts {launches}, "
                             f"wrappers {run['wrappers']}")

    # ---- resident steps and frames on the same 1M handler: run_steps and
    # multi_step_frames (the render as frame_fn) through the handler's
    # resident graphs, against the eager loops from the same state ----
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    res = resident_steps(h, "1m", RESIDENT_STEPS)
    validate_state(h)
    drops = collision_drop_stats(h)
    log("resident_path", steps=RESIDENT_STEPS,
        first_call_s=res["first_call_s"], rebins=res["rebins_device"],
        replay_ms_per_step=round(
            res["time"]["replay"]["wall_p50_ms"] / RESIDENT_STEPS, 4),
        eager_ms_per_step=round(
            res["time"]["eager"]["wall_p50_ms"] / RESIDENT_STEPS, 4),
        update_ms=[round(x, 3) for x in step_ms],
        drop_pct_white=round(drops["white"]["drop_pct"], 3),
        drop_pct_yolk=round(drops["yolk"]["drop_pct"], 3),
        max_cell_occupancy=(drops["white"]["max_cell_occupancy"],
                            drops["yolk"]["max_cell_occupancy"]),
        launches=res["launches"])

    audits = []
    fr = resident_frames(h, "1m", RESIDENT_FRAMES,
                         render_frame_fn(h, viewport, audits))
    overflow = int(torch.stack(audits)[:, :, 0].sum())
    finite = (bool(torch.isfinite(h.state.pos).all())
              and math.isfinite(fr["total"]))
    log("resident_frames", frames=RESIDENT_FRAMES,
        first_call_s=fr["first_call_s"], rebins=fr["rebins_device"],
        replay_ms_per_frame=round(
            fr["time"]["replay"]["wall_p50_ms"] / RESIDENT_FRAMES, 4),
        eager_ms_per_frame=round(
            fr["time"]["eager"]["wall_p50_ms"] / RESIDENT_FRAMES, 4),
        update_draw_ms=[round(x, 3) for x in frame_ms], total=fr["total"],
        finite=finite, render_dropped=overflow, launches=fr["launches"])
    if not (finite and overflow == 0 and fr["total"] > 0.0):
        raise AssertionError("resident frames: non-finite, empty or "
                             "overflowing render")

    # ---- the same on the bench's 10k scene, settled ----
    h10 = build_handler(10_000, dev)
    with eager_graphs(h10):         # the first replayed call is the phase's
        h10.run_steps(BENCH.SETTLE)
    resident_steps(h10, "10k", RESIDENT_STEPS)
    validate_state(h10)
    del h10

    # ---- default options: the violence-gated wide sweep on a spawn explosion ----
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                default_white_config,
                                                default_yolk_config)
    hd = SimulationHandler(default_white_config(), default_yolk_config(),
                           capacity=16384, max_batches=16, device=dev)
    rng = np.random.RandomState(SEED)
    hd.add_many([dict(x=float(400 + 40 * rng.randn()), y=float(300 + 40 * rng.randn()))
                 for _ in range(8)])
    wide_substeps = [0, 0]
    with launches_run() as run:
        for _ in range(10):
            before = [int(w[1]) for w in hd._wide_or_init()]
            hd.step_once()
            after = [int(w[1]) for w in hd._wide_state]
            for pop in range(2):
                if after[pop] <= before[pop]:
                    wide_substeps[pop] += before[pop] - after[pop]
    frame_d = hd.draw(viewport=(0, 0, 800, 600))
    validate_state(hd)
    log("default_options", particles=hd.get_n_particles(),
        wide_budget_substeps=hd._options.wide_budget_substeps,
        wide_substeps_run=wide_substeps,
        substep_launches=run["trace"]["substep_pass"],
        frame_finite=bool(torch.isfinite(frame_d).all()),
        render_dropped=hd.render_audit[:, 0].tolist())
    if sum(wide_substeps) == 0:
        raise AssertionError("the wide sweep never ran on a spawn explosion")

    # ---- plane path: the ordered budget at 1M, default gate, 3 updates +
    # one draw, counters from zero; every binning's FIELD_CUM maximum is
    # folded into a running maximum on the device, and the binnings are
    # counted there, in place: the update replays a captured step, which
    # runs this wrapper's ops without calling it. Read after the run ----
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    add_cum = S._dense_add_cum
    cum_peak = torch.zeros((), dtype=torch.float32, device=dev)
    cum_seen = torch.zeros((), dtype=torch.int64, device=dev)

    def add_cum_kept(binning, k):
        binning = add_cum(binning, k)
        torch.maximum(cum_peak, binning.planes[D.FIELD_CUM].max(),
                      out=cum_peak)
        cum_seen.add_(1)
        return binning

    S._dense_add_cum = add_cum_kept
    hp._step_graphs = None          # captured with the wrapper in place
    plane_ms = []
    try:
        with launches_run() as run:
            for _ in range(MAIN_UPDATES):
                torch.cuda.synchronize()
                t_start = torch.cuda.Event(enable_timing=True)
                t_step = torch.cuda.Event(enable_timing=True)
                t_start.record()
                hp.update(1 / 60)
                t_step.record()
                torch.cuda.synchronize()
                plane_ms.append(t_start.elapsed_time(t_step))
            frame_p = hp.draw(viewport=viewport)
    finally:
        S._dense_add_cum = add_cum
        hp._step_graphs = None      # recaptured without the watcher
    plane_launches_run = run["trace"]
    plane_cum_max = float(cum_peak)
    n_binnings = int(cum_seen)
    validate_state(hp)
    audit_p = hp.render_audit
    want = plane_launches(hp._options, MAIN_UPDATES)
    log("plane_path", updates=MAIN_UPDATES,
        step_ms=[round(x, 3) for x in plane_ms],
        fused_step_ms=[round(x, 3) for x in step_ms],
        wide_state=[[int(v) for v in w] for w in hp._wide_state],
        frame_finite=bool(torch.isfinite(frame_p).all()),
        alpha_max=round(float(frame_p[..., 3].max()), 4),
        render_dropped=audit_p[:, 0].tolist(), binnings=n_binnings,
        cum_max=plane_cum_max, cum_exact_in_f32=plane_cum_max < CUM_EXACT,
        launches=plane_launches_run, wrapper_counts=run["wrappers"],
        profiled=True)
    if not (n_binnings == plane_launches_run["count_planes"]
            and plane_cum_max < CUM_EXACT):
        raise AssertionError(f"plane path: FIELD_CUM max {plane_cum_max} "
                             f"over {n_binnings} binnings, 2^24 or more")
    if int(audit_p[:, 0].sum()) != 0:
        raise AssertionError("plane path: render overflow dropped particles")
    if not (bool(torch.isfinite(frame_p).all())
            and float(frame_p[..., 3].max()) > 0.5):
        raise AssertionError("plane path: frame is not finite or empty")
    render = ("splat", "composite", "upsample")    # the draw's C and I
    if ({n: v for n, v in plane_launches_run.items() if n not in render}
            != {n: v for n, v in want.items() if n not in render}
            or plane_launches_run["splat"] < 2
            or plane_launches_run["composite"] != plane_launches_run["splat"]
            or not all(run["wrappers"][n] > 0 for n, v in want.items() if v)):
        raise AssertionError(f"plane path: launch counts {plane_launches_run}"
                             f", expected {want} and >= 2 splats")

    # ---- the fixed step replayed from its CUDA graph against the eager
    # step on both 1M handlers (bit for bit), then update walls of each ----
    for name, hx in (("main_path", h), ("plane_path", hp)):
        check_step_graph(hx, name)
        graph_vs_eager(hx, f"{name}.update", lambda hx=hx: hx.update(1 / 60),
                       GRAPH_UNITS, GRAPH_BLOCKS)
    del hp

    # ---- draw_graph: the 1M scene's draw at the bench's canvas viewport
    # replayed from its render graph against the eager draw, timed both
    # ways; then the overflow path on a clustered scene (the demo scene's
    # line is in gather_phases) ----
    check_draw_graph(h, "1m", BENCH._canvas_viewport(h))
    del h
    check_draw_overflow(dev)

    # ---- the bench's kernels A, B and C against their plain versions on
    # the 1M scene settled as the bench settles it (every check above ran
    # on the packed spawn state); the kernel line keeps the spawn state's ----
    hs = build_handler(N_WHITE, dev)
    hs.run_steps(BENCH.SETTLE)
    hs.seed_render_budget()
    drops = collision_drop_stats(hs)
    log("settled", particles=hs.get_n_particles(), settle_steps=BENCH.SETTLE,
        drop_pct_white=round(drops["white"]["drop_pct"], 3),
        max_cell_occupancy=(drops["white"]["max_cell_occupancy"],
                            drops["yolk"]["max_cell_occupancy"]),
        checks="the check.place_planes, check.substep_pass and check.splat "
               "lines that follow")
    settled = {}
    check_place(hs, settled)
    check_substep(hs, settled)
    check_splat(hs, settled)
    del hs

    # ---- plane modes at 65k white: each mode's own launch counts ----
    modes = [dict(sweep_symmetric=True), dict(dense_rebin="substep"),
             dict(dense_rebin="pass"), dict(stale_hash_compat=True),
             dict(cohesion_mode="literal")]
    mode_launches = {}
    for mode in modes:
        hm = build_handler(N_WHITE_MODES, dev, wide_default=True,
                           budget_mode="ordered", **mode)
        with launches_run() as run:
            t0 = time.perf_counter()
            for _ in range(MODE_STEPS):
                hm.step_once()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / MODE_STEPS
        got = run["trace"]
        validate_state(hm)
        want = plane_launches(hm._options, MODE_STEPS)
        name = ",".join(f"{k_}={v}" for k_, v in mode.items())
        mode_launches[name] = got
        log("plane_modes", mode=name, particles=hm.get_n_particles(),
            grids=hm._options.dense_grid_dim, steps=MODE_STEPS,
            host_ms_per_step=round(ms, 3), launches=got,
            wrapper_counts=run["wrappers"], profiled=True)
        if got != want:
            raise AssertionError(f"plane mode {name}: launch counts {got}, "
                                 f"expected {want}")
        del hm

    # ---- small scene, card vs CPU (plain versions): the plane path and the
    # symmetric sweep agree with the plain reference, as the fused path
    # (budget off) does ----
    from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
    for mode in (dict(budget_mode="ordered"),
                 dict(budget_mode="ordered", sweep_symmetric=True),
                 dict(budget_mode="off")):
        out = []
        for device in (dev, torch.device("cpu")):
            hr = build_handler(N_WHITE_REF, device, wide_default=True, **mode)
            for _ in range(REF_STEPS):
                hr.step_once()
            validate_state(hr)
            out.append(state_to_numpy(hr.state))
        a, b = out
        err = {f: float(np.abs(a[f] - b[f]).max())
               for f in ("pos", "prev", "vel")}
        moved = float(np.abs(a["pos"] - a["last_pos"]).max())
        log("plane_reference", mode=mode, particles=int(a["count"].sum()),
            steps=REF_STEPS, max_abs_err=err,
            tol=f"pos/prev {REF_TOL} px, vel 0.2 px/s", moved_px=moved)
        if not (err["pos"] <= REF_TOL and err["prev"] <= REF_TOL
                and err["vel"] <= 0.2 and moved > 0.0):
            raise AssertionError(f"plane path on the card disagrees with the "
                                 f"plain reference ({mode})")

    # ---- resident steps and frames on a calm 4k lattice, card vs CPU: the
    # fused variant, the plane-resident variant (symmetric sweep, kernel E,
    # planes written in place) and the frame loop's carry; on the card
    # through the handler's resident graphs (replayed, the rebins from
    # their device counter), on the CPU eagerly ----
    def lattice_run(device, route, mode):
        hr = lattice_handler(device, **mode)
        if route == "run_steps":
            hr.run_steps(RESIDENT_REF_STEPS)
        else:
            dt_r, relax_r = hr._step_scalars(1 / 60)
            hr._state, _ = S.multi_step_frames(
                hr.state, hr._device_cfg2(), dt_r, relax_r, hr._options,
                RESIDENT_REF_FRAMES,
                lambda state, stats: torch.sum(stats.centroid),
                graphs=hr._resident_graphs())
        validate_state(hr)
        return hr

    for route, mode in (("run_steps", dict()),
                        ("run_steps", dict(sweep_symmetric=True)),
                        ("multi_step_frames", dict())):
        out = []
        for device in (dev, torch.device("cpu")):
            S.rebins[:] = [0, 0]
            hr = lattice_run(device, route, mode)
            if device.type == "cuda" and hr._resident.captures != 1:
                raise AssertionError("resident_reference: the card's loop "
                                     "was not replayed")
            occ = collision_drop_stats(hr)
            out.append((state_to_numpy(hr.state), BENCH.rebin_count(hr),
                        (occ["white"]["max_cell_occupancy"],
                         occ["yolk"]["max_cell_occupancy"])))
        (a, rebins_card, occ_card), (b, rebins_cpu, _) = out
        err = {f: float(np.abs(a[f] - b[f]).max())
               for f in ("pos", "prev", "vel", "last_pos")}
        moved = float(np.abs(a["pos"] - a["last_pos"]).max())
        log("resident_reference", route=route, mode=mode,
            particles=int(a["count"].sum()),
            steps=RESIDENT_REF_STEPS if route == "run_steps"
            else RESIDENT_REF_FRAMES, max_abs_err=err,
            tol=f"pos/prev/last_pos {REF_TOL} px, vel 0.2 px/s",
            rebins_card=rebins_card, rebins_cpu=rebins_cpu,
            max_cell_occupancy=occ_card, moved_px=moved)
        if not (max(err["pos"], err["prev"], err["last_pos"]) <= REF_TOL
                and err["vel"] <= 0.2 and moved > 0.0
                and rebins_card == rebins_cpu and sum(rebins_card) > 0
                and max(occ_card) <= 4):
            raise AssertionError(f"resident {route} {mode} on the card "
                                 f"disagrees with the plain reference")

    # ---- warmup: builds, steps and draws, and leaves no trace ----
    hw = build_handler(N_WHITE_REF, dev, wide_default=True)
    hw.update(0.5 / 60)
    saved = {f: getattr(hw.state, f).clone() for f in vars(hw.state)
             if isinstance(getattr(hw.state, f), torch.Tensor)}
    alpha0 = hw.interpolation_alpha
    t0 = time.perf_counter()
    hw.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    unchanged = all(torch.equal(getattr(hw.state, f), v)
                    for f, v in saved.items())
    log("warmup", seconds=round(warm_s, 3), state_unchanged=unchanged,
        alpha=(alpha0, hw.interpolation_alpha),
        wide_state=[[int(v) for v in w] for w in hw._wide_state])
    if not (unchanged and hw.interpolation_alpha == alpha0 == 0.5):
        raise AssertionError("warmup changed the simulation state")

    gather_phases(dev, results)
    sharded_launches = sharded_phase(dev, results)
    spatial_launches = spatial_phase(dev, results)
    torch.cuda.empty_cache()
    scenarios_phase(dev)
    torch.cuda.empty_cache()
    dense_twins_phase(dev)
    bench_phase()

    launches.update(count_planes=plane_launches_run["count_planes"],
                    sweep_planes=plane_launches_run["sweep_planes"],
                    sweep_planes_sym=mode_launches[
                        "sweep_symmetric=True"]["sweep_planes_sym"])
    src = "egg_fluid_simulation_tpu_torch/csrc/"
    tpu = "egg_fluid_simulation_tpu/ops/pallas/"
    # kernel H: no TPU kernel; XLA fuses the JAX package's solve_pairs
    no_tpu = ("none (XLA fuses solve_pairs, "
              "egg_fluid_simulation_tpu/ops/solver.py:343)")
    table = [("place_planes", src + "place_planes.cu", tpu + "place_kernel.py:124"),
             ("substep_pass", src + "substep_pass.cu", tpu + "sweep_kernel.py:771"),
             ("splat", src + "splat.cu", tpu + "splat_kernel.py:400"),
             ("count_planes", src + "count_planes.cu", tpu + "sweep_kernel.py:572"),
             ("sweep_planes", src + "sweep_planes.cu", tpu + "sweep_kernel.py:455"),
             ("sweep_planes_sym", src + "sweep_planes.cu",
              tpu + "sweep_kernel.py:526"),
             ("splat_tiles", src + "splat_tiles.cu", tpu + "splat_kernel.py:443"),
             ("sweep_planes.spatial_1x1", src + "sweep_planes.cu",
              tpu + "sweep_kernel.py:455"),
             ("splat.spatial_1x1", src + "splat.cu", tpu + "splat_kernel.py:400"),
             ("gather_sweep", src + "gather_pairs.cu", no_tpu),
             ("gather_count", src + "gather_pairs.cu", no_tpu),
             ("gather_front", src + "gather_pairs.cu", no_tpu),
             ("gather_front.sharded", src + "gather_pairs.cu", no_tpu),
             ("gather_sweep.sharded", src + "gather_pairs.cu", no_tpu),
             ("composite", src + "composite.cu",
              "none (XLA computes the upsample as matrix products and fuses "
              "the paste, egg_fluid_simulation_tpu/ops/render.py:652, :917)")]
    # kernel G has no caller on any path: its launches are its check's
    launches["splat_tiles"] = results["splat_tiles"]["launches"]
    # D and C on the spatial path: that phase's own launches
    launches["sweep_planes.spatial_1x1"] = spatial_launches["sweep_planes"]
    launches["splat.spatial_1x1"] = spatial_launches["splat"]
    # H on the gather path (the small-scene default): that phase's launches
    for n in ("gather_sweep", "gather_count", "gather_front"):
        launches[n] = results[n]["launches"]
    # H on the particle-sharded path: the replayed 65k steps' launches
    launches.update(sharded_launches)
    kernels = [dict(name=n, route="cuda", source=s, replaces=r,
                    launches=launches[n],
                    **{key: results[n][key] for key in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
               for n, s, r in table]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
