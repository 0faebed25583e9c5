"""SimulationHandler — the reference's public API over the PyTorch core.

The counterpart of ``egg_fluid_simulation_tpu/handler.py`` (API parity with
the reference ``simulation_handler.lua:9-459``): ``add`` / ``add_many``,
``remove``, ``update``, ``draw``, targets, configs, colours and queries.

Batch bookkeeping, validation and particle *creation* (fibonacci spiral,
butterworth masses) run on the host in numpy, bit for bit as in the JAX
package; the per-step compute runs on ``device`` (``ops/solver.py``,
``ops/render.py``). Live particles always occupy the prefix ``[0, count)``
of the fixed-capacity arrays.

On a CUDA device the fixed step of ``update``, ``step_once`` and the
loop routes of ``run_steps`` is captured once in a CUDA graph and replayed
(``ops/step_graph.py``); on the CPU it runs eagerly.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as config_mod
from .config import DeviceConfig, device_config_from_dict, stack_device_configs
from .ops import solver as solver_ops
from .ops.solver import SolverOptions
from .ops.step_graph import EAGER, StepGraphs
from .state import ParticleState, StepStats, WHITE, YOLK, zeros_state, zeros_stats
from .utils import log
from .utils.mathx import clamp, is_nan, mix

__all__ = ["SimulationHandler"]

_GOLDEN_RATIO = (1 + math.sqrt(5)) / 2
_GOLDEN_ANGLE = 2 * math.pi / (_GOLDEN_RATIO * _GOLDEN_RATIO)
_BIG = 3.4e38


def _fibonacci_spiral(n: int, x_radius: float, y_radius: float) -> np.ndarray:
    """Golden-angle disk fill (reference :907-918); returns (n, 2) offsets."""
    i = np.arange(1, n + 1, dtype=np.float64)
    r = np.sqrt((i - 1) / n)
    theta = i * _GOLDEN_ANGLE
    return np.stack([r * x_radius * np.cos(theta),
                     r * y_radius * np.sin(theta)], axis=-1).astype(np.float32)


def _mass_distribution_t(n: int, variance: float) -> np.ndarray:
    """Butterworth bell sampled with 2-pt Gauss-Legendre (reference :921-938)."""
    i = np.arange(1, n + 1, dtype=np.float64)
    left = (i - 0.5) / n
    right = (i + 0.5) / n
    center = 0.5 * (left + right)
    half_width = 0.5 * (right - left)
    t1 = center - half_width / math.sqrt(3)
    t2 = center + half_width / math.sqrt(3)

    def butterworth(t):
        return 1.0 / (1.0 + (variance * (t - 0.5)) ** 4)

    return (0.5 * (butterworth(t1) + butterworth(t2))).astype(np.float32)


@torch.no_grad()
def _compute_stats(state: ParticleState) -> StepStats:
    """Stats from current positions without stepping (post-add/remove reads)."""
    active = state.active_mask()
    pos = state.pos
    n_act = torch.clamp(torch.sum(active, dim=1), min=1)
    centroid = (torch.sum(torch.where(active[..., None], pos, 0.0), dim=1)
                / n_act[:, None])
    r = state.radius
    lo = torch.amin(torch.where(active[..., None], pos - r[..., None], _BIG),
                    dim=1)
    hi = torch.amax(torch.where(active[..., None], pos + r[..., None], -_BIG),
                    dim=1)
    speed = torch.sqrt(torch.sum(state.vel * state.vel, dim=-1))
    max_vel = torch.amax(torch.where(active, speed, 0.0), dim=1)
    max_rad = torch.clamp(torch.amax(torch.where(active, r, 0.0), dim=1),
                          min=1.0)
    sums = [solver_ops.batch_segment_sums(pos[i], active[i],
                                          state.batch_slot[i],
                                          state.max_batches)
            for i in range(2)]
    return StepStats(aabb_min=lo, aabb_max=hi, centroid=centroid,
                     last_centroid=centroid, max_radius=max_rad,
                     max_velocity=max_vel,
                     batch_pos_sum=torch.stack([s[0] for s in sums]),
                     batch_count=torch.stack([s[1] for s in sums]))


class SimulationHandler:
    """Egg-fluid simulation: any number of white+yolk particle batches.

    Parameters mirror the reference constructor (:425-459); keyword-only
    arguments set the static capacities and the ``device`` the state lives
    on (default ``"cuda"``; the kernels run there, and ``"cpu"`` runs their
    plain PyTorch versions). On a CUDA device the fixed step is replayed
    from a CUDA graph (``ops/step_graph.py``).
    """

    def __init__(self, white_config: Dict, yolk_config: Optional[Dict] = None, *,
                 capacity: int = 4096, max_batches: int = 256,
                 options: Optional[SolverOptions] = None,
                 canvas_size: Optional[int] = None,
                 jacobi_relaxation: float = 1.0,
                 render_post_mode: str = "coarse",
                 device="cuda"):
        if yolk_config is None:
            yolk_config = white_config  # :426
        log.assert_types(white_config, "table", yolk_config, "table")
        self._device = torch.device(device)

        self._white_config: Dict = {}
        self._yolk_config: Dict = {}
        config_mod.load_config(self._white_config, config_mod.copy_config(white_config), True)
        config_mod.load_config(self._yolk_config, config_mod.copy_config(yolk_config), False)

        # immutable knobs (:439-455)
        self._thresholding_threshold = 0.3
        self._thresholding_smoothness = 0.01
        self._mass_distribution_variance = 4.0
        self._use_particle_color = False
        self._use_lighting = True

        if render_post_mode not in ("coarse", "full", "super"):
            raise ValueError(f"render_post_mode {render_post_mode!r}")
        self._render_post_mode = render_post_mode

        self._capacity = int(capacity)
        self._auto_opts = options is None
        if options is None:
            options = self._auto_options([0, 0])
        self._options = options
        self._canvas_size = canvas_size
        self._jacobi_relaxation = float(jacobi_relaxation)

        self._max_batches = int(max_batches)
        # the captured steps: made at the first step on a CUDA device;
        # step_graph.EAGER steps eagerly there too (how a measurement times
        # the eager step beside the replayed one)
        self._step_graphs = None
        self._reinitialize()

    def _auto_options(self, counts) -> SolverOptions:
        """Solver options sized to the live particle counts (the JAX
        handler's rule).

        Below capacity 16384 the exact gather engine with the ordered budget
        and ``table_size = max(2048, min(16384, 2^ceil(log2(2 * max cap))))``;
        at 16384 and above the dense engine with the budget off (it costs a
        counting sweep and only binds below ~360 live particles), so those
        handlers run the fused path, on a grid of ``g^2 >= cap`` cells of
        K = 4 slots. Per-population slice caps are powers of two; a re-size
        keeps every field but the derived ones."""
        caps, grids = [], []
        for pop in (WHITE, YOLK):
            n = max(int(counts[pop]), 1)
            cap = 1 << max(10, int(math.ceil(math.log2(n))))
            cap = min(cap, self._capacity)
            caps.append(cap)
            g = 32
            while g * g < cap and g < 2048:
                g *= 2
            grids.append(g)
        kw = {}
        if hasattr(self, "_options"):
            derived = {"engine", "table_size", "dense_grid_dim",
                       "dense_slots", "pop_caps", "budget_mode"}
            kw = {f.name: getattr(self._options, f.name)
                  for f in dataclasses.fields(SolverOptions)
                  if f.name not in derived}
        if self._capacity >= 16384:
            return SolverOptions(engine="dense", dense_grid_dim=tuple(grids),
                                 dense_slots=4, budget_mode="off",
                                 pop_caps=tuple(caps), **kw)
        table = max(2048, min(16384, 1 << int(math.ceil(math.log2(2 * max(caps))))))
        return SolverOptions(engine="gather", table_size=table,
                             pop_caps=tuple(caps), **kw)

    def _refresh_auto_options(self) -> None:
        if self._auto_opts:
            new = self._auto_options(self._counts)
            if new != self._options:
                self._options = new

    # ------------------------------------------------------------ lifecycle --

    def _reinitialize(self) -> None:
        """Reset all simulation state (reference ``_reinitialize`` :465-563)."""
        self._wide_state = None
        self._state: ParticleState = zeros_state(self._capacity,
                                                 self._max_batches,
                                                 self._device)
        self._stats: StepStats = zeros_stats(self._max_batches, self._device)
        self._batches: Dict[int, dict] = {}
        self._current_batch_id = 1
        self._free_slots: List[int] = list(range(self._max_batches - 1, -1, -1))
        self._counts = [0, 0]
        self._host_targets = np.zeros((self._max_batches, 2), np.float32)
        self._targets_dirty = False
        self._elapsed = 0.0
        self._interpolation_alpha = 0.0
        self._frames: Optional[torch.Tensor] = None  # cached rendered frame
        self._frame_key = None
        self._render_k_boost = [1.0, 1.0]       # per-pop render-budget multiplier
        self._render_peak_density = [None, None]  # measured peak bin density
        self._render_audit: Optional[torch.Tensor] = None
        self._cfg2_cache: Optional[DeviceConfig] = None
        self._step_scalar_cache = None

    def _device_cfg2(self) -> DeviceConfig:
        # cached until a set_*_config invalidates it
        if self._cfg2_cache is None:
            self._cfg2_cache = stack_device_configs(
                device_config_from_dict(self._white_config, self._device),
                device_config_from_dict(self._yolk_config, self._device))
        return self._cfg2_cache

    def _step_scalars(self, step_delta: float):
        key = (float(step_delta), self._jacobi_relaxation)
        if self._step_scalar_cache is None or self._step_scalar_cache[0] != key:
            f32 = dict(dtype=torch.float32, device=self._device)
            self._step_scalar_cache = (key, (
                torch.tensor(step_delta, **f32),
                torch.tensor(self._jacobi_relaxation, **f32)))
        return self._step_scalar_cache[1]

    # ------------------------------------------------------------------ add --

    def add(self, x, y, white_radius=None, yolk_radius=None,
            white_color=None, yolk_color=None,
            white_n_particles=None, yolk_n_particles=None) -> int:
        """Add a new egg batch; returns its integer id (reference :27-135)."""
        return self.add_many([dict(
            x=x, y=y, white_radius=white_radius, yolk_radius=yolk_radius,
            white_color=white_color, yolk_color=yolk_color,
            white_n_particles=white_n_particles,
            yolk_n_particles=yolk_n_particles)])[0]

    def add_many(self, specs: List[Dict]) -> List[int]:
        """Add many batches with ONE upload per field (bulk ``add``).

        Each spec is a dict of :meth:`add`'s keyword arguments."""
        if not specs:
            return []
        prepared = [self._validate_spawn(**spec) for spec in specs]

        if len(self._free_slots) < len(prepared):
            log.error("In SimulationHandler.add: exceeded max_batches capacity of `",
                      self._max_batches, "`")
        need = [sum(p[f"{nm}_n_particles"] for p in prepared)
                for nm in ("white", "yolk")]
        if (self._counts[WHITE] + need[WHITE] > self._capacity
                or self._counts[YOLK] + need[YOLK] > self._capacity):
            log.error("In SimulationHandler.add: exceeded particle capacity of `",
                      self._capacity, "`; construct with a larger `capacity`")

        # a spawn is a fresh violent transient: restart the wide-sweep episode
        self._wide_state = None

        ids: List[int] = []
        slots: List[int] = []
        rad2: List[Tuple[float, float]] = []
        targets: List[Tuple[float, float]] = []
        fields = ("pos", "radius", "mass_t", "inv_mass", "batch_slot", "color")
        cols = {WHITE: {k: [] for k in fields}, YOLK: {k: [] for k in fields}}
        for p in prepared:
            slot = self._free_slots.pop()
            batch_id = self._current_batch_id
            self._current_batch_id += 1
            for pop, nm, cfg in ((WHITE, "white", self._white_config),
                                 (YOLK, "yolk", self._yolk_config)):
                n = p[f"{nm}_n_particles"]
                rad = p[f"{nm}_radius"]
                color = p[f"{nm}_color"]
                offsets = _fibonacci_spiral(n, rad, rad)
                t = _mass_distribution_t(n, self._mass_distribution_variance)
                mass = np.maximum(mix(cfg["min_mass"], cfg["max_mass"], t), 1e-12)
                radius = mix(cfg["min_radius"], cfg["max_radius"], t)
                c = cols[pop]
                c["pos"].append(np.array([p["x"], p["y"]], np.float32) + offsets)
                c["radius"].append(radius.astype(np.float32))
                c["mass_t"].append(t)
                c["inv_mass"].append((1.0 / mass).astype(np.float32))
                c["batch_slot"].append(np.full((n,), slot, np.int32))
                c["color"].append(
                    np.tile(np.asarray(color, np.float32), (n, 1))
                    if self._use_particle_color else np.ones((n, 4), np.float32))
            self._host_targets[slot] = (p["x"], p["y"])
            self._batches[batch_id] = {
                "slot": slot,
                "n_white": p["white_n_particles"],
                "n_yolk": p["yolk_n_particles"],
                "white_color": list(p["white_color"]),
                "yolk_color": list(p["yolk_color"]),
                "target": (float(p["x"]), float(p["y"])),
            }
            ids.append(batch_id)
            slots.append(slot)
            rad2.append((p["white_radius"], p["yolk_radius"]))
            targets.append((float(p["x"]), float(p["y"])))

        state = self._state
        dev = self._device
        upd = {}
        for field in fields + ("prev", "last_pos", "vel"):
            src = "pos" if field in ("prev", "last_pos", "vel") else field
            arr = getattr(state, field).clone()
            for pop in (WHITE, YOLK):
                seg = np.concatenate(cols[pop][src], axis=0)
                if field == "vel":  # rows re-used after remove() hold stale values
                    seg = np.zeros_like(seg)
                sl = slice(self._counts[pop], self._counts[pop] + len(seg))
                arr[pop, sl] = torch.from_numpy(seg).to(dev)
            upd[field] = arr
        for pop in (WHITE, YOLK):
            self._counts[pop] += need[pop]

        slots_t = torch.tensor(slots, dtype=torch.int64, device=dev)
        batch_target = state.batch_target.clone()
        batch_target[slots_t] = torch.tensor(targets, dtype=torch.float32,
                                             device=dev)
        batch_radius = state.batch_radius.clone()
        batch_radius[:, slots_t] = torch.tensor(rad2, dtype=torch.float32,
                                                device=dev).T
        batch_used = state.batch_used.clone()
        batch_used[slots_t] = True
        self._state = state.replace(
            count=torch.tensor(self._counts, dtype=torch.int32, device=dev),
            batch_target=batch_target, batch_radius=batch_radius,
            batch_used=batch_used, **upd)
        self._stats = _compute_stats(self._state)
        self._frames = None
        self._refresh_auto_options()
        return ids

    def _validate_spawn(self, x, y, white_radius=None, yolk_radius=None,
                        white_color=None, yolk_color=None,
                        white_n_particles=None, yolk_n_particles=None) -> Dict:
        """Validation + derivation half of ``add`` (reference :27-120):
        returns the normalized spawn spec, touching no state."""
        wcfg, ycfg = self._white_config, self._yolk_config
        white_particle_radius = mix(wcfg["min_radius"], wcfg["max_radius"], 0.5)
        yolk_particle_radius = mix(ycfg["min_radius"], ycfg["max_radius"], 0.5)

        if white_radius is None:
            white_radius = white_particle_radius * 15          # :41-43
        if yolk_radius is None:
            yolk_radius = white_radius * (10 / 50)             # :45-47
        white_color = list(white_color) if white_color is not None else list(wcfg["color"])
        yolk_color = list(yolk_color) if yolk_color is not None else list(ycfg["color"])

        if white_n_particles is None:
            white_n_particles = math.ceil(white_radius ** 2 / white_particle_radius ** 2)  # :52-55
        if yolk_n_particles is None:
            yolk_n_particles = math.ceil(yolk_radius ** 2 / yolk_particle_radius ** 2)

        log.assert_types(x, "number", y, "number",
                         white_radius, "number", yolk_radius, "number",
                         white_color, "table", yolk_color, "table",
                         white_n_particles, "number", yolk_n_particles, "number")
        if white_radius <= 0:
            log.error("In SimulationHandler.add: white radius cannot be 0 or negative")
        if yolk_radius <= 0:
            log.error("In SimulationHandler.add: yolk radius cannot be 0 or negative")
        if white_n_particles <= 1:
            log.error("In SimulationHandler.add: white particle count cannot be 1 or negative")
        if yolk_n_particles <= 1:
            log.error("In SimulationHandler.add: yolk particle count cannot be 1 or negative")

        for name, color in (("white", white_color), ("yolk", yolk_color)):
            if len(color) != 4:
                log.error("In SimulationHandler.add: ", name, " color must have 4 components")
            for ci, c in enumerate(color):
                if isinstance(c, bool) or not isinstance(c, (int, float)) or is_nan(c):
                    log.error("In SimulationHandler.add: ", name, " color component `",
                              "rgba"[ci], "` is not a number")
                if c < 0 or c > 1:
                    log.warning("In SimulationHandler.add: ", name, " color component `",
                                "rgba"[ci], "` is outside of [0, 1]")
                color[ci] = clamp(float(c), 0.0, 1.0)

        if white_n_particles < 10:
            log.warning("In SimulationHandler.add: trying to add white of radius `",
                        white_radius, "`, but the white particle radius is `~",
                        white_particle_radius, "`, so only `", white_n_particles,
                        "` particles will be created. Consider increasing the white "
                        "radius or decreasing the white particle size")
        if yolk_n_particles < 5:
            log.warning("In SimulationHandler.add: trying to add yolk of radius `",
                        yolk_radius, "`, but the yolk particle radius is `~",
                        yolk_particle_radius, "`, so only `", yolk_n_particles,
                        "` particles will be created. Consider increasing the yolk "
                        "radius or decreasing the yolk particle size")

        return dict(x=float(x), y=float(y),
                    white_radius=float(white_radius),
                    yolk_radius=float(yolk_radius),
                    white_color=white_color, yolk_color=yolk_color,
                    white_n_particles=int(white_n_particles),
                    yolk_n_particles=int(yolk_n_particles))

    # --------------------------------------------------------------- remove --

    def remove(self, batch_id) -> None:
        """Remove a batch and compact particle storage (reference :140-155, :1037-1106)."""
        log.assert_types(batch_id, "number")
        batch = self._batches.get(batch_id)
        if batch is None:
            log.warning("In SimulationHandler.remove: no batch with id `", batch_id, "`")
            return

        slot = batch["slot"]
        state = self._state
        batch_slot_host = state.batch_slot.cpu().numpy()

        new_counts = list(self._counts)
        perms = []
        for pop in (WHITE, YOLK):
            n = self._counts[pop]
            keep = np.nonzero(batch_slot_host[pop, :n] != slot)[0]
            # survivors first, order preserved (the reference's stable
            # prefix-sum compaction), then the free tail
            tail = np.arange(n, self._capacity)
            perm = np.concatenate([keep, np.setdiff1d(np.arange(n), keep,
                                                      assume_unique=True), tail])
            perms.append(torch.from_numpy(perm.astype(np.int64)).to(self._device))
            new_counts[pop] = int(keep.size)

        def permute(arr):
            return torch.stack([arr[0][perms[0]], arr[1][perms[1]]])

        batch_used = state.batch_used.clone()
        batch_used[slot] = False
        self._state = state.replace(
            pos=permute(state.pos), prev=permute(state.prev),
            vel=permute(state.vel), last_pos=permute(state.last_pos),
            radius=permute(state.radius), mass_t=permute(state.mass_t),
            inv_mass=permute(state.inv_mass), batch_slot=permute(state.batch_slot),
            color=permute(state.color),
            count=torch.tensor(new_counts, dtype=torch.int32, device=self._device),
            batch_used=batch_used)
        self._counts = new_counts
        del self._batches[batch_id]
        self._free_slots.append(slot)
        self._stats = _compute_stats(self._state)
        self._frames = None
        self._refresh_auto_options()

    # --------------------------------------------------------------- update --

    def update(self, delta, step_delta=None, n_substeps=None, n_collision_steps=None) -> None:
        """Fixed-timestep driver (reference :168-222): accumulate ``delta``,
        run whole steps at ``step_delta``, death-spiral cap, interpolation alpha."""
        if step_delta is None:
            step_delta = 1 / 60
        if n_substeps is None:
            n_substeps = self._options.n_substeps
        if n_collision_steps is None:
            n_collision_steps = self._options.n_collision_steps
        log.assert_types(delta, "number", step_delta, "number",
                         n_substeps, "number", n_collision_steps, "number")
        n_substeps = math.ceil(n_substeps)
        n_collision_steps = math.ceil(n_collision_steps)
        if step_delta < 0 or is_nan(step_delta):
            log.error("In SimulationHandler.update: `step_delta` is not a number > 0")
        if n_substeps < 1:
            log.error("In SimulationHandler.update: `n_substeps` is not a number > 0")
        if n_collision_steps < 1:
            log.error("In SimulationHandler.update: `n_collision_steps` is not a number > 0")

        if (n_substeps != self._options.n_substeps
                or n_collision_steps != self._options.n_collision_steps):
            self._options = replace(self._options, n_substeps=n_substeps,
                                    n_collision_steps=n_collision_steps)

        self._flush_targets()
        self._check_caps()
        cfg2 = self._device_cfg2()
        dt, relax = self._step_scalars(step_delta)

        self._elapsed += delta
        n_steps = 0
        max_n_steps = max(4, 4 * math.ceil((1 / 60) / step_delta))  # :203
        while self._elapsed >= step_delta:
            self._elapsed -= step_delta
            n_steps += 1
            if n_steps > max_n_steps:
                self._elapsed = 0.0
                break
        if n_steps:
            self._advance(n_steps, cfg2, dt, relax)

        self._interpolation_alpha = clamp(self._elapsed / step_delta, 0.0, 1.0)
        if n_steps:
            self._frames = None  # canvases dirty (:1984)

    def warmup(self, viewport=(0.0, 0.0, 800, 600)) -> None:
        """Build the kernel library (on a CUDA device) and run one step,
        which captures the fixed step there, and one draw, so the first
        frame pays none of it (the reference's shader
        warm-up draw, simulation_handler.lua:600-615). The state, stats,
        time accumulator and interpolation alpha are restored afterwards;
        as in the JAX package, the wide-sweep episode state keeps the
        step's update."""
        if self._device.type == "cuda":
            from .ops.kernels import library
            library.load()
        saved = (self._state, self._stats, self._elapsed,
                 self._interpolation_alpha)
        self.step_once(1 / 60)
        self.draw(viewport=viewport)
        (self._state, self._stats, self._elapsed,
         self._interpolation_alpha) = saved
        self._frames = None

    def step_once(self, step_delta: float = 1 / 60) -> None:
        """Advance exactly one fixed step (benchmark/test convenience)."""
        self._flush_targets()
        self._check_caps()
        dt, relax = self._step_scalars(step_delta)
        self._advance(1, self._device_cfg2(), dt, relax)
        self._frames = None

    def run_steps(self, n_steps: int, step_delta: float = 1 / 60) -> None:
        """Advance ``n_steps`` fixed steps (headless fast-forward): through
        ``solver.multi_step`` where the binned layout stays resident across
        the steps, else as ``n_steps`` fixed steps (on a CUDA device the
        captured step replayed), which is what ``multi_step`` gives there.
        A no-op for ``n_steps <= 0``."""
        if n_steps <= 0:
            return
        self._flush_targets()
        self._check_caps()
        dt, relax = self._step_scalars(step_delta)
        if solver_ops.multi_step_is_loop(self._options):
            self._advance(int(n_steps), self._device_cfg2(), dt, relax)
        else:
            self._state, self._stats, self._wide_state = solver_ops.multi_step(
                self._state, self._device_cfg2(), dt, relax, self._options,
                int(n_steps), wide_state=self._wide_or_init())
        self._frames = None

    def _graphs(self) -> Optional[StepGraphs]:
        """The handler's captured steps, made at the first step on a CUDA
        device; None on the CPU and while ``_step_graphs`` is
        ``step_graph.EAGER``, where steps run eagerly (a test may set
        ``_step_graphs`` to ``StepGraphs(capture=False)`` to run the graph
        plumbing on the CPU)."""
        if self._step_graphs is EAGER:
            return None
        if self._step_graphs is None and self._device.type == "cuda":
            self._step_graphs = StepGraphs()
        return self._step_graphs

    def _advance(self, n_steps: int, cfg2, dt, relax) -> None:
        """``n_steps >= 1`` calls of ``solver.step`` from the handler's state,
        the episode state of the wide gate threaded through: on a CUDA device
        one captured step replayed (``ops/step_graph.py``), on the CPU
        eagerly."""
        wide = self._wide_or_init()
        graphs = self._graphs()
        if graphs is not None:
            self._state, self._stats, self._wide_state = graphs.run(
                self._state, cfg2, dt, relax, self._options, wide, n_steps)
            return
        for _ in range(n_steps):
            self._state, self._stats, wide = solver_ops.step(
                self._state, cfg2, dt, relax, self._options, wide_state=wide)
        self._wide_state = wide

    def _wide_or_init(self):
        """Persisted violence-episode state of the wide-sweep gate; reset by
        add() so a fresh spawn explosion starts a new episode."""
        if self._wide_state is None:
            self._wide_state = (
                solver_ops.wide_state_init(self._options, self._device),
                solver_ops.wide_state_init(self._options, self._device))
        return self._wide_state

    def _check_caps(self) -> None:
        """Enforce the SolverOptions.pop_caps invariant (cap >= live count)."""
        caps = self._options.pop_caps
        if caps is None:
            return
        for pop, name in ((WHITE, "white"), (YOLK, "yolk")):
            if caps[pop] < self._counts[pop]:
                log.error("In SimulationHandler: options.pop_caps[", name,
                          "] = `", caps[pop], "` is smaller than the live ",
                          name, " particle count `", self._counts[pop],
                          "`; particles beyond the cap would never be stepped")

    def _flush_targets(self) -> None:
        if self._targets_dirty:
            self._state = self._state.replace(
                batch_target=torch.from_numpy(self._host_targets.copy()).to(
                    self._device))
            self._targets_dirty = False

    # --------------------------------------------------------------- render --

    def draw(self, viewport=None, background=None, check_overflow=True):
        """Render all batches to an (H, W, 4) float32 RGBA tensor on the
        handler's device (reference ``draw`` :159-162). ``viewport`` is
        ``(x, y, w, h)`` in world px. Repeated draws without an intervening
        step/recolor return the cached frame (:1996-1999).
        ``check_overflow`` (default ON) audits the per-bin render budget and
        auto-bumps it until the frame drops zero particles."""
        from .ops import render as render_ops
        key = (tuple(viewport) if viewport is not None else None,
               tuple(background) if background is not None else None,
               self._interpolation_alpha, bool(check_overflow))
        if self._frames is not None and self._frame_key == key:
            return self._frames
        frame = render_ops.draw(self, viewport=viewport, background=background,
                                check_overflow=check_overflow)
        self._frames = frame
        self._frame_key = key
        return frame

    def seed_render_budget(self) -> None:
        """Measure peak render-bin occupancy host-side and keep it as the
        per-bin splat budget hint, so the first draw of a clustered scene is
        sized right without an auto-bump re-render."""
        from .ops import render as render_ops
        opts2 = render_ops.frame_options(self)
        active = self._state.active_mask().cpu().numpy()
        pos_all = self._state.pos.cpu().numpy()
        dens = list(self._render_peak_density)
        for i in range(2):
            o = opts2[i]
            wh = o.bin_h * o.downsample          # bin window in full-res px
            ww = o.bin_w * o.downsample
            pos = pos_all[i][active[i]]
            if pos.shape[0] == 0:
                continue
            # max over a 2x2 set of half-bin-shifted grids: the render's bins
            # are anchored to the canvas origin, which is not known here
            peak = 0
            for sy in (0.0, 0.5 * wh):
                for sx in (0.0, 0.5 * ww):
                    by = np.floor((pos[:, 1] + sy) / wh).astype(np.int64)
                    bx = np.floor((pos[:, 0] + sx) / ww).astype(np.int64)
                    by -= by.min()
                    bx -= bx.min()
                    cnt = np.bincount(by * (int(bx.max()) + 1) + bx)
                    peak = max(peak, int(cnt.max()))
            dens[i] = float(peak) / float(wh * ww)
        self._render_peak_density = dens

    # ----------------------------------------------------------- configs --

    def set_white_config(self, config: Dict) -> None:
        log.assert_types(config, "table")
        config_mod.load_config(self._white_config, config, True)
        self._cfg2_cache = None
        self._frames = None

    def set_yolk_config(self, config: Dict) -> None:
        log.assert_types(config, "table")
        config_mod.load_config(self._yolk_config, config, False)
        self._cfg2_cache = None
        self._frames = None

    def get_white_config(self) -> Dict:
        return config_mod.copy_config(self._white_config)

    def get_yolk_config(self) -> Dict:
        return config_mod.copy_config(self._yolk_config)

    # ----------------------------------------------------------- targets --

    def set_target_position(self, batch_id, x, y) -> None:
        log.assert_types(batch_id, "number", x, "number", y, "number")
        batch = self._batches.get(batch_id)
        if batch is None:
            log.warning("In SimulationHandler.set_target_position: no batch with id `",
                        batch_id, "`")
            return
        batch["target"] = (float(x), float(y))
        self._host_targets[batch["slot"]] = (x, y)
        self._targets_dirty = True

    def get_target_position(self, batch_id) -> Tuple[Optional[float], Optional[float]]:
        log.assert_types(batch_id, "number")
        batch = self._batches.get(batch_id)
        if batch is None:
            log.error("In SimulationHandler.get_target_position: no batch with id `",
                      batch_id, "`")
        return batch["target"]

    def get_position(self, batch_id) -> Tuple[Optional[float], Optional[float]]:
        """Mean position of all (white + yolk) particles of a batch (:281-295)."""
        log.assert_types(batch_id, "number")
        batch = self._batches.get(batch_id)
        if batch is None:
            log.error("In SimulationHandler.get_position: no batch with id `",
                      batch_id, "`")
        c = self._stats.batch_centroid(batch["slot"]).cpu().numpy()
        return float(c[0]), float(c[1])

    # ------------------------------------------------------------- colors --

    def _assert_color(self, scope, r, g, b, a):
        if a is None:
            a = 1.0
        log.assert_types(r, "number", g, "number", b, "number", a, "number")
        if not all(0 <= c <= 1 for c in (r, g, b, a)):
            log.warning("In SimulationHandler.", scope,
                        ": color component is outside of [0, 1]")
        return tuple(clamp(float(c), 0.0, 1.0) for c in (r, g, b, a))

    def _set_color(self, pop: int, key: str, scope: str, batch_id,
                   r, g, b, a, outline) -> None:
        log.assert_types(batch_id, "number")
        rgba = self._assert_color(scope, r, g, b, a)
        cfg = self._white_config if pop == WHITE else self._yolk_config
        oc = [outline[i] if outline[i] is not None else cfg["outline_color"][i]
              for i in range(4)]
        # validated but, as in the reference (:328-357 never stores them), the
        # outline override is not persisted — outline draws with the config color
        self._assert_color(scope, *oc)

        batch = self._batches.get(batch_id)
        if batch is None:
            log.warning("In SimulationHandler.", scope, ": no batch with id `",
                        batch_id, "`")
            return
        batch[key] = list(rgba)
        mask = self._state.batch_slot[pop] == batch["slot"]
        color = self._state.color.clone()
        color[pop] = torch.where(
            mask[:, None],
            torch.tensor(rgba, dtype=torch.float32, device=self._device),
            color[pop])
        self._state = self._state.replace(color=color)
        self._frames = None

    def set_white_color(self, batch_id, r, g, b, a=None,
                        outline_r=None, outline_g=None, outline_b=None, outline_a=None):
        self._set_color(WHITE, "white_color", "set_white_color", batch_id,
                        r, g, b, a, (outline_r, outline_g, outline_b, outline_a))

    def set_yolk_color(self, batch_id, r, g, b, a=None,
                       outline_r=None, outline_g=None, outline_b=None, outline_a=None):
        # the scope name is the JAX package's, so the warnings compare equal
        self._set_color(YOLK, "yolk_color", "set_egg_yolk_color", batch_id,
                        r, g, b, a, (outline_r, outline_g, outline_b, outline_a))

    # ------------------------------------------------------------ queries --

    def list_ids(self) -> List[int]:
        return list(self._batches.keys())

    def get_n_particles(self, batch_or_nil=None):
        if batch_or_nil is None:
            return self._counts[WHITE], self._counts[YOLK]
        batch = self._batches.get(batch_or_nil)
        if batch is None:
            log.error("In SimulationHandler.get_n_particles: no batch with id `",
                      batch_or_nil, "`")
        return batch["n_white"], batch["n_yolk"]

    # ---------------------------------------------------------- inspection --

    @property
    def state(self) -> ParticleState:
        return self._state

    @property
    def stats(self) -> StepStats:
        return self._stats

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def interpolation_alpha(self) -> float:
        return self._interpolation_alpha

    @property
    def render_audit(self) -> Optional[np.ndarray]:
        """(2, 2) int [dropped past the per-bin budget, peak bin occupancy]
        per population of the last rendered frame (None before a draw)."""
        if self._render_audit is None:
            return None
        return self._render_audit.cpu().numpy()
