"""SpatialHandler — the multi-device SimulationHandler.

The counterpart of ``egg_fluid_simulation_tpu/parallel/spatial_handler.py``:
the public API of :class:`~egg_fluid_simulation_tpu_torch.SimulationHandler`
(``add``, ``remove``, ``update``, ``run_steps``, ``draw``,
``set_target_position``, ``set_*_config``, ``set_*_color``,
``get_position``, ``get_n_particles``, ``list_ids``) running the dense
engine over a ``(bands x blocks)`` mesh of ranks (:mod:`.spatial`).

Every rank runs the same calls (SPMD): the host bookkeeping is replicated.

- **Host bookkeeping lives in an inner SimulationHandler** on the rank's
  device: batch creation, the id registry, validation and the config stores
  are the single-device product's; only stepping and rendering are replaced
  by their sharded counterparts.
- **Layout laziness.** ``add`` / ``remove`` / recolour mutate the inner
  prefix-contiguous state; :func:`~.spatial.redistribute` (re-)establishes
  the ownership layout on the next step. While a spatial state is live,
  mutating calls first pull it back into the prefix layout
  (``_sync_inner``, an all-gather).
- **Automatic migration recovery.** Every update reads the step's migration
  counters on the host (one read a call, the rebins of the call with them);
  dropped particles or an in-transit backlog above 5% of the live ones
  trigger a warning and a full ``redistribute``. In transit means outside
  the rank's window: a particle over its cell's budget is not counted (the
  JAX package counts it, and so redistributes a packed scene at every call
  on one rank, where a redistribute changes nothing).
- **Audited draws.** ``draw`` renders with the inner handler's render
  settings and goes through ``SimulationHandler.draw``'s budget, audit and
  background path (``render.draw``) with the inner handler's render budget,
  on the audit combined over the mesh (the JAX package's spatial draw
  ignores the settings and drops splats past the budget unannounced).
- **Resident fast-forward.** ``run_steps`` (and an ``update`` of more than
  one step) uses the resident steps of :func:`~.spatial.spatial_multi_step`.
- **Graph replays on a card.** ``update``, ``step_once``, ``run_steps`` and
  ``draw`` replay the step, the resident steps and the frame from CUDA
  graphs (:mod:`.spatial_graph`), the rebin decision taken on the card; on
  the CPU (and while ``_spatial`` is ``step_graph.EAGER``) they run
  eagerly, the rebin decision read on the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..handler import SimulationHandler, _compute_stats
from ..ops import render as render_ops
from ..ops.solver import SolverOptions
from ..ops.step_graph import EAGER
from ..state import ParticleState
from ..utils import log
from . import spatial as S
from .mesh import make_spatial_mesh
from .sharding import unshard_state
from .spatial_graph import SpatialGraphs

__all__ = ["SpatialHandler"]


def _cell_sizes(white_cfg: Dict, yolk_cfg: Dict) -> Tuple[float, float]:
    sizes = []
    for cfg in (white_cfg, yolk_cfg):
        f = max(cfg["collision_overlap_factor"],
                cfg["cohesion_interaction_distance_factor"])
        sizes.append(max(1.0, cfg["max_radius"] * f))
    return tuple(sizes)


class SpatialHandler:
    """Egg-fluid simulation over a 2D spatial mesh of ranks. ``device``: the
    rank's device (``"cuda"``: the card of its local rank; ``"cpu"``: gloo
    ranks, the kernels' plain versions). A ``db * dx > 1`` mesh needs a
    process group of that many ranks (``torchrun``); a 1 x 1 mesh starts a
    one-rank group when none runs."""

    def __init__(self, white_config: Dict, yolk_config: Optional[Dict] = None,
                 *, db: int = 1, dx: int = 1, device="cuda",
                 capacity: int = 8192, max_batches: int = 256,
                 options: Optional[SolverOptions] = None,
                 layout: Optional[S.SpatialLayout] = None,
                 migrate_cap: Optional[int] = None,
                 canvas_size: Optional[int] = None,
                 auto_redistribute: bool = True):
        n_dev = db * dx
        if capacity % n_dev != 0:
            capacity += n_dev - capacity % n_dev
        if options is None:
            g = 32
            while g * g * 4 < capacity and g < 1024:
                g *= 2
            options = SolverOptions(engine="dense", budget_mode="off",
                                    dense_rebin="step", dense_grid_dim=g,
                                    dense_slots=4)
        if not (options.engine == "dense" and options.budget_mode == "off"):
            raise ValueError("SpatialHandler requires the dense engine with "
                             "budget_mode='off'")
        g0, g1 = options.dense_grid_dim
        if g0 != g1:
            raise ValueError("the spatial layout shares one grid across "
                             "populations")
        self._options = options
        if layout is None:
            layout = S.SpatialLayout(
                grid_dim=g0, slots_per_cell=options.dense_slots[0],
                db=db, dx=dx,
                migrate_cap=migrate_cap or max(64, capacity // (4 * n_dev)))
        layout.check()
        self._layout = layout
        self._mesh = make_spatial_mesh(layout.db, layout.dx, device)

        # inner handler: host bookkeeping + prefix-contiguous state
        self._inner = SimulationHandler(
            white_config, yolk_config, capacity=capacity,
            max_batches=max_batches, options=options,
            canvas_size=canvas_size, device=self._mesh.device)
        self._auto_redistribute = bool(auto_redistribute)
        self._sp_state: Optional[ParticleState] = None
        self._sp_stats = None
        self._sp_wide = None
        self._elapsed = 0.0
        self._interpolation_alpha = 0.0
        self._step_fn = None
        self._multi_fn = None
        self._draw_cache = {}
        self._spatial = None    # SpatialGraphs on a card (first call)
        self._last_info = None
        self._redistribute_count = 0

    @classmethod
    def from_handler(cls, inner: SimulationHandler, *, db: int = 1,
                     dx: int = 1, device=None, layout=None,
                     migrate_cap=None) -> "SpatialHandler":
        """Wrap an existing :class:`SimulationHandler` (e.g. restored by
        ``checkpoint.load(path, options=dense_options)``) as the inner state
        of a spatial handler on a ``db x dx`` mesh. Its options must meet
        the spatial preconditions (dense engine, ``budget_mode='off'``, one
        shared grid)."""
        if inner._capacity % (db * dx) != 0:
            raise ValueError("inner capacity must divide evenly across the "
                             "mesh")
        self = cls(inner.get_white_config(), inner.get_yolk_config(),
                   db=db, dx=dx,
                   device=inner.device if device is None else device,
                   capacity=inner._capacity, max_batches=inner._max_batches,
                   options=inner._options, layout=layout,
                   migrate_cap=migrate_cap, canvas_size=inner._canvas_size)
        self._inner = inner    # adopt state + batch registry wholesale; the
        self._sp_state = None  # sharded layout re-establishes lazily
        self._elapsed = getattr(inner, "_elapsed", 0.0)
        self._interpolation_alpha = getattr(inner, "_interpolation_alpha",
                                            0.0)
        return self

    # ----------------------------------------------------------- layout --

    def _cell_sizes(self):
        return _cell_sizes(self._inner._white_config,
                           self._inner._yolk_config)

    def _ensure_spatial(self) -> None:
        """(Re-)establish the ownership layout from the inner state."""
        if self._sp_state is None:
            self._inner._flush_targets()
            self._sp_state = S.redistribute(
                self._inner.state, self._cell_sizes(), self._layout,
                self._mesh)
            self._sp_stats = None

    def _sync_inner(self) -> None:
        """Pull a live spatial state back into the inner prefix layout (an
        all-gather: every rank must call it). Called before any host
        mutation (add / remove / recolour / checkpoint), so the inner
        handler's arrays hold the simulated positions."""
        if self._sp_state is None:
            return
        full = unshard_state(self._sp_state, self._mesh)
        st = self._inner._state
        counts = self._inner._counts
        live = [np.nonzero(full.batch_slot[i].cpu().numpy() >= 0)[0]
                for i in range(2)]
        for i in range(2):
            if live[i].size != counts[i]:
                raise RuntimeError(
                    f"spatial live count {live[i].size} != handler count "
                    f"{counts[i]} (population {i})")
        upd = {}
        for f in ("pos", "prev", "vel", "last_pos", "radius", "mass_t",
                  "inv_mass", "batch_slot", "color"):
            arr = getattr(st, f).cpu().numpy().copy()
            src = getattr(full, f).cpu().numpy()
            for i in range(2):
                arr[i][:counts[i]] = src[i][live[i]]
                if f == "batch_slot":
                    # slots past the live prefix stay valid (>= 0) in the
                    # prefix layout, as in a fresh handler state
                    arr[i][counts[i]:] = 0
            upd[f] = torch.from_numpy(arr).to(self._mesh.device)
        self._inner._state = st.replace(**upd)
        self._inner._stats = _compute_stats(self._inner._state)
        self._inner._frames = None
        self._sp_state = None
        self._sp_wide = None   # population changed: a fresh violence episode

    # --------------------------------------------------------- lifecycle --

    def add(self, *args, **kw) -> int:
        self._sync_inner()
        return self._inner.add(*args, **kw)

    def remove(self, batch_id) -> None:
        self._sync_inner()
        self._inner.remove(batch_id)

    # ----------------------------------------------------------- configs --

    def set_white_config(self, config: Dict) -> None:
        self._sync_inner()  # the cell size may change: re-layout
        self._inner.set_white_config(config)

    def set_yolk_config(self, config: Dict) -> None:
        self._sync_inner()
        self._inner.set_yolk_config(config)

    def get_white_config(self) -> Dict:
        return self._inner.get_white_config()

    def get_yolk_config(self) -> Dict:
        return self._inner.get_yolk_config()

    # ----------------------------------------------------------- targets --

    def set_target_position(self, batch_id, x, y) -> None:
        # targets are replicated: no re-layout; flushed into the live state
        self._inner.set_target_position(batch_id, x, y)
        if self._sp_state is not None and self._inner._targets_dirty:
            self._sp_state = self._sp_state.replace(
                batch_target=torch.from_numpy(
                    self._inner._host_targets.copy()).to(self._mesh.device))
            self._inner._targets_dirty = False

    def get_target_position(self, batch_id):
        return self._inner.get_target_position(batch_id)

    def set_white_color(self, *args, **kw) -> None:
        self._sync_inner()
        self._inner.set_white_color(*args, **kw)

    def set_yolk_color(self, *args, **kw) -> None:
        self._sync_inner()
        self._inner.set_yolk_color(*args, **kw)

    # ------------------------------------------------------------ update --

    def _fns(self):
        if self._step_fn is None:
            self._step_fn = S.spatial_step(self._mesh, self._layout,
                                           self._options)
            self._multi_fn = S.spatial_multi_step(self._mesh, self._layout,
                                                  self._options)
        return self._step_fn, self._multi_fn

    def _spatial_graphs(self):
        """The handler's captured step, resident steps and draws on a card
        (made at the first call); None on the CPU and while ``_spatial`` is
        ``step_graph.EAGER`` (the eager route)."""
        if self._spatial is EAGER:
            return None
        if self._spatial is None:
            if self._mesh.device.type != "cuda":
                return None
            self._spatial = SpatialGraphs(self._mesh, self._layout,
                                          self._options)
        return self._spatial

    def _step(self, step_delta) -> None:
        """One :func:`~.spatial.spatial_step`."""
        cfg2 = self._inner._device_cfg2()
        dt, relax = self._inner._step_scalars(step_delta)
        graphs = self._spatial_graphs()
        if graphs is None:
            step, _ = self._fns()
            self._sp_state, self._sp_stats, info = step(
                self._sp_state, cfg2, dt, relax)
        else:
            self._sp_state, self._sp_stats, info = graphs.step(
                self._sp_state, cfg2, dt, relax)
        self._after_step(info)

    def _steps(self, n_steps: int, step_delta) -> None:
        """``n_steps`` resident steps (:func:`~.spatial.spatial_multi_step`)."""
        cfg2 = self._inner._device_cfg2()
        dt, relax = self._inner._step_scalars(step_delta)
        graphs = self._spatial_graphs()
        if graphs is None:
            _, multi = self._fns()
            self._sp_state, self._sp_stats, info, self._sp_wide = multi(
                self._sp_state, cfg2, dt, relax, n_steps,
                wide_state=self._sp_wide)
            taken = None
        else:
            (self._sp_state, self._sp_stats, info, self._sp_wide,
             taken) = graphs.steps(self._sp_state, cfg2, dt, relax, n_steps,
                                   wide_state=self._sp_wide)
        self._after_step(info, taken)

    def _after_step(self, info, taken=None) -> None:
        """Migration-health recovery, from the step's counters read on the
        host (the same on every rank; ``taken``, the replayed loop's rebins,
        in the same read, for the branches' collective bytes):

        - dropped > 0: a receiver ran out of free slots and those rows are
          gone from the device state; lay the survivors out again;
        - an in-transit backlog above 5% of the live particles: the one-hop
          ring (``migrate_cap`` a direction) cannot keep up, e.g. with a
          teleported clump; in-transit particles (outside their rank's
          window) integrate without collision, so the host redistribute
          places everyone at once. Particles over their cell's budget also
          integrate without collision, but no redistribute can place them,
          so they are not counted."""
        flat = info.reshape(-1)
        if taken is not None:
            flat = torch.cat([flat, taken.to(flat.dtype)])
        host = flat.cpu().numpy()
        self._last_info = host[:4].reshape(2, 2)
        if taken is not None:
            self._spatial.count_branches(host[4:])
        if not self._auto_redistribute:
            return
        dropped = int(self._last_info[:, 0].sum())
        transit = int(self._last_info[:, 1].sum())
        total = sum(self._inner._counts)
        if dropped > 0 or transit > max(8, 0.05 * total):
            log.warning("In SpatialHandler: migration ring dropped ",
                        dropped, " particle(s), ", transit, " in transit "
                        "(migrate_cap=", self._layout.migrate_cap,
                        "); re-running the host redistribute to restore "
                        "the ownership invariant")
            self._sp_state = S.redistribute(
                self._sp_state, self._cell_sizes(), self._layout, self._mesh,
                from_spatial=True)
            self._redistribute_count += 1

    def update(self, delta, step_delta=None) -> None:
        """Fixed-timestep driver (reference :168-222) over the sharded
        step: one step through :func:`~.spatial.spatial_step`, more through
        :func:`~.spatial.spatial_multi_step`."""
        if step_delta is None:
            step_delta = 1 / 60
        log.assert_types(delta, "number", step_delta, "number")
        self._ensure_spatial()

        self._elapsed += delta
        max_n_steps = max(4, 4 * math.ceil((1 / 60) / step_delta))
        n = 0
        while self._elapsed >= step_delta and n < max_n_steps:
            self._elapsed -= step_delta
            n += 1
        if self._elapsed >= step_delta:  # death-spiral cap (reference :203)
            self._elapsed = 0.0
        if n == 1:
            self._step(step_delta)
        elif n > 1:
            self._steps(n, step_delta)
        self._interpolation_alpha = min(max(self._elapsed / step_delta, 0.0),
                                        1.0)

    def step_once(self, step_delta: float = 1 / 60) -> None:
        self._ensure_spatial()
        self._step(step_delta)

    def run_steps(self, n_steps: int, step_delta: float = 1 / 60) -> None:
        """``n_steps`` plane-resident steps
        (:func:`~.spatial.spatial_multi_step`)."""
        if n_steps <= 0:
            return
        self._ensure_spatial()
        self._steps(int(n_steps), step_delta)

    # ------------------------------------------------------------ render --

    def draw(self, viewport=None, background=None):
        """Sharded render: each rank splats its own particles, one log-space
        sum over the mesh combines them; returns the (H, W, 4) frame, the
        same on every rank. On a card the frame is a replay of the key's
        draw graph. The frame goes through ``render.draw``, as
        ``SimulationHandler.draw``'s does (the options, the audit and its
        re-renders, ``background``), at the inner handler's render settings
        and budget over the mesh-wide stats, on the audit combined over the
        mesh; a boost is a new draw key. Per-particle colour is refused
        (``ValueError``)."""
        if viewport is None:
            viewport = (0.0, 0.0, 800, 600)
        self._ensure_spatial()
        x, y, w, h = viewport
        inner = self._inner
        thickness = inner._outline_thickness()
        cfg2 = inner._device_cfg2()
        graphs = self._spatial_graphs()

        def render(opts2):
            if graphs is None:
                key = (opts2, tuple(viewport), thickness)
                if key not in self._draw_cache:
                    self._draw_cache[key] = S.spatial_draw(
                        self._mesh, self._layout, opts2, viewport,
                        inner._thresholding_threshold,
                        inner._thresholding_smoothness, inner._use_lighting,
                        thickness=thickness)
                return self._draw_cache[key](
                    self._sp_state, self.stats, cfg2,
                    self._interpolation_alpha)
            return graphs.draw(
                self._sp_state, self.stats, cfg2,
                (self._interpolation_alpha, inner._thresholding_threshold,
                 inner._thresholding_smoothness, (x, y)),
                opts2=opts2, vw=w, vh=h, use_lighting=inner._use_lighting,
                thickness=thickness)

        return render_ops.draw(inner._render_budget, render, self.stats,
                               inner._budget_inputs(), background)

    # ----------------------------------------------------------- queries --

    def list_ids(self) -> List[int]:
        return self._inner.list_ids()

    def get_n_particles(self, batch_or_nil=None):
        return self._inner.get_n_particles(batch_or_nil)

    def get_position(self, batch_id):
        batch = self._inner._batches.get(batch_id)
        if batch is None:
            log.error("In SpatialHandler.get_position: no batch with id `",
                      batch_id, "`")
        c = self.stats.batch_centroid(batch["slot"]).cpu().numpy()
        return float(c[0]), float(c[1])

    @property
    def state(self) -> ParticleState:
        """This rank's slice of the spatial-layout state while one is live,
        else the inner handler's whole prefix-layout state."""
        return (self._sp_state if self._sp_state is not None
                else self._inner.state)

    @property
    def stats(self):
        return (self._sp_stats if self._sp_stats is not None
                else self._inner.stats)

    @property
    def device(self) -> torch.device:
        return self._mesh.device

    @property
    def interpolation_alpha(self) -> float:
        return self._interpolation_alpha

    @property
    def last_migration_info(self):
        """(2, 2) from the last update: (dropped, in-transit) per
        population."""
        return self._last_info

    @property
    def mesh(self):
        return self._mesh

    @property
    def layout(self) -> S.SpatialLayout:
        return self._layout
