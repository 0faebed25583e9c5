"""The reference's steps and frames, from a state it is handed.

A run of the program is chaotic: a packed scene carries a one-ulp
difference to pixels within a step, so a free-running reference parts from
any program at once. The reference therefore follows the program step by
step: it takes the moving part of the program's state (positions, previous
positions, velocities, last positions and the wide gate's episode state)
before a unit of work, and works out everything else itself: the options
by the handler's automatic rule, the configurations, the spawn's per-
particle fields (``spawn.spawn``), the targets (from the traffic
generator), the stats and the render options. It then does the unit's work
with the frozen plain path and hands back what the program's unit should
have produced.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import batched
from .frozen import config as C
from .frozen.ops import render as R
from .frozen.ops import solver as S
from .frozen.state import ParticleState, StepStats
from .spawn import spawn

batched.install()

# the handler's fixed render knobs (handler.py, simulation_handler.lua:439-455)
THRESHOLD = 0.3
SMOOTHNESS = 0.01
USE_LIGHTING = True
DYNAMIC = ("pos", "prev", "vel", "last_pos")


def _loaded(cfg: dict) -> dict:
    """A config as the handler's loader keeps it: numbers as floats, colours
    as lists of floats (the defaults are in bounds: nothing is clamped)."""
    return {k: [float(c) for c in v] if isinstance(v, list) else float(v)
            for k, v in cfg.items()}


def host_configs(cell_cfg: dict) -> tuple:
    """(white, yolk) host config dicts as the handler keeps them."""
    names = (cell_cfg["white_config"], cell_cfg["yolk_config"])
    if names != ("default", "default"):
        raise ValueError("only the upstream default configs are known")
    return (_loaded(C.default_white_config()),
            _loaded(C.default_yolk_config()))


def auto_options(capacity: int, counts) -> S.SolverOptions:
    """The handler's automatic options for ``counts`` live particles
    (frozen from ``SimulationHandler._auto_options``, commit e9e0aedb87f3,
    as a handler made with ``options=None`` first sizes them)."""
    caps, grids = [], []
    for n in counts:
        n = max(int(n), 1)
        cap = min(1 << max(10, int(math.ceil(math.log2(n)))), capacity)
        caps.append(cap)
        g = 32
        while g * g < cap and g < 2048:
            g *= 2
        grids.append(g)
    if capacity >= 16384:
        return S.SolverOptions(engine="dense", dense_grid_dim=tuple(grids),
                               dense_slots=4, budget_mode="off",
                               pop_caps=tuple(caps))
    table = max(2048, min(16384, 1 << int(math.ceil(math.log2(2 * max(caps))))))
    return S.SolverOptions(engine="gather", table_size=table,
                           pop_caps=tuple(caps))


class Reference:
    """One cell's reference on ``device``: ``cell_cfg`` the configuration's
    file, ``specs`` the batches as the scene gives them for the run's seed."""

    def __init__(self, cell_cfg: dict, specs: list, device):
        self.device = torch.device(device)
        hd = cell_cfg["handler"]
        if hd["options"] != "auto":
            raise ValueError("only the handler's automatic options are known")
        self.cfgs = host_configs(cell_cfg)
        self.capacity, self.max_batches = hd["capacity"], hd["max_batches"]
        self.relaxation = float(hd["jacobi_relaxation"])
        self.post_mode = hd["render_post_mode"]
        self.spawned = spawn(specs, self.cfgs, self.capacity,
                             self.max_batches)
        self.counts = [int(c) for c in self.spawned["count"]]
        self.options = auto_options(self.capacity, self.counts)
        self.cfg2 = C.stack_device_configs(
            C.device_config_from_dict(self.cfgs[0], self.device),
            C.device_config_from_dict(self.cfgs[1], self.device))
        dev = self.device
        t = {k: torch.from_numpy(v).to(dev) for k, v in self.spawned.items()}
        used = torch.zeros((self.max_batches,), dtype=torch.bool, device=dev)
        used[:len(specs)] = True
        self._static = dict(
            radius=t["radius"], mass_t=t["mass_t"], inv_mass=t["inv_mass"],
            batch_slot=t["batch_slot"], count=t["count"],
            batch_radius=t["batch_radius"], batch_used=used,
            color=torch.ones((2, self.capacity, 4), dtype=torch.float32,
                             device=dev))
        self.home_targets = t["batch_target"]

    # ------------------------------------------------------------ state --

    def state(self, dyn: dict, targets=None) -> ParticleState:
        """A state of the moving fields ``dyn`` (tensors), the spawn's
        static fields and ``targets`` ((B', 2) for the first B' slots, else
        the spawn centres)."""
        bt = self.home_targets.clone()
        if targets is not None:
            tt = torch.as_tensor(np.asarray(targets, np.float32),
                                 device=self.device)
            bt[:tt.shape[0]] = tt
        return ParticleState(**{f: dyn[f].to(self.device) for f in DYNAMIC},
                             batch_target=bt, **self._static)

    def _wide(self, wide):
        """The gate's episode state; a handler that has not stepped since
        its spawn starts a fresh one (``_wide_or_init``)."""
        if wide is not None:
            return wide
        return tuple(S.wide_state_init(self.options, self.device)
                     for _ in range(2))

    def _scalars(self, step_delta: float):
        f32 = dict(dtype=torch.float32, device=self.device)
        return (torch.tensor(step_delta, **f32),
                torch.tensor(self.relaxation, **f32))

    # ------------------------------------------------------------- steps --

    def step(self, dyn: dict, wide, targets, step_delta: float, n: int = 1):
        """``n`` fixed steps as ``update`` runs them: ``(state, stats,
        wide_state)``."""
        st = self.state(dyn, targets)
        dt, relax = self._scalars(step_delta)
        wide = self._wide(wide)
        stats = None
        for _ in range(n):
            st, stats, wide = S.step(st, self.cfg2, dt, relax, self.options,
                                     wide_state=wide)
        return st, stats, wide

    def run_steps(self, dyn: dict, wide, targets, n_steps: int,
                  step_delta: float):
        """``run_steps(n_steps)`` on the resident route, run eagerly:
        ``(state, stats, wide_state, rebins)`` with the (white, yolk)
        rebins of its resident steps."""
        st = self.state(dyn, targets)
        dt, relax = self._scalars(step_delta)
        S.rebins[:] = [0, 0]
        st, stats, wide = S.multi_step(st, self.cfg2, dt, relax,
                                       self.options, n_steps,
                                       wide_state=self._wide(wide))
        return st, stats, wide, list(S.rebins)

    # ------------------------------------------------------------ render --

    def frame_stats(self, before: ParticleState, after: ParticleState):
        """The stats a draw reads, worked out as the step's own
        (``solver._step_impl``): centroid, radius-inclusive box and peak
        speed of the live particles after the step, the centroid before."""
        act_full = after.active_mask()
        n_act = torch.clamp(torch.sum(act_full, dim=1), min=1)
        last = (torch.sum(torch.where(act_full[..., None], before.pos, 0.0),
                          dim=1) / n_act[:, None])
        outs = []
        for i, cap in enumerate(self.options.pop_caps):
            act = act_full[i, :cap]
            pos, vel = after.pos[i, :cap], after.vel[i, :cap]
            radius = after.radius[i, :cap]
            n_a = torch.clamp(torch.sum(act), min=1)
            centroid = torch.sum(torch.where(act[:, None], pos, 0.0),
                                 dim=0) / n_a
            speed2 = torch.sum(vel * vel, dim=-1)
            max_vel = torch.sqrt(torch.max(torch.where(act, speed2, 0.0)))
            lo, hi = S._aabb(pos, radius, act)
            outs.append((centroid, max_vel, lo, hi))
        centroid, max_vel, lo, hi = (torch.stack(x) for x in zip(*outs))
        mb = self.max_batches
        z = dict(dtype=torch.float32, device=self.device)
        return StepStats(aabb_min=lo, aabb_max=hi, centroid=centroid,
                         last_centroid=last,
                         max_radius=torch.ones((2,), **z),
                         max_velocity=max_vel,
                         batch_pos_sum=torch.zeros((2, mb, 2), **z),
                         batch_count=torch.zeros((2, mb), **z))

    def render_options(self, state: ParticleState, stats: StepStats,
                       alpha_t) -> tuple:
        """Each population's render options (``frame_options``' rule: the
        canvas bucket from the stats), with a per-bin budget that holds
        the fullest bin, so the reference's frame drops nothing."""
        host = torch.cat([stats.aabb_min.reshape(-1),
                          stats.aabb_max.reshape(-1),
                          stats.max_velocity.reshape(-1)]).cpu().numpy()
        lo, hi, max_vel = host[0:4].reshape(2, 2), host[4:8].reshape(2, 2), \
            host[8:10]
        act = state.active_mask()
        centers = (stats.last_centroid
                   + (stats.centroid - stats.last_centroid) * alpha_t)
        opts = []
        for i, cfg in enumerate(self.cfgs):
            bucket = R.pick_canvas_bucket(
                lo[i], hi[i], cfg["max_radius"] * cfg["texture_scale"],
                float(max_vel[i]), cfg["motion_blur"], None)
            o = R.auto_render_options(cfg, bucket, post_mode=self.post_mode)
            cap = self.options.pop_caps[i]
            pcfg = C.population_config(self.cfg2, i)
            _, audit, _ = R._splat_payload(
                state.pos[i, :cap], state.last_pos[i, :cap],
                state.vel[i, :cap], state.radius[i, :cap],
                state.color[i, :cap], act[i, :cap], centers[i], alpha_t,
                pcfg.texture_scale, pcfg.motion_blur, o)
            peak = int(audit[1])
            opts.append(dataclasses.replace(
                o, tile_capacity=max(8, -(-peak // 8) * 8)))
        return tuple(opts)

    def draw(self, before: dict, after: dict, viewport, alpha: float):
        """The frame ``draw(viewport)`` should give of the program's state
        ``after`` (stepped from ``before``) at interpolation ``alpha``:
        (vh, vw, 4) straight RGBA."""
        st_after = self.state(after)
        st_before = self.state(before)
        stats = self.frame_stats(st_before, st_after)
        f32 = dict(dtype=torch.float32, device=self.device)
        alpha_t = torch.full((), float(alpha), **f32)
        opts2 = self.render_options(st_after, stats, alpha_t)
        x, y, w, h = viewport
        origin = torch.tensor([float(x), float(y)], **f32)
        frame, _, _ = R._render_frame(
            st_after, stats, self.cfg2, alpha_t,
            torch.full((), THRESHOLD, **f32),
            torch.full((), SMOOTHNESS, **f32), origin, opts2, USE_LIGHTING,
            int(w), int(h), pop_caps=self.options.pop_caps,
            thickness=(float(self.cfgs[0]["outline_thickness"]),
                       float(self.cfgs[1]["outline_thickness"])))
        return frame


class Clock:
    """The fixed-timestep accumulator of ``SimulationHandler.update``
    (frozen from ``handler.py``, commit e9e0aedb87f3): ``advance(delta)``
    gives the whole steps an ``update(delta)`` runs and the interpolation
    alpha it leaves."""

    def __init__(self):
        self.elapsed = 0.0

    def advance(self, delta: float, step_delta: float = 1 / 60):
        self.elapsed += delta
        n = 0
        max_n = max(4, 4 * math.ceil((1 / 60) / step_delta))
        while self.elapsed >= step_delta:
            self.elapsed -= step_delta
            n += 1
            if n > max_n:
                self.elapsed = 0.0
                break
        return n, min(max(self.elapsed / step_delta, 0.0), 1.0)
