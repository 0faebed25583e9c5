"""State audits: the collision-budget drop rate and the NaN guard.

Host-side numpy over a handler's current state, as in
``egg_fluid_simulation_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import numpy as np

from . import log

__all__ = ["validate_state", "collision_drop_stats"]


def collision_drop_stats(handler) -> dict:
    """Host-side dense-grid budget audit for the CURRENT state.

    Per population: the share of live particles past the per-cell slot
    budget K in their torus cell ``floor(pos / cell) mod G`` — the count the
    dense engine drops from collision at this binning. Keys: ``drop_pct``
    (of live), ``max_cell_occupancy``, ``mean_cell_occupancy``.
    """
    state = handler.state
    options = handler._options
    active = state.active_mask().cpu().numpy()
    pos_all = state.pos.cpu().numpy()
    out = {}
    for pop, name in ((0, "white"), (1, "yolk")):
        cfg = handler._white_config if pop == 0 else handler._yolk_config
        cell = max(1.0, cfg["max_radius"]
                   * max(cfg["collision_overlap_factor"],
                         cfg["cohesion_interaction_distance_factor"]))
        g = options.dense_grid_dim[pop]
        k = options.dense_slots[pop]
        pos = pos_all[pop][active[pop]]
        n = pos.shape[0]
        if n == 0:
            out[name] = dict(drop_pct=0.0, max_cell_occupancy=0,
                             mean_cell_occupancy=0.0)
            continue
        c = np.mod(np.floor(pos / cell).astype(np.int64), g)
        counts = np.bincount(c[:, 1] * g + c[:, 0], minlength=g * g)
        dropped = np.maximum(counts - k, 0).sum()
        occ = counts[counts > 0]
        out[name] = dict(drop_pct=100.0 * dropped / n,
                         max_cell_occupancy=int(counts.max()),
                         mean_cell_occupancy=float(occ.mean()))
    return out


def validate_state(handler, *, fatal: bool = True) -> bool:
    """NaN/overflow guard: True when every active particle is finite;
    otherwise raises (or warns when ``fatal=False``) naming the population."""
    state = handler.state
    active = state.active_mask().cpu().numpy()
    pos_all = state.pos.cpu().numpy()
    vel_all = state.vel.cpu().numpy()
    ok = True
    for pop, name in ((0, "white"), (1, "yolk")):
        pos = pos_all[pop][active[pop]]
        vel = vel_all[pop][active[pop]]
        if not (np.isfinite(pos).all() and np.isfinite(vel).all()):
            ok = False
            msg = ("validate_state: population `", name,
                   "` has non-finite positions or velocities — the solver "
                   "likely diverged (check damping >= 0.05 and strengths < 1)")
            if fatal:
                log.error(*msg)
            log.warning(*msg)
    return ok
