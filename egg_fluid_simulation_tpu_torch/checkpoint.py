"""Checkpoint / resume — serialize the full simulation to a single .npz.

The counterpart of ``egg_fluid_simulation_tpu/checkpoint.py``, in the same
file format (version 1): the :class:`ParticleState` fields as host arrays
(``state_<field>``, the same dtypes), the host-side batch registry, the
configs and the time accumulator as JSON (``meta``), the per-batch targets
(``host_targets``) and the violence-episode state of the wide sweep
(``wide_state``, budget -1 for a population without one). A file written by
either package loads in the other. The reference has no persistence; its
state is fully captured by the same fields (simulation_handler.lua:467-488).
"""

from __future__ import annotations

import json
from dataclasses import fields

import numpy as np
import torch

from .handler import SimulationHandler, _compute_stats
from .interop import state_from_numpy
from .state import ParticleState, host_view

__all__ = ["save", "load"]

_FORMAT_VERSION = 1


def save(handler: SimulationHandler, path: str) -> None:
    """Write the complete simulation state of ``handler`` to ``path`` (npz).
    (The JAX package's multi-device handler is not ported; its checkpoints,
    synced into this layout, load here all the same.)"""
    arrays = {f"state_{k}": v for k, v in host_view(handler.state).items()}
    meta = {
        "version": _FORMAT_VERSION,
        "white_config": handler.get_white_config(),
        "yolk_config": handler.get_yolk_config(),
        "batches": {str(k): v for k, v in handler._batches.items()},
        "current_batch_id": handler._current_batch_id,
        "free_slots": handler._free_slots,
        "counts": handler._counts,
        "elapsed": handler._elapsed,
        "interpolation_alpha": handler._interpolation_alpha,
        "capacity": handler._capacity,
        "max_batches": handler._max_batches,
        "canvas_size": handler._canvas_size,
        "jacobi_relaxation": handler._jacobi_relaxation,
        "use_particle_color": handler._use_particle_color,
        "use_lighting": handler._use_lighting,
        # overflow-recovery render-budget multipliers: without them a
        # resumed clustered scene drops splats until the next audited draw
        "render_k_boost": list(handler._render_k_boost),
    }
    arrays["host_targets"] = handler._host_targets
    ws = handler._wide_state
    if ws is not None:
        # (trip, budget, calm) per population, so a resumed run does not
        # restart the wide-sweep budget mid-episode; a population without
        # one is encoded as budget -1
        arrays["wide_state"] = np.asarray(
            [[0, -1, 0] if w is None else [int(w[0]), int(w[1]), int(w[2])]
             for w in ws], np.int64)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load(path: str, *, options=None, device="cuda") -> SimulationHandler:
    """Reconstruct a handler (batch registry included) on ``device`` from
    ``path``; ``options=None`` sizes automatic options to the restored
    counts."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['version']}")

    handler = SimulationHandler(
        meta["white_config"], meta["yolk_config"],
        capacity=meta["capacity"], max_batches=meta["max_batches"],
        canvas_size=meta["canvas_size"],
        jacobi_relaxation=meta["jacobi_relaxation"], options=options,
        device=device)
    handler._use_particle_color = meta["use_particle_color"]
    handler._use_lighting = meta["use_lighting"]
    if "render_k_boost" in meta:   # absent in the oldest checkpoints
        handler._render_k_boost = [float(b) for b in meta["render_k_boost"]]

    handler._state = state_from_numpy(
        {f.name: data[f"state_{f.name}"] for f in fields(ParticleState)},
        device=handler.device)
    handler._batches = {int(k): {**v, "target": tuple(v["target"])}
                        for k, v in meta["batches"].items()}
    handler._current_batch_id = meta["current_batch_id"]
    handler._free_slots = list(meta["free_slots"])
    handler._counts = list(meta["counts"])
    handler._elapsed = meta["elapsed"]
    handler._interpolation_alpha = meta["interpolation_alpha"]
    handler._host_targets = np.asarray(data["host_targets"])
    if "wide_state" in data:
        dev = handler.device
        handler._wide_state = tuple(
            None if int(r[1]) < 0 else
            (torch.tensor(bool(r[0]), device=dev),
             torch.tensor(int(r[1]), dtype=torch.int32, device=dev),
             torch.tensor(int(r[2]), dtype=torch.int32, device=dev))
            for r in data["wide_state"])
    handler._refresh_auto_options()   # size solver options to restored counts
    handler._stats = _compute_stats(handler._state)
    return handler
