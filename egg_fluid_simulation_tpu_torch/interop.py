"""Carry particle state between the JAX package and this one.

The system has no model weights: what defines a run is the particle state
plus the two config dicts. Both packages lay the state out the same way, so
a host view of one (``egg_fluid_simulation_tpu.state.host_view``: a dict of
numpy arrays keyed by field name) becomes the other's state field for field.

A spatial-layout state of the JAX package (``parallel/spatial.py``) is one
global array whose particle axis device ``b * Dx + x`` holds slice
``b * Dx + x`` of; in this package rank ``b * Dx + x`` holds the same slice
as its own state (:func:`spatial_shards_from_numpy`, and back with
:func:`spatial_shards_to_numpy`).
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict, List, Sequence

import numpy as np
import torch

from .state import PARTICLE_FIELDS, ParticleState, host_view

__all__ = ["state_from_numpy", "state_to_numpy", "spatial_shards_from_numpy",
           "spatial_shards_to_numpy"]

_INT_FIELDS = {"batch_slot": torch.int32, "count": torch.int32}
_BOOL_FIELDS = {"batch_used"}


def state_from_numpy(d: Dict[str, np.ndarray], device="cpu") -> ParticleState:
    """ParticleState on ``device`` from a dict keyed like ``host_view``."""
    kw = {}
    for f in fields(ParticleState):
        a = np.asarray(d[f.name])
        if f.name in _BOOL_FIELDS:
            dtype = torch.bool
        else:
            dtype = _INT_FIELDS.get(f.name, torch.float32)
        kw[f.name] = torch.as_tensor(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)
    return ParticleState(**kw)


def state_to_numpy(state: ParticleState) -> Dict[str, np.ndarray]:
    """Host numpy view of a ParticleState (the inverse of state_from_numpy)."""
    return host_view(state)


def spatial_shards_from_numpy(d: Dict[str, np.ndarray], n_ranks: int,
                              device="cpu") -> List[ParticleState]:
    """Per-rank states of a spatial-layout state given as a host view: rank
    ``r`` gets slice ``r`` of the particle axis, the batch tables whole."""
    cap = np.asarray(d["pos"]).shape[1]
    if cap % n_ranks != 0:
        raise ValueError(f"capacity {cap} does not divide over {n_ranks} "
                         f"ranks")
    c_loc = cap // n_ranks
    return [state_from_numpy(
        {k: (np.asarray(v)[:, r * c_loc:(r + 1) * c_loc]
             if k in PARTICLE_FIELDS else v) for k, v in d.items()}, device)
        for r in range(n_ranks)]


def spatial_shards_to_numpy(shards: Sequence[ParticleState]
                            ) -> Dict[str, np.ndarray]:
    """The host view of the whole spatial-layout state from every rank's
    state, in rank order (the inverse of
    :func:`spatial_shards_from_numpy`)."""
    views = [host_view(s) for s in shards]
    return {k: (np.concatenate([v[k] for v in views], axis=1)
                if k in PARTICLE_FIELDS else views[0][k]) for k in views[0]}
