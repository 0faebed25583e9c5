"""Carry particle state between the JAX package and this one.

The system has no model weights: what defines a run is the particle state
plus the two config dicts. Both packages lay the state out the same way, so
a host view of one (``egg_fluid_simulation_tpu.state.host_view``: a dict of
numpy arrays keyed by field name) becomes the other's state field for field.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Dict

import numpy as np
import torch

from .state import ParticleState, host_view

__all__ = ["state_from_numpy", "state_to_numpy"]

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
