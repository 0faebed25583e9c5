"""Scalar/vector math helpers mirroring the reference's ``math.lua`` extensions.

Two flavours, as in ``egg_fluid_simulation_tpu/utils/mathx.py``:

- plain-Python versions for host-side code (config validation, batch
  creation, ``Path``, the demo), and
- ``torch_*`` versions of the ``jnp_*`` helpers, for device code.

EPS matches the reference's ``math.eps = 1e-8`` (math.lua:2). It is both a
float-comparison epsilon and a divide-by-zero guard throughout the solver, so
the value is load-bearing for fidelity. Against a float32 tensor it acts as
``float32(1e-8)``, exactly as the JAX package's weakly typed constant does.
"""

from __future__ import annotations

import math as _pymath

import torch

EPS = 1e-8  # reference math.lua:2

__all__ = [
    "EPS", "clamp", "mix", "mix2", "round_half_up", "normalize2", "magnitude",
    "dot2", "cross2", "distance", "squared_distance", "is_nan", "fract", "wrap",
    "torch_clamp", "torch_mix", "torch_normalize2", "torch_magnitude",
    "torch_scalar",
]


# ---------------------------------------------------------------- host-side --

def clamp(x, lo, hi):
    """Clamp to [lo, hi] (math.lua:16-26)."""
    return lo if x < lo else hi if x > hi else x


def mix(lower, upper, ratio):
    """Linear interpolation (math.lua:33-35)."""
    return lower * (1 - ratio) + upper * ratio


def mix2(x1, y1, x2, y2, ratio):
    """Interpolate two 2D points (math.lua:44-47)."""
    return mix(x1, x2, ratio), mix(y1, y2, ratio)


def round_half_up(x):
    """Round to nearest integer, .5 up (math.lua:7-9)."""
    return _pymath.floor(x + 0.5)


def magnitude(x, y):
    """2D vector length (math.lua:66-68)."""
    return _pymath.sqrt(x * x + y * y)


def normalize2(x, y):
    """Normalize 2D vector; returns (0, 0) when |v| < EPS (math.lua:54-61)."""
    m = magnitude(x, y)
    if m < EPS:
        return 0.0, 0.0
    return x / m, y / m


def dot2(x1, y1, x2, y2):
    return x1 * x2 + y1 * y2


def cross2(x1, y1, x2, y2):
    return x1 * y2 - y1 * x2


def distance(x1, y1, x2, y2):
    return magnitude(x2 - x1, y2 - y1)


def squared_distance(x1, y1, x2, y2):
    dx, dy = x2 - x1, y2 - y1
    return dx * dx + dy * dy


def is_nan(x) -> bool:
    return x != x


def fract(x):
    return x - _pymath.floor(x)


def wrap(index, n_elements):
    """Wrap a 1-based index into [1, n] (math.lua:126-129)."""
    if n_elements == 0:
        return index
    return ((index - 1) % n_elements) + 1


# -------------------------------------------------------------- device-side --

def torch_scalar(v, device) -> torch.Tensor:
    """``v`` (a number or a one-element tensor) as a 0-dim float32 tensor on
    ``device``. A number becomes a fill there, not a copy from the host, so
    a CUDA graph can capture the call."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def torch_clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def torch_mix(lower, upper, ratio):
    return lower * (1 - ratio) + upper * ratio


def torch_magnitude(v, dim=-1):
    return torch.sqrt(torch.sum(v * v, dim=dim))


def torch_normalize2(v, dim=-1):
    """Normalize with the reference's zero-vector convention: |v| < EPS -> 0."""
    m = torch_magnitude(v, dim=dim)
    safe = torch.clamp(m, min=EPS)
    out = v / safe.unsqueeze(dim)
    return torch.where(m.unsqueeze(dim) < EPS, torch.zeros_like(out), out), m
