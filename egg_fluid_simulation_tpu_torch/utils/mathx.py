"""Scalar/vector math helpers mirroring the reference's ``math.lua`` extensions.

Two flavours, as in ``egg_fluid_simulation_tpu/utils/mathx.py``:

- plain-Python versions for host-side code (config validation, batch
  creation) — only those the port calls so far, and
- ``torch_*`` versions of the ``jnp_*`` helpers, for device code.

EPS matches the reference's ``math.eps = 1e-8`` (math.lua:2). It is both a
float-comparison epsilon and a divide-by-zero guard throughout the solver, so
the value is load-bearing for fidelity. Against a float32 tensor it acts as
``float32(1e-8)``, exactly as the JAX package's weakly typed constant does.
"""

from __future__ import annotations

import torch

EPS = 1e-8  # reference math.lua:2

__all__ = ["EPS", "clamp", "mix", "is_nan", "torch_clamp", "torch_mix",
           "torch_normalize2", "torch_magnitude"]


# ---------------------------------------------------------------- host-side --

def clamp(x, lo, hi):
    """Clamp to [lo, hi] (math.lua:16-26)."""
    return lo if x < lo else hi if x > hi else x


def mix(lower, upper, ratio):
    """Linear interpolation (math.lua:33-35)."""
    return lower * (1 - ratio) + upper * ratio


def is_nan(x) -> bool:
    return x != x


# -------------------------------------------------------------- device-side --

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
