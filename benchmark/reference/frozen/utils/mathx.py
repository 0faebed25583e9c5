# Frozen copy of egg_fluid_simulation_tpu_torch/utils/mathx.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
"""Scalar/vector math helpers mirroring the reference's ``math.lua`` extensions.

Two flavours, as in ``egg_fluid_simulation_tpu/utils/mathx.py``:

- plain-Python versions for host-side code (the spawn), and
- ``torch_*`` versions of the ``jnp_*`` helpers, for device code.

EPS matches the reference's ``math.eps = 1e-8`` (math.lua:2). It is both a
float-comparison epsilon and a divide-by-zero guard throughout the solver, so
the value is load-bearing for fidelity. Against a float32 tensor it acts as
``float32(1e-8)``, exactly as the JAX package's weakly typed constant does.
"""

from __future__ import annotations

import torch

EPS = 1e-8  # reference math.lua:2

__all__ = ["EPS", "mix", "torch_mix", "torch_scalar"]


# ---------------------------------------------------------------- host-side --


def mix(lower, upper, ratio):
    """Linear interpolation (math.lua:33-35)."""
    return lower * (1 - ratio) + upper * ratio


# -------------------------------------------------------------- device-side --

def torch_scalar(v, device) -> torch.Tensor:
    """``v`` (a number or a one-element tensor) as a 0-dim float32 tensor on
    ``device``. A number becomes a fill there, not a copy from the host, so
    a CUDA graph can capture the call."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def torch_mix(lower, upper, ratio):
    return lower * (1 - ratio) + upper * ratio


