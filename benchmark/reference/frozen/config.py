# Frozen copy of egg_fluid_simulation_tpu_torch/config.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
"""The default white / yolk configs and their device form.

The default parameter sets are those of
``egg_fluid_simulation_tpu/config.py`` (reference
``simulation_handler_default_config.lua:1-70``); the schema and its
clamp-and-warn loader are left out of this copy (the cells run the
defaults, which are in bounds). :class:`DeviceConfig` holds a config as
float32 tensors on the simulation device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

__all__ = [
    "default_white_config", "default_yolk_config", "DeviceConfig",
    "device_config_from_dict", "stack_device_configs", "population_config",
]

def default_white_config() -> Dict[str, Any]:
    """Default egg-white parameters (simulation_handler_default_config.lua:10-38)."""
    return {
        "damping": 0.1,
        "follow_strength": 1 - 0.004,
        "cohesion_strength": 1 - 0.2,
        "cohesion_interaction_distance_factor": 2.0,
        "collision_strength": 1 - 0.0025,
        "collision_overlap_factor": 2.0,
        "color": [0.961, 0.961, 0.953, 1.0],
        "outline_color": [0.973, 0.796, 0.529, 1.0],
        "outline_thickness": 1.0,
        "highlight_strength": 0.0,
        "shadow_strength": 1.0,
        "min_mass": 1.0,
        "max_mass": 1.8,
        "min_radius": 4.0,
        "max_radius": 4.0,
        "texture_scale": 12.0,
        "motion_blur": 0.0003,
    }


def default_yolk_config() -> Dict[str, Any]:
    """Default egg-yolk parameters (simulation_handler_default_config.lua:40-67)."""
    return {
        "damping": 0.1,
        "follow_strength": 1 - 0.004,
        "cohesion_strength": 1 - 0.002,
        "cohesion_interaction_distance_factor": 3.0,
        "collision_strength": 1 - 0.001,
        "collision_overlap_factor": 2.0,
        "color": [0.969, 0.682, 0.141, 1.0],
        "outline_color": [0.984, 0.522, 0.271, 1.0],
        "outline_thickness": 1.0,
        "highlight_strength": 1.0,
        "shadow_strength": 0.0,
        "min_mass": 1.0,
        "max_mass": 1.35,
        "min_radius": 4.0,
        "max_radius": 4.0,
        "texture_scale": 12.0,
        "motion_blur": 0.0003,
    }


# ---------------------------------------------------------- device tensors --

@dataclass(frozen=True)
class DeviceConfig:
    """Per-population solver/render parameters as float32 tensors.

    One population's config holds 0-dim tensors (``color`` and
    ``outline_color`` are (4,)); :func:`stack_device_configs` stacks white and
    yolk on a leading (2,) axis, and :func:`population_config` selects one.
    """
    damping: torch.Tensor
    follow_strength: torch.Tensor
    cohesion_strength: torch.Tensor
    cohesion_interaction_distance_factor: torch.Tensor
    collision_strength: torch.Tensor
    collision_overlap_factor: torch.Tensor
    min_mass: torch.Tensor
    max_mass: torch.Tensor
    min_radius: torch.Tensor
    max_radius: torch.Tensor
    motion_blur: torch.Tensor
    texture_scale: torch.Tensor
    outline_thickness: torch.Tensor
    highlight_strength: torch.Tensor
    shadow_strength: torch.Tensor
    color: torch.Tensor          # (4,)
    outline_color: torch.Tensor  # (4,)


_DEVICE_SCALAR_KEYS = [
    "damping", "follow_strength", "cohesion_strength",
    "cohesion_interaction_distance_factor", "collision_strength",
    "collision_overlap_factor", "min_mass", "max_mass", "min_radius",
    "max_radius", "motion_blur", "texture_scale", "outline_thickness",
    "highlight_strength", "shadow_strength",
]


def device_config_from_dict(cfg: Dict[str, Any], device="cpu") -> DeviceConfig:
    kwargs = {k: torch.tensor(cfg[k], dtype=torch.float32, device=device)
              for k in _DEVICE_SCALAR_KEYS}
    for k in ("color", "outline_color"):
        kwargs[k] = torch.tensor(cfg[k], dtype=torch.float32, device=device)
    return DeviceConfig(**kwargs)


def stack_device_configs(white: DeviceConfig, yolk: DeviceConfig) -> DeviceConfig:
    """Stack white/yolk configs on a new leading population axis."""
    return DeviceConfig(**{f.name: torch.stack([getattr(white, f.name),
                                                getattr(yolk, f.name)])
                           for f in dataclasses.fields(DeviceConfig)})


def population_config(cfg2: DeviceConfig, i: int) -> DeviceConfig:
    """Population ``i`` of a stacked (2,)-leading config."""
    return DeviceConfig(**{f.name: getattr(cfg2, f.name)[i]
                           for f in dataclasses.fields(DeviceConfig)})
