"""Config schema, validation, and defaults for white / yolk populations.

The 16-key schema, the clamp-and-warn loader and the default parameter sets
are those of ``egg_fluid_simulation_tpu/config.py`` (reference
``simulation_handler.lua:1152-1320`` and
``simulation_handler_default_config.lua:1-70``), with the same warning text.

Two representations:

- ``dict`` configs at the public API boundary (``set_white_config`` /
  ``get_white_config`` traffic in these), and
- :class:`DeviceConfig`, float32 tensors on the simulation device. The
  handler builds one (2,)-leading instance and keeps it until a
  ``set_*_config`` call, so a step uploads no scalars.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch

from .utils import log
from .utils.mathx import clamp, is_nan

__all__ = [
    "CONFIG_SCHEMA", "default_white_config", "default_yolk_config",
    "fluid_config", "load_config", "DeviceConfig", "device_config_from_dict",
    "stack_device_configs", "population_config",
]

_NUM = "number"
_COLOR = "color"

# key -> {type, min, max}; mirrors simulation_handler.lua:1152-1249 one-to-one.
CONFIG_SCHEMA: Dict[str, Dict[str, Any]] = {
    "damping":                              {"type": _NUM, "min": 0.0, "max": 1.0},
    "color":                                {"type": _COLOR},
    "outline_color":                        {"type": _COLOR},
    "outline_thickness":                    {"type": _NUM, "min": 0.0, "max": None},
    "collision_strength":                   {"type": _NUM, "min": 0.0, "max": 1.0},
    "collision_overlap_factor":             {"type": _NUM, "min": 0.0, "max": None},
    "cohesion_strength":                    {"type": _NUM, "min": 0.0, "max": 1.0},
    "cohesion_interaction_distance_factor": {"type": _NUM, "min": 0.0, "max": None},
    "follow_strength":                      {"type": _NUM, "min": 0.0, "max": 1.0},
    "min_radius":                           {"type": _NUM, "min": 0.0, "max": None},
    "max_radius":                           {"type": _NUM, "min": 0.0, "max": None},
    "min_mass":                             {"type": _NUM, "min": 0.0, "max": None},
    "max_mass":                             {"type": _NUM, "min": 0.0, "max": None},
    "motion_blur":                          {"type": _NUM, "min": 0.0, "max": 1.0},
    "texture_scale":                        {"type": _NUM, "min": 1.0, "max": None},
    "highlight_strength":                   {"type": _NUM, "min": 0.0, "max": None},
    "shadow_strength":                      {"type": _NUM, "min": 0.0, "max": None},
}


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


def fluid_config() -> Dict[str, Any]:
    """The demo harness's low-damping "fluid" override set (reference test.lua:70-78)."""
    return {
        "min_mass": 1 / 20,
        "max_mass": 1 - 1 / 20,
        "follow_strength": 0.8,
        "min_radius": 3.5,
        "max_radius": 3.5,
        "damping": 0.05,
        "motion_blur": 0.0,
    }


def _scope(white_or_yolk: bool) -> str:
    return "set_white_config" if white_or_yolk else "set_yolk_config"


def load_config(target: Dict[str, Any], updates: Dict[str, Any], white_or_yolk: bool) -> None:
    """Validate ``updates`` and merge into ``target`` in place.

    Semantics match the reference loader (simulation_handler.lua:1253-1320):
    unknown key -> warn + ignore; wrong type / malformed color -> fatal;
    NaN number -> warn + ignore; out-of-bounds -> warn + clamp;
    color component outside [0,1] -> warn + clamp.
    """
    scope = _scope(white_or_yolk)
    for key, value in updates.items():
        entry = CONFIG_SCHEMA.get(key)
        if entry is None:
            log.warning("In SimulationHandler.", scope, ": unrecognized config key `",
                        key, "`, it will be ignored")
            continue

        if entry["type"] == _COLOR:
            if not isinstance(value, (list, tuple)) or len(value) != 4:
                log.error("In SimulationHandler.", scope, ": color `", key,
                          "` does not have 4 components")
            comps = []
            for c in value:
                if isinstance(c, bool) or not isinstance(c, (int, float)) or is_nan(c):
                    log.error("In SimulationHandler.", scope, ": color `", key,
                              "` has a component that is not a number")
                if c < 0 or c > 1:
                    log.warning("In SimulationHandler.", scope, ": color `", key,
                                "` has a component that is outside of [0, 1]")
                comps.append(clamp(float(c), 0.0, 1.0))
            target[key] = comps
        else:
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                log.error("In SimulationHandler.", scope, ": wrong type for config key `",
                          key, "`, expected `number`, got `", type(value).__name__, "`")
            value = float(value)
            if is_nan(value):
                log.warning("In SimulationHandler.", scope, ": config key `", key,
                            "` is NaN, it will be ignored")
                continue
            lo, hi = entry.get("min"), entry.get("max")
            if lo is not None and value < lo:
                log.warning("In SimulationHandler.", scope, ": config key `", key,
                            "`'s value is `", value,
                            "`, expected a value larger than `", lo, "`")
                value = max(value, lo)
            elif hi is not None and value > hi:
                log.warning("In SimulationHandler.", scope, ": config key `", key,
                            "`'s value is `", value,
                            "`, expected a value smaller than `", hi, "`")
                value = min(value, hi)
            target[key] = value


def copy_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Deep copy, the analog of the reference's ``_deepcopy`` (simulation_handler.lua:2180-2204)."""
    return copy.deepcopy(cfg)


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
