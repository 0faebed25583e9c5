# Frozen copy of egg_fluid_simulation_tpu_torch/utils/__init__.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept unchanged as the benchmark's reference.
"""Host-side utilities: logging, math helpers, state audits."""
