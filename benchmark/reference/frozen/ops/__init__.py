# Frozen copy of egg_fluid_simulation_tpu_torch/ops/__init__.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept unchanged as the benchmark's reference.
"""Solver, binning and render operators, and the hand-written kernels."""
