# Frozen copy of egg_fluid_simulation_tpu_torch/ops/kernels/__init__.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept unchanged as the benchmark's reference.
"""Hand-written Hopper kernels (sources in ``csrc/``), each beside its plain
PyTorch version, its launch counter and its dispatching wrapper."""
