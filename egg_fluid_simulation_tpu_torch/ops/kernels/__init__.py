"""Hand-written Hopper kernels (sources in ``csrc/``), each beside its plain
PyTorch version, its launch counter and its dispatching wrapper."""
