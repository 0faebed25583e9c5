#!/usr/bin/env python3
"""The port's bench on one CUDA card: ``python bench_torch.py [--quick]``,
or ``--spatial --device cuda --ranks N`` for the spatial-mode bench. The
stages and their keys: ``egg_fluid_simulation_tpu_torch/bench.py``."""

import sys

from egg_fluid_simulation_tpu_torch.bench import main

if __name__ == "__main__":
    sys.exit(main())
