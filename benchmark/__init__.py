"""The benchmark of egg_fluid_simulation_tpu_torch on NVIDIA H100 cards.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells (a configuration
under a traffic mix), the end-to-end and per-layer metrics and their bounds.
Everything that belongs to one configuration, mix, metric or cell sits in a
file of its own, found by that name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``metrics/<metric>.py``, ``limits/<cell>.json``.
``reference/`` holds the plain reference that decides ``correct``,
``roofline/`` the peaks and the operation and byte counts of the kernels.
"""
