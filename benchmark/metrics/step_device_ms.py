"""Device milliseconds a fixed step of the operations launched inside
``run_steps``, over the traced calls."""

from benchmark.metrics._common import unit_ranges


def read(run):
    ranges = list(unit_ranges(run, "run_steps").values())
    total = sum(r.device_s for r in ranges)
    if run.kind != "headless" or total <= 0.0 or run.steps_per_call <= 0:
        return None
    return 1000.0 * total / (len(ranges) * run.steps_per_call)
