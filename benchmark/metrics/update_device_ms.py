"""Device milliseconds a frame of the operations launched inside
``update`` (the step graph's replay, the targets' upload and the step's
own copies), over the traced frames."""

from benchmark.metrics._common import unit_ranges


def read(run):
    ranges = list(unit_ranges(run, "update").values())
    total = sum(r.device_s for r in ranges)
    if run.kind != "frames" or total <= 0.0:
        return None
    return 1000.0 * total / len(ranges)
