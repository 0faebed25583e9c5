"""Kernel H's sweep's share of its roofline: the bound of every gather
pass of the checked traced frames (``roofline/counts.gather_sweep_seconds``,
from the reference's inputs of the same passes) over the sweep's traced
time in those frames' updates."""

from benchmark.metrics._common import roofline_pct


def read(run):
    if run.kind != "frames":
        return None
    return roofline_pct(run, "gather_sweep", "update")
