"""Kernel C's share of its roofline: the bound of the checked traced
frames' splats (``roofline/counts.splat_seconds``, from the reference's
inputs of the same frames) over C's traced time in those frames' draws."""

from benchmark.metrics._common import roofline_pct


def read(run):
    if run.kind != "frames":
        return None
    return roofline_pct(run, "splat", "draw")
