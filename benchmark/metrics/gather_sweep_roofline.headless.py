"""Kernel H's sweep's share of its roofline in a headless cell: the bound
of every gather pass of the checked traced calls
(``roofline/counts.gather_sweep_seconds``, from the reference's inputs of
the same passes) over the sweep's traced time in those calls'
``run_steps``."""

from benchmark.metrics._common import roofline_pct


def read(run):
    if run.kind != "headless":
        return None
    return roofline_pct(run, "gather_sweep", "run_steps")
