"""Kernel B's share of its roofline: the bound of every collision pass of
the checked traced calls (``roofline/counts.substep_pass_seconds``, from
the reference's inputs of the same passes, each in the window its gate
chose) over B's traced time in those calls."""

from benchmark.metrics._common import roofline_pct


def read(run):
    if run.kind != "headless":
        return None
    return roofline_pct(run, "substep_pass", "run_steps")
