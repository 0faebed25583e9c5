"""The share of the traced frames' window in which no operation ran on the
device."""

from benchmark.metrics._common import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "frames" else None
