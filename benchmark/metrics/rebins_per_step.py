"""Rebins of the resident loop a step and population over the whole
window: the resident graphs' device counter (white + yolk) over twice the
steps."""


def read(run):
    if run.kind != "headless" or run.steps <= 0 or run.rebins is None:
        return None
    return sum(run.rebins) / (2.0 * run.steps)
