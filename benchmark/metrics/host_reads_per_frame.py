"""Reads of the device by the handler a frame, over the whole window: the
render's stats and audit reads (``render.host_reads``) and the resident
loops' rebin-flag reads (``solver.host_syncs``), counted by the port."""


def read(run):
    if run.kind != "frames" or run.units <= 0:
        return None
    c = run.counters
    return (c["host_reads"] + c["host_syncs"]) / run.units
