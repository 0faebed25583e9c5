"""What the metric readers share."""


def unit_ranges(run, name: str) -> dict:
    """unit -> the traced range ``name`` of that unit."""
    if run.trace is None:
        return {}
    return {r.unit: r for r in run.trace.of(name)}


def roofline_pct(run, kernel: str, call: str):
    """100 x the kernel's bound over its traced time, summed over the
    checked units that were traced (None without any)."""
    ranges = unit_ranges(run, call)
    bound = spent = 0.0
    for unit, b in run.bounds.items():
        r = ranges.get(unit)
        if r is None or kernel not in b or r.kernels.get(kernel, 0.0) <= 0:
            continue
        bound += b[kernel]
        spent += r.kernels[kernel]
    if spent <= 0.0:
        return None
    return 100.0 * bound / spent


def idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
