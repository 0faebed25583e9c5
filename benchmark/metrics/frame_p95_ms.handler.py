"""The nearest-rank 95th percentile, in milliseconds, of the frames that the
traced run's window completed after the profiler stopped (each timed from
the end of the one before, as ``frame_p95_ms``): the frame's tail where it
is read per layer, beside ``frame_ms``, in a cell whose tail spreads too
widely from run to run to hold a bound."""

from benchmark import stats
from benchmark.metrics._common import unit_ranges


def read(run):
    if run.kind != "frames":
        return None
    after = max(unit_ranges(run, "frame"), default=-1) + 1
    frames = run.unit_s[after:]
    if not frames:
        return None
    return 1000.0 * stats.percentile(frames, 95)
