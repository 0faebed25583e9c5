"""Host seconds the program spent building its CUDA graphs: every cache's
eager warm-ups and captures (``step_graph.capture_seconds``, read through
``program.py``), read after the window, so the set-up's builds and any the
window made (``diagnostics.graphs_made_in_window`` says whether it made
one). None where the program keeps no such counter (an older commit) or
the traced run saw no device work (the CPU, where the handler holds no
graph)."""

from benchmark import program


def read(run):
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    c = program.program_counters()
    if not c or not c.get("capture_seconds"):
        return None
    return c["capture_seconds"]
