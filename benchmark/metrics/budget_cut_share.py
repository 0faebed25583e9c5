"""The share of the ordered budget's collision passes that the budget cut:
100 x the passes in which some pair in the true 3x3 cells went unexamined
because its lower particle's prefix had reached ``max_pairs``, over the
passes run with the budget on, both populations, over the run's process
(the set-up's steps included), read after the window from the port's
device counter (``budget_cuts``, read through ``program.py``). None where
the program keeps no such counter (an older commit) or ran no budgeted
pass."""

from benchmark import program


def read(run):
    c = program.program_counters()
    cuts = None if not c else c.get("budget_cuts")
    if cuts is None:
        return None
    (cut_w, passes_w), (cut_y, passes_y) = cuts.tolist()
    passes = passes_w + passes_y
    if passes <= 0:
        return None
    return 100.0 * (cut_w + cut_y) / passes
