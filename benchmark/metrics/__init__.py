"""One reader a per-layer metric, ``<name>.py`` with ``read(run)``: the
metric's value from a traced run (``harness.Run``), or None where the run
holds nothing for it to read. Found by the metric's name."""
