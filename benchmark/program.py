"""What the port counts of itself, through its one public read
(``utils.profiling.counters``), imported by name through
:func:`.system.port`: the draw's reads and re-renders, the graph builds'
and the kernel library's host seconds, the captures by cache. A program
without that read (an older commit) gives None."""

from __future__ import annotations

import importlib
import numbers

from . import system


def program_counters(h=None):
    """The port's counters (with ``h``, its handler's too), or None."""
    name = system.port().__name__ + ".utils.profiling"
    read = getattr(importlib.import_module(name), "counters", None)
    return None if read is None else read(h)


def numbers_of(counters: dict) -> dict:
    """The counters that are host numbers, by name (``captures`` by cache
    as ``captures.<cache>``, ``rebins`` by population as ``rebins.<i>``);
    the device counters left out."""
    out = {}
    for k, v in (counters or {}).items():
        if isinstance(v, dict):
            out.update({f"{k}.{c}": n for c, n in v.items()})
        elif isinstance(v, (list, tuple)):
            out.update({f"{k}.{i}": n for i, n in enumerate(v)})
        elif isinstance(v, numbers.Number):
            out[k] = v
    return out
