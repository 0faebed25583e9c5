"""Collective bytes, counted where the collectives are called.

The counterpart of ``egg_fluid_simulation_tpu/parallel/accounting.py``.
The JAX package reads the bytes out of the compiled HLO of a sharded step;
the port has no HLO, so every collective of :class:`~.mesh.Mesh` adds the
bytes this rank sends to the mesh's :class:`~.mesh.CollectiveCounter`,
under the category its call site names. For a spatial step the categories
are those of ``SpatialLayout.collective_bytes_per_step`` (the analytic
model): ``full_halo_exchange``, ``xy_refresh_per_pass``, ``migration``;
besides them ``reductions`` (the gate's and the statistics' all-reduces,
outside the model), ``render`` (the draw's log-space sums and its
audit's sum and max: the dropped splats and the peak bin occupancy of each
population, two int32 each) and ``gather``
(a whole state gathered for the host layout or the handler's sync). The 1D
sharded step counts its per-pass gather under ``all_gather`` (6 floats a
particle a pass) and its statistics' sum and max under ``reductions``.

A replayed CUDA graph runs no Python, so no call site counts in it: the
spatial graphs (``parallel/spatial_graph.py``) record each part's bytes
once, at its eager warm-up, and add that tally at each replay; a rebin
branch's tally is added as many times as the device counter says the
branch ran (read with the call's migration counters). The sharded step's
graph (``parallel/sharding_graph.py``) keeps the bytes of its eager first
step and adds them at each replay. The counts are the same as the eager
call sites' (``tests/test_torch_spatial_graph.py``,
``tests/test_torch_sharding_graph.py``).
"""

from __future__ import annotations

from typing import Dict

from .mesh import Mesh

__all__ = ["collective_bytes_from_counter", "measured_collective_bytes"]


def collective_bytes_from_counter(counts: Dict[str, int]) -> Dict[str, int]:
    """Per-category byte totals of a counter snapshot (or difference of two)
    plus their ``total``: the form ``collective_bytes_from_hlo`` gives in the
    JAX package."""
    out = {k: int(v) for k, v in counts.items() if k != "total" and v}
    out["total"] = sum(out.values())
    return out


def measured_collective_bytes(mesh: Mesh, fn, *args, **kw):
    """Run ``fn(*args, **kw)`` and count the bytes this rank sent in its
    collectives. Returns ``(fn's result, per-category bytes with a
    'total')``."""
    before = mesh.counter.snapshot()
    out = fn(*args, **kw)
    after = mesh.counter.snapshot()
    diff = {k: v - before.get(k, 0) for k, v in after.items()}
    return out, collective_bytes_from_counter(diff)
