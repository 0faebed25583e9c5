"""The bounds of the kernel calls a reference run makes, tallied.

Inside ``tally(sink)`` every collision pass (kernel B's on the dense
engine, H's sweep on the gather engine) and every splat the reference
computes adds its kernel's bound (``counts``) to ``sink`` under the
kernel's name, in seconds: the least time the card could take over the
same work that the program's kernels B, H and C did in that unit.
"""

from __future__ import annotations

import contextlib

import torch

from ..reference.frozen.ops import hash_grid, render
from ..reference.frozen.ops.kernels import (gather_kernel, splat_kernel,
                                            sweep_kernel)
from . import counts


def table_rows(grid, active) -> int:
    """The distinct slot table rows that the live particles' 3x3 cells
    hash to: the rows kernel H's sweep reads."""
    cells = grid.cell_xy[active].to(torch.int64)
    off = hash_grid._offsets(cells.device)
    buckets = hash_grid._bucket_of(cells[:, 0, None] + off[0],
                                   cells[:, 1, None] + off[1],
                                   grid.table_size)
    return int(torch.unique(buckets).numel())


@contextlib.contextmanager
def tally(sink: dict):
    pass_fn, splat_fn = sweep_kernel.substep_pass, splat_kernel.splat
    gather_fn = gather_kernel.gather_sweep

    def substep_pass(xy, stat, params, aux, k, *, window=1, prev=None,
                     follow=None, integrate=False, wide=None, **kw):
        out = pass_fn(xy, stat, params, aux, k, window=window, prev=prev,
                      follow=follow, integrate=integrate, wide=wide, **kw)
        w = window if wide is None else (3 if bool(wide) else 1)
        s = counts.substep_pass_seconds(
            xy, stat, k, w, prev if integrate else None,
            follow if integrate else None, out)
        sink["substep_pass"] = sink.get("substep_pass", 0.0) + s
        sink[f"passes.w{w}"] = sink.get(f"passes.w{w}", 0) + 1
        return out

    def gather_sweep(record, grid, cum, *args, **kw):
        out = gather_fn(record, grid, cum, *args, **kw)
        active = gather_kernel.record_active(record)
        cand, valid = gather_kernel.candidates(grid, active)
        near = gather_kernel.in_cells(grid.cell_xy,
                                      cand.clamp(min=0).to(torch.int64))
        s = counts.gather_sweep_seconds(
            float((valid & near).sum()), record, table_rows(grid, active),
            grid.table.shape[1], int(active.sum()) if cum is not None else 0)
        sink["gather_sweep"] = sink.get("gather_sweep", 0.0) + s
        return out

    def splat(payload, cnt, opts, use_rgb):
        alpha, rgb = splat_fn(payload, cnt, opts, use_rgb)
        s = counts.splat_seconds(payload, cnt, opts, alpha, rgb,
                                 splat_kernel.cull_counts, render._tile_bins)
        sink["splat"] = sink.get("splat", 0.0) + s
        return alpha, rgb

    sweep_kernel.substep_pass, splat_kernel.splat = substep_pass, splat
    gather_kernel.gather_sweep = gather_sweep
    try:
        yield sink
    finally:
        sweep_kernel.substep_pass, splat_kernel.splat = pass_fn, splat_fn
        gather_kernel.gather_sweep = gather_fn
