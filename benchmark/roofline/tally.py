"""The bounds of the kernel calls a reference run makes, tallied.

Inside ``tally(sink)`` every collision pass and every splat the reference
computes adds its kernel's bound (``counts``) to ``sink`` under the
kernel's name, in seconds: the least time the card could take over the
same work that the program's kernels B and C did in that unit.
"""

from __future__ import annotations

import contextlib

from ..reference.frozen.ops import render
from ..reference.frozen.ops.kernels import splat_kernel, sweep_kernel
from . import counts


@contextlib.contextmanager
def tally(sink: dict):
    pass_fn, splat_fn = sweep_kernel.substep_pass, splat_kernel.splat

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

    def splat(payload, cnt, opts, use_rgb):
        alpha, rgb = splat_fn(payload, cnt, opts, use_rgb)
        s = counts.splat_seconds(payload, cnt, opts, alpha, rgb,
                                 splat_kernel.cull_counts, render._tile_bins)
        sink["splat"] = sink.get("splat", 0.0) + s
        return alpha, rgb

    sweep_kernel.substep_pass, splat_kernel.splat = substep_pass, splat
    try:
        yield sink
    finally:
        sweep_kernel.substep_pass, splat_kernel.splat = pass_fn, splat_fn
