"""The roofline counts on small hand-counted planes, and the same counts
from the reference's inputs as from the inputs of the port's kernel
routes."""

import pytest
import torch

from benchmark import scene
from benchmark.reference.model import Reference
from benchmark.roofline import counts, tally
from benchmark import system

import bench_tiny


def occ(g, k, cells):
    """(G, G*K) occupancy with one occupied slot per listed (row, col) of
    cells (a cell listed twice gets two slots)."""
    o = torch.zeros((g, g * k))
    for (r, c) in cells:
        base = c * k
        slot = int((o[r, base:base + k] > 0).sum())
        o[r, base + slot] = 1.0
    return o


@pytest.mark.parametrize("cells,w,want", [
    ([(0, 0), (0, 1)], 1, 2.0),          # neighbours see each other
    ([(1, 1), (1, 1)], 1, 2.0),          # two in one cell
    ([(0, 0), (0, 3)], 1, 2.0),          # across the torus seam
    ([(0, 0), (2, 2)], 1, 0.0),          # two cells apart
    ([(0, 0), (2, 2)], 3, 2.0),          # inside the wide window
    ([(1, 1), (1, 1), (1, 2)], 1, 6.0),  # 2*3-2 + 1*3-1
])
def test_window_pairs_hand_counted(cells, w, want):
    g = 8 if w == 3 else 4
    assert counts.window_pairs(occ(g, 2, cells), 2, w) == want


def test_substep_pass_bound_by_bytes_and_by_operations():
    g, k = 4, 2
    stat = torch.zeros((4, g, g * k))
    stat[3] = occ(g, k, [(0, 0), (0, 1)])
    xy = torch.zeros((2, g, g * k))
    out = torch.zeros_like(xy)
    nbytes = 4 * (2 + 4 + 2) * g * g * k
    assert counts.substep_pass_seconds(xy, stat, k, 1, out=out) == \
        pytest.approx(nbytes / counts.HBM_BYTES_PER_S)
    dense = torch.zeros((4, 64, 64 * 4))
    dense[3] = 1.0
    xy = torch.zeros((2, 64, 256))
    ops = counts.window_pairs(dense[3], 4, 3) * counts.PAIR_OPS
    assert ops / counts.FP32_OPS_PER_S > (4 * 8 * xy[0].numel()
                                          / counts.HBM_BYTES_PER_S)
    assert counts.substep_pass_seconds(xy, dense, 4, 3, out=xy) == \
        pytest.approx(ops / counts.FP32_OPS_PER_S)


def _port_tally(monkeypatch, sink):
    """Count the bounds from the inputs the port's kernel routes get."""
    from egg_fluid_simulation_tpu_torch.ops.kernels import (splat_kernel,
                                                            sweep_kernel)
    from egg_fluid_simulation_tpu_torch.ops import render
    pass_fn, splat_fn = sweep_kernel.substep_pass, splat_kernel.splat

    def substep_pass(xy, stat, params, aux, k, *, window=1, prev=None,
                     follow=None, integrate=False, wide=None, **kw):
        out = pass_fn(xy, stat, params, aux, k, window=window, prev=prev,
                      follow=follow, integrate=integrate, wide=wide, **kw)
        w = window if wide is None else (3 if bool(wide) else 1)
        sink["substep_pass"] = sink.get("substep_pass", 0.0) + \
            counts.substep_pass_seconds(xy, stat, k, w,
                                        prev if integrate else None,
                                        follow if integrate else None, out)
        return out

    def splat(payload, cnt, opts, use_rgb):
        alpha, rgb = splat_fn(payload, cnt, opts, use_rgb)
        sink["splat"] = sink.get("splat", 0.0) + counts.splat_seconds(
            payload, cnt, opts, alpha, rgb, splat_kernel.cull_counts,
            render._tile_bins)
        return alpha, rgb

    monkeypatch.setattr(sweep_kernel, "substep_pass", substep_pass)
    monkeypatch.setattr(splat_kernel, "splat", splat)


def test_same_counts_from_the_reference_and_the_port(monkeypatch):
    torch.set_num_threads(2)
    _, w, f = bench_tiny.files("frames")
    cfg = f["cfg"]
    specs = scene.batch_specs(cfg["scene"], 3)
    h, _ = system.build(cfg, specs, "cpu")
    h.run_steps(3)
    before, wide = system.snapshot(h), system.wide_state(h)
    port = {}
    _port_tally(monkeypatch, port)
    h.update(1 / 60)
    after = system.snapshot(h)
    h.draw(viewport=(0.0, 0.0, 512, 512))
    ref = Reference(cfg, specs, "cpu")
    mine = {}
    with tally.tally(mine):
        ref.step(before, wide, None, 1 / 60)
    assert mine["substep_pass"] == port["substep_pass"] > 0
    drawn = {}
    with tally.tally(drawn):
        ref.draw(before, after, (0.0, 0.0, 512, 512), 0.0)
    assert drawn["splat"] == pytest.approx(port["splat"], rel=1e-12)
    assert drawn["splat"] > 0
