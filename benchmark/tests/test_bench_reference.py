"""The reference against the port's plain path on a small scene on the
CPU, where the port runs its kernels' plain versions: the spawn, fixed
steps, a resident ``run_steps`` call with its rebins, and the frame."""

import dataclasses

import numpy as np
import torch

from benchmark import scene, system
from benchmark.reference.model import Clock, Reference

import bench_tiny


def _pair(seed=5):
    torch.set_num_threads(2)
    _, _, f = bench_tiny.files("frames")
    cfg = f["cfg"]
    specs = scene.batch_specs(cfg["scene"], seed)
    h, _ = system.build(cfg, specs, "cpu")
    return cfg, specs, h, Reference(cfg, specs, "cpu")


def _same(a, b):
    return all(torch.equal(a[k], getattr(b, k)) for k in a)


def test_spawn_options_and_steps_bit_for_bit():
    cfg, specs, h, ref = _pair()
    got = system.snapshot(h, system.SPAWN)
    for k, v in ref.spawned.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert dataclasses.asdict(ref.options) == dataclasses.asdict(h._options)
    wide = None
    for _ in range(3):
        before = system.snapshot(h)
        h.update(1 / 60)
        st, stats, wide = ref.step(before, wide, None, 1 / 60)
        assert _same(system.snapshot(h), st)
        assert _same(system.stats(h), stats)
        assert all(torch.equal(a, b) for pa, pb in
                   zip(system.wide_state(h), wide) for a, b in zip(pa, pb))


def test_run_steps_and_rebins_bit_for_bit():
    cfg, specs, h, ref = _pair(7)
    from egg_fluid_simulation_tpu_torch.ops import solver
    h.update(1 / 60)
    before, wide = system.snapshot(h), system.wide_state(h)
    r0 = list(solver.rebins)
    h.run_steps(6)
    st, stats, _, rebins = ref.run_steps(before, wide, None, 6, 1 / 60)
    assert _same(system.snapshot(h), st)
    assert _same(system.stats(h), stats)
    assert [b - a for a, b in zip(r0, solver.rebins)] == rebins


def test_frame_against_the_port_draw():
    cfg, specs, h, ref = _pair(9)
    h.run_steps(4)
    before = system.snapshot(h)
    h.update(1 / 60)
    frame = h.draw(viewport=(-40.0, -30.0, 512, 512))
    want = ref.draw(before, system.snapshot(h), (-40.0, -30.0, 512, 512),
                    h.interpolation_alpha)
    assert frame.shape == want.shape == (512, 512, 4)
    assert float(want[..., 3].max()) > 0.5
    assert float((frame - want).abs().max()) <= 1e-5


def test_clock_is_the_update_accumulator():
    cfg, specs, h, ref = _pair()
    clock = Clock()
    for dt in (1 / 60, 1 / 144, 1 / 30, 0.2, 1 / 60):
        n, alpha = clock.advance(dt)
        h.update(dt)
        assert alpha == h.interpolation_alpha
        assert clock.elapsed == h._elapsed


def test_batched_pair_sums_bit_for_bit():
    """The reference's batched pair sums against the frozen loop, both
    windows, with and without cohesion, on random occupied planes whose
    particles crowd their cells (and a chunk smaller than the offsets)."""
    from benchmark.reference import batched
    gen = torch.Generator().manual_seed(0)
    g, k = 12, 4
    lanes = g * k
    occ = (torch.rand((g, lanes), generator=gen) < 0.6).float()
    cell = torch.arange(lanes) // k
    xf = (cell[None, :] + torch.rand((g, lanes), generator=gen)) * 8.0
    yf = (torch.arange(g)[:, None] + torch.rand((g, lanes),
                                                generator=gen)) * 8.0
    xf[3, 5] = xf[3, 6]                       # a coincident pair
    yf[3, 5] = yf[3, 6]
    W = torch.rand((g, lanes), generator=gen) + 0.5
    R = torch.full((g, lanes), 4.0)
    BA = torch.randint(0, 3, (g, lanes), generator=gen).float()
    consts = (torch.tensor(0.01), torch.tensor(0.2), torch.tensor(2.0),
              torch.tensor(2.0), None)
    old = batched.CHUNK_ELEMS
    try:
        for elems in (old, 5 * int((occ > 0).sum())):
            batched.CHUNK_ELEMS = elems
            for w, cohesion in ((1, True), (3, True), (1, False)):
                fields = [xf, yf, W * occ, R * occ, occ]
                cs = consts
                if cohesion:
                    fields.append(BA)
                if w == 3:
                    fm = torch.tensor(float(g))
                    fields += [torch.remainder(torch.floor(xf / 8.0), fm),
                               torch.remainder(torch.floor(yf / 8.0), fm)]
                    cs = consts[:4] + (fm,)
                want = batched.LOOP(fields, k, w, cohesion, cs)
                got = batched.occupied_sums(fields, k, w, cohesion, cs)
                assert all(torch.equal(a, b) for a, b in zip(got, want))
                assert float(want[0].abs().max()) > 0
    finally:
        batched.CHUNK_ELEMS = old
