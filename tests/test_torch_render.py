"""Render pipeline of the PyTorch port against the JAX package.

Inputs are one host state (random velocities, interpolated frame) handed to
both packages. Off the TPU the JAX render takes its plain splat scan, the
port the plain version of kernel C: the same per-candidate math, products
taken in another grouping.

Tolerances, with their reasons:

- splat alpha/rgb: atol 2e-6. ``1 - prod(1 - g)`` over up to a few hundred
  candidates, the products grouped differently and ``exp`` rounded by two
  libraries (XLA's and PyTorch's): a few float32 ulps of the product
  (4e-7 measured).
- the extent-box cull of kernel C (``splat_kernel.cull_counts``): a numpy
  reference that drops every candidate whose box misses the tile before it
  multiplies, products and ``exp`` in float64, against ``splat_plain``: atol
  2e-6 (float32 products of a few hundred factors against float64; a wrongly
  culled candidate would show as 1e-2 or more). The ``inside`` masks are
  formed in float32 as the plain version forms them, so no pixel on a quad's
  border flips.
- ``chip_smoke.splat_inside_pairs`` (the work kernel C's bound counts): an
  exact count, against a numpy loop over the tiles with the same float32
  ``inside`` masks.
- whole frames (outline + lighting + composite): atol 1e-4 per channel.
  The threshold smoothstep is steep (width 0.02 around alpha 0.3, slope
  75), the specular term is a 48th power of a Sobel normal, and the
  bilinear upsample matrices are summed in another order, so the splat's
  ulps grow on edge pixels (9e-6 measured).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu import handler as jhandler
from egg_fluid_simulation_tpu import state as jstate
from egg_fluid_simulation_tpu.ops import render as jrender
from egg_fluid_simulation_tpu_torch.interop import state_from_numpy
from egg_fluid_simulation_tpu_torch.ops import render as trender
from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel
from egg_fluid_simulation_tpu_torch.state import StepStats

import chip_smoke

SPECS = [dict(x=200.0, y=180.0, white_radius=60.0, yolk_radius=14.0,
              white_n_particles=500, yolk_n_particles=40),
         dict(x=300.0, y=260.0, white_radius=50.0, yolk_radius=12.0,
              white_n_particles=350, yolk_n_particles=30,
              white_color=[0.2, 0.6, 0.9, 0.8])]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """Host state of two spawned batches with random velocities, a shifted
    last position (frame interpolation) and random particle colours."""
    h = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                            capacity=1024, max_batches=4,
                            options=J.SolverOptions(engine="dense",
                                                    budget_mode="off",
                                                    dense_grid_dim=32),
                            canvas_size=256)
    h.add_many(SPECS)
    d = {k: np.array(v) for k, v in jstate.host_view(h.state).items()}
    rng = np.random.RandomState(0)
    d["vel"] = rng.uniform(-300.0, 300.0, d["vel"].shape).astype(np.float32)
    d["last_pos"] = (d["pos"] - d["vel"] / 60.0).astype(np.float32)
    d["color"][..., :3] = rng.uniform(0.0, 1.0, d["color"][..., :3].shape)
    sj = jstate.ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})
    stats_j = jhandler._compute_stats(sj)
    stats_t = StepStats(**{f.name: torch.from_numpy(
        np.array(getattr(stats_j, f.name))) for f in dataclasses.fields(StepStats)})
    return dict(d=d, sj=sj, st=state_from_numpy(d), stats_j=stats_j,
                stats_t=stats_t, h=h)


def _opts(scene, pop, use_rgb, post_mode="coarse"):
    cfg = (J.default_white_config() if pop == 0 else J.default_yolk_config())
    kw = dict(use_particle_color=use_rgb, density=0.02, post_mode=post_mode)
    oj = jrender.auto_render_options(cfg, 256, **kw)
    ot = trender.auto_render_options(cfg, 256, **kw)
    assert dataclasses.asdict(oj) == dataclasses.asdict(ot)
    return oj, ot


@pytest.mark.parametrize("use_rgb", [False, True], ids=["alpha", "rgb"])
@pytest.mark.parametrize("pop", [0, 1], ids=["white", "yolk"])
def test_splat_plain_matches_jax_scan(scene, pop, use_rgb):
    oj, ot = _opts(scene, pop, use_rgb)
    d = scene["d"]
    cap = 1024
    act = np.arange(cap) < d["count"][pop]
    center = np.array(scene["stats_j"].centroid)[pop]
    args = [d["pos"][pop], d["last_pos"][pop], d["vel"][pop],
            d["radius"][pop], d["color"][pop], act]
    aj, rj, audit_j = jrender.splat_population(
        *[jnp.asarray(a) for a in args], jnp.asarray(center), jnp.float32(0.7),
        jnp.float32(12.0), jnp.float32(0.0003), oj, upsample=False,
        use_pallas=False)
    at, rt, audit_t = trender.splat_population(
        *[torch.from_numpy(np.asarray(a)) for a in args],
        torch.from_numpy(center), torch.tensor(0.7), torch.tensor(12.0),
        torch.tensor(0.0003), ot)
    np.testing.assert_array_equal(audit_t.numpy(), np.asarray(audit_j))
    assert float(at.max()) > 0.5
    np.testing.assert_allclose(at.numpy(), np.asarray(jax.block_until_ready(aj)),
                               rtol=0, atol=2e-6)
    if use_rgb:
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                                   atol=2e-6)


def _payload(scene, pop, ot):
    """The port's render payload of population ``pop`` of the scene."""
    d = scene["d"]
    act = np.arange(1024) < d["count"][pop]
    center = np.array(scene["stats_j"].centroid)[pop]
    args = [d["pos"][pop], d["last_pos"][pop], d["vel"][pop],
            d["radius"][pop], d["color"][pop], act]
    return trender._splat_payload(
        *[torch.from_numpy(np.asarray(a)) for a in args],
        torch.from_numpy(center), torch.tensor(0.7), torch.tensor(12.0),
        torch.tensor(0.0003), ot)


def _splat_reference_culled(payload, counts, opts, use_rgb):
    """Numpy splat that culls first: per tile, the occupied window candidates
    (``min(counts, K)`` a bin) whose extent box reaches the tile's pixel
    centres, multiplied in float64. Returns (alpha, rgb, in_window, staged),
    the last two per tile."""
    s, th, tw, k = opts.eff_size, opts.tile_h, opts.tile_w, opts.tile_capacity
    nb = trender._tile_bins(opts).numpy()
    p32 = payload.numpy()
    ex, ey = (t.numpy().astype(np.float64) for t in
              splat_kernel.extent_box(payload.to(torch.float64),
                                      opts.max_splat_px))
    occupied = np.arange(k)[None, :] < np.minimum(counts.numpy(), k)[:, None]
    msp = np.float32(opts.max_splat_px)
    alpha = np.zeros((s, s))
    rgb = np.zeros((s, s, 3))
    in_window, staged = [], []
    ntx = s // tw
    for t, bins in enumerate(nb):
        y0, x0 = (t // ntx) * th, (t % ntx) * tw
        c = p32[bins][occupied[bins]]                       # (n, F) float32
        bx, by = ex[bins][occupied[bins]], ey[bins][occupied[bins]]
        cx, cy = c[:, 0].astype(np.float64), c[:, 1].astype(np.float64)
        reach = ((cx >= x0 + 0.5 - bx) & (cx <= x0 + tw - 0.5 + bx)
                 & (cy >= y0 + 0.5 - by) & (cy <= y0 + th - 0.5 + by))
        in_window.append(len(c))
        staged.append(int(reach.sum()))
        c = c[reach]
        px = (np.arange(tw, dtype=np.float32) + np.float32(0.5)
              + np.float32(x0))[None, :, None]
        py = (np.arange(th, dtype=np.float32) + np.float32(0.5)
              + np.float32(y0))[:, None, None]
        pcx, pcy, ca, sa, bs, bs_sm, isx, isy, ap = (c[None, None, :, j]
                                                     for j in range(9))
        dx, dy = px - pcx, py - pcy                         # float32
        d_par = dx * ca + dy * sa
        d_perp = -dx * sa + dy * ca
        inside = ((np.abs(d_par) <= bs_sm) & (np.abs(d_perp) <= bs)
                  & (np.abs(dx) <= msp) & (np.abs(dy) <= msp))
        nx = d_par.astype(np.float64) * isx
        ny = d_perp.astype(np.float64) * isy
        g = np.where(inside, np.exp(-(4.0 * np.pi / 3.0) * (nx * nx + ny * ny))
                     * ap, 0.0)
        alpha[y0:y0 + th, x0:x0 + tw] = 1.0 - np.prod(1.0 - g, axis=-1)
        if use_rgb:
            col = c[None, None, :, 9:12].astype(np.float64)
            rgb[y0:y0 + th, x0:x0 + tw] = 1.0 - np.prod(
                1.0 - g[..., None] * col, axis=-2)
    return alpha, rgb, np.array(in_window), np.array(staged)


@pytest.mark.parametrize("use_rgb", [False, True], ids=["alpha", "rgb"])
@pytest.mark.parametrize("pop", [0, 1], ids=["white", "yolk"])
def test_extent_box_cull_changes_nothing(scene, pop, use_rgb):
    """Dropping the candidates whose extent box misses the tile leaves the
    splat as it was, and ``cull_counts`` counts the same survivors."""
    _, ot = _opts(scene, pop, use_rgb)
    payload, audit, counts = _payload(scene, pop, ot)
    want_a, want_rgb = splat_kernel.splat_plain(payload, counts, ot, use_rgb)
    alpha, rgb, in_window, staged = _splat_reference_culled(payload, counts,
                                                            ot, use_rgb)
    assert float(want_a.max()) > 0.5
    np.testing.assert_allclose(want_a.numpy(), alpha, rtol=0, atol=2e-6)
    if use_rgb:
        np.testing.assert_allclose(want_rgb.numpy(), rgb, rtol=0, atol=2e-6)
    # the cull has work to do here, and its plain form counts alike
    assert 0 < staged.sum() < 0.9 * in_window.sum()
    got_window, got_staged = splat_kernel.cull_counts(payload, counts, ot)
    np.testing.assert_array_equal(got_window.numpy(), in_window)
    assert np.abs(got_staged.numpy() - staged).max() <= 1   # box-edge rounding


def test_cull_reference_with_an_overflowed_bin(scene):
    """A bin that holds more particles than its budget: ``counts`` exceeds
    K, only the first K slots exist, and the culled reference (which reads
    ``min(counts, K)`` slots a bin, as kernel C does) still agrees."""
    _, ot = _opts(scene, 0, True)
    ot = dataclasses.replace(ot, tile_capacity=8)
    payload, audit, counts = _payload(scene, 0, ot)
    assert int(audit[0]) > 0 and int(counts[:-1].max()) > ot.tile_capacity
    want_a, want_rgb = splat_kernel.splat_plain(payload, counts, ot, True)
    alpha, rgb, in_window, staged = _splat_reference_culled(payload, counts,
                                                            ot, True)
    np.testing.assert_allclose(want_a.numpy(), alpha, rtol=0, atol=2e-6)
    np.testing.assert_allclose(want_rgb.numpy(), rgb, rtol=0, atol=2e-6)
    assert in_window.max() <= trender._tile_bins(ot).shape[1] * 8
    assert float(want_a.max()) > 0.5


def test_cull_reference_on_an_empty_window(scene):
    """No candidate anywhere: alpha is exactly 0 and nothing is staged, also
    where ``counts`` is positive only in the payload's last row (particles
    that reach no bin)."""
    _, ot = _opts(scene, 0, False)
    payload, _, counts = _payload(scene, 0, ot)
    payload = torch.zeros_like(payload)
    counts = torch.zeros_like(counts)
    counts[-1] = 700
    want_a, _ = splat_kernel.splat_plain(payload, counts, ot, False)
    alpha, _, in_window, staged = _splat_reference_culled(payload, counts, ot,
                                                          False)
    assert float(want_a.abs().max()) == 0.0 and np.abs(alpha).max() == 0.0
    got_window, got_staged = splat_kernel.cull_counts(payload, counts, ot)
    assert int(got_window.sum()) == int(got_staged.sum()) == 0
    assert in_window.sum() == staged.sum() == 0


def test_extent_box_holds_every_inside_pixel():
    """Seeded candidates with any direction, smear and size: every pixel that
    passes the kernel's ``inside`` test lies within ``extent_box`` of the
    candidate's centre; a zero direction falls back to the static cap."""
    rng = np.random.default_rng(3)
    n = 4000
    ang = rng.uniform(0, 2 * np.pi, n)
    e_perp = rng.uniform(0.5, 20.0, n)
    e_par = e_perp * rng.uniform(1.0, 3.0, n)
    cand = np.zeros((n, 9), np.float32)
    cand[:, 2], cand[:, 3] = np.cos(ang), np.sin(ang)
    cand[::50, 2:4] = 0.0                                   # no direction
    cand[:, 4], cand[:, 5] = e_perp, e_par
    msp = 16
    ex, ey = (t.numpy() for t in splat_kernel.extent_box(
        torch.from_numpy(cand), msp))
    assert np.all(ex[::50] == np.float32(msp) + np.float32(0.01))
    off = rng.uniform(-40.0, 40.0, (64, n, 2)).astype(np.float32)
    dx, dy = off[..., 0], off[..., 1]
    d_par = dx * cand[:, 2] + dy * cand[:, 3]
    d_perp = -dx * cand[:, 3] + dy * cand[:, 2]
    inside = ((np.abs(d_par) <= cand[:, 5]) & (np.abs(d_perp) <= cand[:, 4])
              & (np.abs(dx) <= msp) & (np.abs(dy) <= msp))
    assert inside.sum() > 1000
    assert np.all(np.abs(dx)[inside] <= np.broadcast_to(ex, dx.shape)[inside])
    assert np.all(np.abs(dy)[inside] <= np.broadcast_to(ey, dy.shape)[inside])


@pytest.mark.parametrize("pop", [0, 1], ids=["white", "yolk"])
def test_inside_pair_count_of_the_splat_bound(scene, pop):
    """The (candidate, pixel) pairs inside a quad, as the chip check counts
    them for kernel C's bound: the numpy count over every occupied window
    candidate, all of them among the candidates the cull stages."""
    _, ot = _opts(scene, pop, False)
    payload, _, counts = _payload(scene, pop, ot)
    s, th, tw, k = ot.eff_size, ot.tile_h, ot.tile_w, ot.tile_capacity
    nb = trender._tile_bins(ot).numpy()
    p32 = payload.numpy()
    occupied = np.arange(k)[None, :] < np.minimum(counts.numpy(), k)[:, None]
    msp = np.float32(ot.max_splat_px)
    want = 0
    for t, bins in enumerate(nb):
        y0, x0 = (t // (s // tw)) * th, (t % (s // tw)) * tw
        c = p32[bins][occupied[bins]]
        px = (np.arange(tw, dtype=np.float32) + np.float32(0.5)
              + np.float32(x0))[None, :, None]
        py = (np.arange(th, dtype=np.float32) + np.float32(0.5)
              + np.float32(y0))[:, None, None]
        dx, dy = px - c[None, None, :, 0], py - c[None, None, :, 1]
        d_par = dx * c[:, 2] + dy * c[:, 3]
        d_perp = -dx * c[:, 3] + dy * c[:, 2]
        want += int(((np.abs(d_par) <= c[:, 5]) & (np.abs(d_perp) <= c[:, 4])
                     & (np.abs(dx) <= msp) & (np.abs(dy) <= msp)).sum())
    got = chip_smoke.splat_inside_pairs(payload, counts, ot)
    assert got == want > 0
    _, staged = splat_kernel.cull_counts(payload, counts, ot)
    assert got < int(staged.sum()) * th * tw


@pytest.mark.parametrize("use_rgb", [False, True], ids=["alpha", "rgb"])
@pytest.mark.parametrize("post_mode", ["coarse", "full", "super"])
def test_render_frame_matches_jax(scene, post_mode, use_rgb):
    h = scene["h"]
    opts_j = tuple(_opts(scene, p, use_rgb, post_mode)[0] for p in (0, 1))
    opts_t = tuple(_opts(scene, p, use_rgb, post_mode)[1] for p in (0, 1))
    cfg2_j = h._device_cfg2()
    cfg2_t = T.SimulationHandler(T.default_white_config(),
                                 T.default_yolk_config(), capacity=16,
                                 device="cpu")._device_cfg2()
    vw, vh = 384, 320
    origin = np.array([40.5, 20.25], np.float32)
    fj, cj, oj = jrender._render_frame(
        scene["sj"], scene["stats_j"], cfg2_j, jnp.float32(0.7),
        jnp.float32(0.3), jnp.float32(0.01), jnp.asarray(origin), opts_j,
        True, vw, vh)
    ft, ct, ot = trender._render_frame(
        scene["st"], scene["stats_t"], cfg2_t, torch.tensor(0.7),
        torch.tensor(0.3), torch.tensor(0.01), torch.from_numpy(origin),
        opts_t, True, vw, vh)
    fj = np.asarray(jax.block_until_ready(fj))
    assert ft.shape == (vh, vw, 4)
    assert fj[..., 3].max() > 0.9
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=1e-4)
    for a, b in zip(ct, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6)


def test_splat_wrapper_takes_plain_on_cpu_and_rejects_other_devices(scene):
    oj, ot = _opts(scene, 0, False)
    payload = torch.zeros((10, ot.tile_capacity, 9))
    counts = torch.zeros(10, dtype=torch.int32)
    before = splat_kernel.launches
    with pytest.raises(RuntimeError):
        splat_kernel.splat(payload.to("meta"), counts.to("meta"), ot, False)
    assert splat_kernel.launches == before
