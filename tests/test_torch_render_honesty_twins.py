"""The port against the JAX package on the render and capacity gates of
``tests/test_overflow.py:68``, ``tests/test_solver_honesty.py:43, 75`` and
``tests/test_post_modes.py:54``:

- a scene larger than its canvas, splatted on a 256 and a 512 px canvas by
  both packages' ``render.splat_population`` (the port's plain version):
  each canvas at that test's atol 1e-5, the overflow counts equal;
- the automatic options of the packed 16k scene: every field equal, and
  the live counts;
- (slow, as in the JAX suite) a 2000-particle batch settled 60 resident
  steps by both packages: its spread and cell occupancy alike, at the JAX
  test's tolerances against its oracle;
- (slow) the post modes' edge error against an exact-alpha truth render:
  the truth and each mode's frame within 1e-4 of the JAX render, the
  errors alike.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.ops import render as jrender
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.ops import render as trender

import torch_twins as TW


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    TW.pin_plane_path(monkeypatch)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _edge_scene():
    rng = np.random.default_rng(7)
    xs = np.linspace(-10.0, 310.0, 56)
    p = np.stack(np.meshgrid(xs, xs), axis=-1).reshape(-1, 2)
    return (p + rng.uniform(-1.5, 1.5, p.shape)).astype(np.float32)


@pytest.mark.parametrize("size", [256, 512])
def test_clamped_canvas_splat_as_jax(size):
    """``test_clamped_canvas_edge_contributions_match_unclamped``."""
    p = _edge_scene()
    n = p.shape[0]
    arrays = (p, p, np.zeros_like(p), np.full(n, 3.0, np.float32),
              np.tile(np.asarray([1.0, 1.0, 1.0, 0.9], np.float32), (n, 1)),
              np.ones(n, bool), np.asarray([150.0, 150.0], np.float32))
    opts = dict(canvas_size=size, tile_h=32, tile_w=128, bin_h=16, bin_w=16,
                max_splat_px=16, tile_capacity=32)
    aj, _, ovj = jrender.splat_population(
        *map(jnp.asarray, arrays), jnp.float32(1.0), jnp.float32(4.0),
        jnp.float32(0.0), jrender.RenderOptions(**opts), use_pallas=False)
    at, _, audit = trender.splat_population(
        *map(torch.from_numpy, arrays), torch.tensor(1.0), torch.tensor(4.0),
        torch.tensor(0.0), trender.RenderOptions(**opts))
    assert at.shape == (size, size)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5,
                               atol=1e-5)
    assert int(audit[0]) == int(np.asarray(ovj)[0])


def _packed(pkg, **kw):
    """``tests/test_solver_honesty.py``'s packed 16k scene in ``pkg``."""
    per_batch, n_batches = 1000, 16
    capacity = 1 << int(np.ceil(np.log2(16_000 + n_batches)))
    h = pkg.SimulationHandler(pkg.default_white_config(),
                              pkg.default_yolk_config(), capacity=capacity,
                              max_batches=16, **kw)
    side = int(math.ceil(math.sqrt(n_batches)))
    radius = float(np.sqrt(per_batch) * 4.0)
    spacing = radius * 2.2
    for b in range(n_batches):
        h.add(float((b % side) * spacing + spacing),
              float((b // side) * spacing + spacing), radius, radius * 0.3,
              None, None, per_batch, per_batch // 10)
    return h


def test_packed_scene_options_as_jax():
    """``test_auto_grid_has_headroom_for_packed_scenes``."""
    hj = _packed(J)
    ht = _packed(T, device="cpu")
    names = [f.name for f in dataclasses.fields(jsolver.SolverOptions)]
    assert ({f: getattr(ht._options, f) for f in names}
            == {f: getattr(hj._options, f) for f in names})
    assert ht.get_n_particles() == hj.get_n_particles()
    TW.assert_host_fields(host_view(hj.state), TW.state_to_numpy(ht.state))


def _occ_spread(p, cell):
    c = np.floor(p / cell).astype(int)
    cnt = np.bincount((c[:, 1] % 128) * 128 + (c[:, 0] % 128),
                      minlength=128 * 128)
    return cnt[cnt > 0].mean(), cnt.max(), np.hypot(*(p - p.mean(0)).T).mean()


@pytest.mark.slow
def test_packed_batch_equilibrium_as_jax():
    """``test_packed_batch_matches_oracle_equilibrium``: the two packages'
    settled batches (their free runs part, so statistics are compared, at
    the tolerances the JAX test holds its engine to the oracle)."""
    n = 2000
    r = float(np.sqrt(n) * 4.0)
    opts = dict(engine="dense", budget_mode="off", dense_rebin="step",
                dense_grid_dim=128, dense_slots=4, use_pallas=False)
    hj, ht = TW.pair(capacity=4096, max_batches=4, options=opts)
    TW.both(hj, ht, "add", 600.0, 600.0, r, r * 0.3, None, None, n, 2)
    hj.run_steps(60)
    ht.run_steps(60)
    wc = J.default_white_config()
    cell = max(1.0, wc["max_radius"] * max(
        wc["collision_overlap_factor"],
        wc["cohesion_interaction_distance_factor"]))
    mean_j, max_j, spread_j = _occ_spread(np.asarray(hj.state.pos)[0][:n],
                                          cell)
    mean_t, max_t, spread_t = _occ_spread(ht.state.pos[0, :n].numpy(), cell)
    assert abs(spread_t - spread_j) / spread_j < 0.15, (spread_t, spread_j)
    assert abs(mean_t - mean_j) / mean_j < 0.30, (mean_t, mean_j)
    assert max_t <= max(2 * max_j, max_j + 8), (max_t, max_j)


@pytest.mark.slow
def test_edge_quality_as_jax():
    """``test_edge_quality_improves_with_post_resolution``: the truth
    render and each post mode's frame of one JAX-stepped state, drawn by
    both packages' ``_render_frame``."""
    opts = dict(engine="dense", budget_mode="off", dense_rebin="step",
                dense_grid_dim=32, dense_slots=4, use_pallas=False,
                adaptive_rebin=False)
    hj, ht = TW.pair(capacity=512, max_batches=8, canvas_size=256,
                     options=opts)
    TW.both(hj, ht, "add", 128.0, 128.0, 30.0, 10.0, None, None, 60, 14)
    hj.step_once()
    TW.carry(hj, ht)

    def renders(mode):
        out = []
        for pkg, h, f32, mk in ((jrender, hj, jnp.float32, jnp.asarray),
                                (trender, ht, torch.tensor,
                                 torch.tensor)):
            o2 = tuple(pkg.auto_render_options(
                c, 256, post_mode="full" if mode == "truth" else mode)
                for c in (h._white_config, h._yolk_config))
            if mode == "truth":
                # exact alpha, full-resolution passes, the splat's reach
                # grown back to full-resolution pixels
                o2 = tuple(dataclasses.replace(
                    o, downsample=1, tile_h=32, tile_w=64, bin_h=32,
                    bin_w=32, tile_capacity=256, post_mode="full",
                    max_splat_px=min(64, o.max_splat_px * o.downsample))
                    for o in o2)
            f, _, _ = pkg._render_frame(
                h.state, h.stats, h._device_cfg2(), f32(1.0), f32(0.3),
                f32(0.01), mk([0.0, 0.0]), o2, True, 256, 256,
                pop_caps=h._options.pop_caps)
            out.append(np.asarray(f))
        return out

    tj, tt = renders("truth")
    np.testing.assert_allclose(tt, tj, rtol=0, atol=TW.FRAME_TOL)
    for mode in ("coarse", "full", "super"):
        fj, ft = renders(mode)
        np.testing.assert_allclose(ft, fj, rtol=0, atol=TW.FRAME_TOL)
        ej = float(np.abs(fj - tj).mean())
        et = float(np.abs(ft - tt).mean())
        assert abs(et - ej) <= TW.FRAME_TOL, (mode, et, ej)
