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
        torch.tensor(0.0003), ot, upsample=False)
    np.testing.assert_array_equal(audit_t.numpy(), np.asarray(audit_j))
    assert float(at.max()) > 0.5
    np.testing.assert_allclose(at.numpy(), np.asarray(jax.block_until_ready(aj)),
                               rtol=0, atol=2e-6)
    if use_rgb:
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0,
                                   atol=2e-6)


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
