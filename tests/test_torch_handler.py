"""SimulationHandler of the PyTorch port against the JAX package's.

Host-side work (validation, fibonacci spirals, butterworth masses, batch
bookkeeping, compaction on remove) is the same numpy code, so the host
state arrays must be equal bit for bit. ``update`` + ``draw`` run end to end
on the CPU (the plain versions of the kernels) and are held to the JAX
handler given the same explicit options: one step of a spawn whose
particles do not overlap, positions atol 1e-3 px (the fused-vs-plane
tolerance of tests/test_fused_path.py), frames atol 2e-4 per channel
(test_torch_render.py's frame tolerance, doubled for the positions' ulps
reaching the steep threshold smoothstep; 2e-5 measured).

Also checked: the package imports neither JAX nor the JAX package, and every
kernel module imports where there is no ``nvcc`` and no ``triton``.
"""

import io
import re
import subprocess
import sys
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

import jax

import egg_fluid_simulation_tpu as J
import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch.interop import state_to_numpy
from egg_fluid_simulation_tpu_torch.ops.kernels import (place_kernel,
                                                        splat_kernel,
                                                        sweep_kernel)

SPECS = [dict(x=120.0, y=110.0, white_radius=64.0, yolk_radius=16.0,
              white_n_particles=40, yolk_n_particles=4),
         dict(x=300.0, y=160.0, white_radius=48.0, yolk_radius=16.0,
              white_n_particles=24, yolk_n_particles=4,
              white_color=[0.5, 0.7, 0.9, 1.0]),
         dict(x=200.0, y=300.0)]


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    # pin the JAX step to its CPU path (the plane path) whatever interpret
    # switch an earlier test file set for the session
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(canvas_size=None, wide=0, **kw):
    opts = dict(engine="dense", budget_mode="off", dense_rebin="step",
                dense_grid_dim=64, dense_slots=4, wide_budget_substeps=wide)
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                             capacity=1024, max_batches=8,
                             options=J.SolverOptions(**opts),
                             canvas_size=canvas_size, **kw)
    ht = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                             capacity=1024, max_batches=8,
                             options=T.SolverOptions(**opts),
                             canvas_size=canvas_size, device="cpu", **kw)
    return hj, ht


def _assert_same_host_state(hj, ht):
    a, b = host_view(hj.state), state_to_numpy(ht.state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b[k].dtype == a[k].dtype, k


def test_add_many_and_remove_bit_identical():
    hj, ht = _pair()
    assert hj.add_many(SPECS) == ht.add_many(SPECS)
    _assert_same_host_state(hj, ht)
    assert ht.get_n_particles() == hj.get_n_particles()
    assert ht.list_ids() == hj.list_ids()
    for bid in ht.list_ids():
        assert ht.get_n_particles(bid) == hj.get_n_particles(bid)
        assert ht.get_target_position(bid) == hj.get_target_position(bid)
        np.testing.assert_allclose(ht.get_position(bid), hj.get_position(bid),
                                   rtol=1e-5)
    for f in ("centroid", "aabb_min", "aabb_max", "max_radius", "batch_count"):
        np.testing.assert_allclose(getattr(ht.stats, f).numpy(),
                                   np.asarray(getattr(hj.stats, f)),
                                   rtol=0, atol=1e-3, err_msg=f)
    hj.remove(2)
    ht.remove(2)
    _assert_same_host_state(hj, ht)
    assert ht.list_ids() == hj.list_ids() == [1, 3]
    hj.add(50.0, 60.0)
    ht.add(50.0, 60.0)
    _assert_same_host_state(hj, ht)


def test_update_and_draw_end_to_end_match_jax():
    hj, ht = _pair(canvas_size=512)
    hj.add_many(SPECS[:2])
    ht.add_many(SPECS[:2])
    for h in (hj, ht):
        h.set_target_position(1, 130.0, 120.0)
        h.update(1 / 60)
        h.update(0.5 / 60)     # accumulates, no step: interpolation alpha 0.5
    assert ht.interpolation_alpha == hj.interpolation_alpha == 0.5
    a, b = host_view(hj.state), state_to_numpy(ht.state)
    np.testing.assert_allclose(b["pos"], a["pos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["prev"], a["prev"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(b["vel"], a["vel"], rtol=0, atol=0.2)
    assert np.abs(b["pos"] - b["last_pos"]).max() > 0.1
    view = (0.0, 0.0, 448, 384)
    fj = np.asarray(jax.block_until_ready(hj.draw(viewport=view)))
    ft = ht.draw(viewport=view, background=None)
    assert ft.shape == fj.shape == (384, 448, 4)
    assert fj[..., 3].max() > 0.9
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=2e-4)
    assert ht.draw(viewport=view) is ft          # cached until the next step
    assert ht.render_audit[:, 0].sum() == 0
    fb = ht.draw(viewport=view, background=(0.1, 0.2, 0.3, 1.0))
    fjb = np.asarray(hj.draw(viewport=view, background=(0.1, 0.2, 0.3, 1.0)))
    np.testing.assert_allclose(fb.numpy(), fjb, rtol=0, atol=2e-4)


def _launch_counts():
    return (place_kernel.launches, sweep_kernel.launches,
            sweep_kernel.sweep_launches, sweep_kernel.sweep_sym_launches,
            sweep_kernel.count_launches, splat_kernel.launches)


def test_cpu_run_launches_no_kernel():
    _, ht = _pair()
    ht.add_many(SPECS[:1])
    before = _launch_counts()
    ht.step_once()
    ht.draw(viewport=(0, 0, 320, 240))
    assert _launch_counts() == before


def test_auto_options_turn_the_budget_off_at_dense_scale():
    """A handler with automatic options at capacity >= 16384 gets
    ``budget_mode="off"`` in both packages (the dense engine's fused path);
    a refresh after ``add`` keeps it off."""
    hj = J.SimulationHandler(J.default_white_config(), J.default_yolk_config(),
                             capacity=16384, max_batches=4)
    ht = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                             capacity=16384, max_batches=4, device="cpu")
    for h in (hj, ht):
        assert h._options.engine == "dense"
        assert h._options.budget_mode == "off"
        h.add(100.0, 100.0)
        assert h._options.budget_mode == "off"
    assert ht._options.pop_caps == hj._options.pop_caps
    assert ht._options.dense_grid_dim == hj._options.dense_grid_dim


def _warnings(fn):
    buf = io.StringIO()
    with redirect_stderr(buf):
        fn()
    # drop the call sites (file:line), which name each package's own source
    return [re.sub(r"In \S+:\d+: ", "", line)
            for line in buf.getvalue().splitlines()]


def test_warning_texts_match_jax():
    hj, ht = _pair()
    hj.add_many(SPECS[:1])
    ht.add_many(SPECS[:1])
    for call in (lambda h: h.set_yolk_color(1, 1.5, 0.2, 0.2),
                 lambda h: h.set_white_color(7, 0.5, 0.5, 0.5),
                 lambda h: h.set_white_config({"damping": 2.0, "nope": 1}),
                 lambda h: h.remove(99)):
        wj = _warnings(lambda: call(hj))
        wt = _warnings(lambda: call(ht))
        assert wt == wj and wt
    assert ht.get_white_config() == hj.get_white_config()
    _assert_same_host_state(hj, ht)


def test_import_pulls_in_no_jax_and_no_kernel_build():
    code = (
        "import sys, pkgutil, importlib\n"
        "import egg_fluid_simulation_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from egg_fluid_simulation_tpu_torch.ops.kernels import library\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('egg_fluid_simulation_tpu.') or m == 'egg_fluid_simulation_tpu'\n"
        "       or m == 'triton']\n"
        "assert not bad, bad\n"
        "assert library._lib is None\n"
        "assert {'egg_fluid_simulation_tpu_torch.ops.kernels.place_kernel',\n"
        "        'egg_fluid_simulation_tpu_torch.ops.kernels.sweep_kernel',\n"
        "        'egg_fluid_simulation_tpu_torch.ops.kernels.splat_kernel'} <= set(names)\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("name", ["clamp", "mix", "magnitude", "normalize2"])
def test_math_helpers_match_jax(name):
    import jax.numpy as jnp
    from egg_fluid_simulation_tpu.utils import mathx as jm
    from egg_fluid_simulation_tpu_torch.utils import mathx as tm
    rng = np.random.RandomState(0)
    v = rng.uniform(-3.0, 3.0, (64, 2)).astype(np.float32)
    v[0] = 0.0
    t = torch.from_numpy(v)
    if name == "clamp":
        got, want = tm.torch_clamp(t, -1.0, 1.5), jm.jnp_clamp(jnp.asarray(v), -1.0, 1.5)
    elif name == "mix":
        got = tm.torch_mix(t[:, 0], t[:, 1], torch.tensor(0.25))
        want = jm.jnp_mix(jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1]), 0.25)
    elif name == "magnitude":
        got, want = tm.torch_magnitude(t), jm.jnp_magnitude(jnp.asarray(v))
    else:
        got, want = tm.torch_normalize2(t)[0], jm.jnp_normalize2(jnp.asarray(v))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert tm.clamp(2.0, 0.0, 1.0) == jm.clamp(2.0, 0.0, 1.0)
    assert tm.mix(1.0, 3.0, 0.25) == jm.mix(1.0, 3.0, 0.25)
