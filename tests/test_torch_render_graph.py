"""The captured frame render (``ops/render_graph.py``) and the render's
device-read-free pieces, on the CPU.

On a CUDA handler ``draw`` replays ``render._render_frame`` from a CUDA
graph; on the CPU it renders eagerly. ``RenderGraphs(capture=False)``
replays by rendering eagerly into the graph's static outputs, so the
plumbing a capture relies on (the key, the copy-in of changed inputs, the
clone handed out, the cache bound) runs here as it runs on the card:

- ``grid.count_pairs`` (a fixed-size ``index_add_``, no read of the ids'
  maximum) bit for bit against ``torch.bincount`` and the JAX
  ``count_pairs_mxu``, out-of-range ids and an empty input included;
- the paste at a device offset bit for bit against the integer paste it
  replaced (kept here as the reference) and within 1e-6 of the JAX
  ``_paste_src_over_frac``, inside, partly and fully off each edge, at
  negative and fractional corners;
- the render budget's options (``RenderBudget.read_options``: one read of
  the stats) against the options of the three reads it replaced; the
  upsampling matrix made on the device bit for bit against the numpy
  matrix it replaced; the background composite with float operands, the
  dense handler's and the spatial handler's, against the colour tensor it
  replaced;
- draws through ``RenderGraphs(capture=False)`` with state, alpha,
  viewport origin, colour and config changes between them, bit for bit
  against a handler that renders eagerly (frame, canvases, audit); a held
  frame not overwritten by a later replay; a budget boost, a new viewport
  size or an outline thickness builds a new key; the cache bound; the
  device reads of ``draw`` (``render.host_reads``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.ops import grid as jgrid
from egg_fluid_simulation_tpu.ops import render as jrender
from egg_fluid_simulation_tpu_torch.bench import render_frame_fn
from egg_fluid_simulation_tpu_torch.ops import grid as tgrid
from egg_fluid_simulation_tpu_torch.ops import render as R
from egg_fluid_simulation_tpu_torch.ops import render_graph as RG

OPTS = dict(engine="dense", budget_mode="off", dense_rebin="step",
            dense_grid_dim=32, dense_slots=8)
VIEW = (0.0, 0.0, 160, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ count_pairs --

def _count_case(case):
    rng = np.random.RandomState(7)
    if case == "empty":
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    hi = rng.randint(0, 12, 2000).astype(np.int32)
    lo = rng.randint(0, 8, 2000).astype(np.int32)
    if case == "out_of_range":
        hi[::7] = 12                           # one past the last row
        lo[::11] = -1
        hi[::13] = -5
        lo[::17] = 9
    return hi, lo


@pytest.mark.parametrize("case", ["in_range", "out_of_range", "empty"])
def test_count_pairs_is_bincount_and_mxu_counts(case):
    hi, lo = _count_case(case)
    got = tgrid.count_pairs(torch.from_numpy(hi), torch.from_numpy(lo), 12, 8)
    assert got.dtype == torch.int64 and got.shape == (12, 8)
    ok = (hi >= 0) & (hi < 12) & (lo >= 0) & (lo < 8)
    flat = torch.from_numpy(np.where(ok, hi.astype(np.int64) * 8 + lo, 96))
    want = torch.bincount(flat, minlength=97)[:96].reshape(12, 8)
    assert torch.equal(got, want)
    mxu = np.asarray(jgrid.count_pairs_mxu(jnp.asarray(hi), jnp.asarray(lo),
                                           12, 8))
    np.testing.assert_array_equal(got.numpy(), mxu.astype(np.int64))
    assert int(got.sum()) == int(ok.sum())


# ------------------------------------------------------------------ paste --

def _int_paste(dst_rgb, dst_a, src_rgba, x0: int, y0: int):
    """The integer paste before the device offset: host ints, a slice."""
    vh, vw = dst_a.shape
    s = src_rgba.shape[0]
    placed = torch.zeros((vh, vw, 4), dtype=src_rgba.dtype)
    ys, ye = max(y0, 0), min(y0 + s, vh)
    xs, xe = max(x0, 0), min(x0 + s, vw)
    if ys < ye and xs < xe:
        placed[ys:ye, xs:xe] = src_rgba[ys - y0:ye - y0, xs - x0:xe - x0]
    src_a = torch.clamp(placed[..., 3], 0.0, 1.0)
    src_rgb = placed[..., :3]
    out_rgb = src_rgb * src_a[..., None] + dst_rgb * (1.0 - src_a[..., None])
    out_a = src_a + dst_a * (1.0 - src_a)
    return out_rgb, out_a


def _frac_paste_before(dst_rgb, dst_a, src_rgba, corner):
    """The fractional paste before: the corner's floor read to the host."""
    ci = torch.floor(corner)
    frac = corner - ci
    fx, fy = frac[0], frac[1]
    p = torch.nn.functional.pad(src_rgba, (0, 0, 1, 1, 1, 1))
    shifted = (p[1:-1, 1:-1] * (1 - fx) * (1 - fy)
               + p[1:-1, :-2] * fx * (1 - fy)
               + p[:-2, 1:-1] * (1 - fx) * fy + p[:-2, :-2] * fx * fy)
    x0, y0 = (int(v) for v in ci.tolist())
    return _int_paste(dst_rgb, dst_a, shifted, x0, y0)


# canvas 32 px on a 64 x 48 viewport: (x, y) of the canvas corner
CORNERS = {
    "inside": (10.25, 7.5),
    "off_left": (-12.5, 5.75),
    "off_right": (50.25, 6.0),
    "off_top": (3.0, -20.5),
    "off_bottom": (8.5, 30.25),
    "off_top_left": (-8.75, -9.125),
    "gone_left": (-40.0, 5.0),
    "gone_right": (70.5, 3.0),
    "gone_top": (4.0, -33.5),
    "gone_bottom": (2.0, 49.0),
    "gone_far": (-1000.5, 2000.25),
    "edge_left_whole": (-32.0, 0.0),
    "edge_left_frac": (-31.5, 0.0),
    "edge_bottom_frac": (0.0, 47.75),
}


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_paste_at_a_device_offset(name):
    rng = np.random.RandomState(3)
    src = rng.uniform(0.0, 1.2, (32, 32, 4)).astype(np.float32)
    dst_rgb = rng.uniform(0.0, 1.0, (48, 64, 3)).astype(np.float32)
    dst_a = rng.uniform(0.0, 1.0, (48, 64)).astype(np.float32)
    corner = np.asarray(CORNERS[name], np.float32)
    args = (torch.from_numpy(dst_rgb), torch.from_numpy(dst_a),
            torch.from_numpy(src), torch.from_numpy(corner))
    rgb, a = R._paste_src_over_frac(*args)
    want_rgb, want_a = _frac_paste_before(*args)
    assert torch.equal(rgb, want_rgb) and torch.equal(a, want_a)
    jrgb, ja = jrender._paste_src_over_frac(
        jnp.asarray(dst_rgb), jnp.asarray(dst_a), jnp.asarray(src),
        jnp.asarray(corner))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    # the shift stays inside the canvas: what lands is the floor's overlap
    x0, y0 = np.floor(corner).astype(int)
    touched = -32 < x0 < 64 and -32 < y0 < 48
    assert bool((a != torch.from_numpy(dst_a)).any()) == touched
    assert touched == (name.startswith(("inside", "off")) or name
                       == "edge_bottom_frac")


# ------------------------------------------------------ host-side pieces --

def _handler(graph, capacity=256, canvas_size=256, **kw):
    h = T.SimulationHandler(T.default_white_config(), T.default_yolk_config(),
                            capacity=capacity, max_batches=8,
                            canvas_size=canvas_size,
                            options=T.SolverOptions(**OPTS), device="cpu",
                            **kw)
    if graph:
        h._render_graphs = RG.RenderGraphs(capture=False)
    return h


def _spawned(graph, **kw):
    h = _handler(graph, **kw)
    h.add(120.0, 100.0, 30.0, 10.0, None, None, 60, 12)
    h.update(1 / 60)
    h.update(0.5 / 60)
    return h


def _options_three_reads(h):
    """The frame's options before: each stat read to the host on its
    own."""
    stats = h.stats
    counts = h.get_n_particles()
    aabb_min_all = stats.aabb_min.cpu().numpy()
    aabb_max_all = stats.aabb_max.cpu().numpy()
    max_vel = stats.max_velocity.cpu().numpy()
    opts = []
    for i, cfg in ((0, h._white_config), (1, h._yolk_config)):
        aabb_min, aabb_max = aabb_min_all[i], aabb_max_all[i]
        bucket = (int(h._canvas_size) if h._canvas_size is not None
                  else R.pick_canvas_bucket(
                      aabb_min, aabb_max,
                      cfg["max_radius"] * cfg["texture_scale"],
                      float(max_vel[i]), cfg["motion_blur"], None))
        area = float(max(aabb_max[0] - aabb_min[0], 1.0)
                     * max(aabb_max[1] - aabb_min[1], 1.0))
        density = counts[i] / area if area > 1.0 else None
        opts.append(R.auto_render_options(
            cfg, bucket, use_particle_color=h._use_particle_color,
            density=density, k_boost=h._render_budget.k_boost[i],
            peak_density=h._render_budget.peak_density[i],
            post_mode=h._render_post_mode))
    return tuple(opts)


@pytest.mark.parametrize("case", ["auto_canvas", "fixed_boosted"])
def test_frame_options_read_the_stats_once(case):
    if case == "auto_canvas":
        h = _spawned(False, canvas_size=None)
    else:
        h = _spawned(False, render_post_mode="full")
        h._render_budget.k_boost = [1.5, 2.0]
        h._render_budget.peak_density = [0.05, None]
    reads = R.host_reads
    got = h._frame_options()
    assert R.host_reads == reads + 1
    assert got == _options_three_reads(h)


@pytest.mark.parametrize("sizes", [(256, 128), (512, 128), (513, 64),
                                   (96, 96), (2560, 1280)])
def test_upsampling_matrix_made_on_the_device(sizes):
    s_out, s_in = sizes
    pos = (np.arange(s_out) + 0.5) * (s_in / s_out) - 0.5
    lo = np.floor(pos).astype(np.int64)
    w = (pos - lo).astype(np.float32)
    want = np.zeros((s_out, s_in), np.float32)
    want[np.arange(s_out), np.clip(lo, 0, s_in - 1)] += 1.0 - w
    want[np.arange(s_out), np.clip(lo + 1, 0, s_in - 1)] += w
    got = R._resize_matrix(s_out, s_in, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)


def test_background_composite_as_the_colour_tensor_did():
    """Both handlers' draws composite ``background`` through one path
    (``render.draw``), with float operands: as the colour tensor copied to
    the device did, bit for bit."""
    hs = T.SpatialHandler(T.default_white_config(), T.default_yolk_config(),
                          capacity=256, max_batches=8, canvas_size=256,
                          options=T.SolverOptions(**OPTS), device="cpu")
    hs.add(120.0, 100.0, 30.0, 10.0, None, None, 60, 12)
    hs.update(1 / 60)
    bgc = (0.1, 0.2, 0.3, 0.75)
    bg = torch.tensor(bgc, dtype=torch.float32)
    for h in (_spawned(False), hs):
        frame = h.draw(viewport=VIEW)
        got = h.draw(viewport=VIEW, background=bgc)
        a = frame[..., 3:4]
        want = torch.cat([frame[..., :3] * 1.0 + bg[:3] * (1.0 - a),
                          torch.clamp(frame[..., 3:4], min=float(bg[3]))],
                         dim=-1)
        assert a.max() > 0.5 and a.min() < bgc[3]
        assert torch.equal(got, want)


# ------------------------------------------------------- the render graphs --

def _assert_same_draw(a, b, what):
    """Handler ``b``'s last draw (graph) is ``a``'s (eager) bit for bit."""
    assert torch.equal(a._frames, b._frames), f"{what}: frame"
    assert len(a._canvases) == len(b._canvases) == 2
    for ca, cb in zip(a._canvases, b._canvases):
        assert torch.equal(ca, cb), f"{what}: canvas"
    assert torch.equal(a._render_budget.audit, b._render_budget.audit), \
        f"{what}: audit"


def test_render_key():
    h = _spawned(False)
    opts2 = h._frame_options()
    th = h._outline_thickness()
    key = RG.render_key(h.state, opts2, True, 160, 128, None, th)
    moved = h.state.replace(pos=h.state.pos + 1.0)
    assert RG.render_key(moved, opts2, True, 160, 128, None, th) == key
    boosted = (R.auto_render_options(h._white_config, 256, k_boost=4.0),
               opts2[1])
    for other in (RG.render_key(h.state, boosted, True, 160, 128, None, th),
                  RG.render_key(h.state, opts2, False, 160, 128, None, th),
                  RG.render_key(h.state, opts2, True, 160, 96, None, th),
                  RG.render_key(h.state, opts2, True, 160, 128, (64, 16), th),
                  RG.render_key(h.state, opts2, True, 160, 128, None,
                                (th[0] + 1.0, th[1])),
                  RG.render_key(_handler(False, capacity=512).state, opts2,
                                True, 160, 128, None, th)):
        assert other != key


def test_replayed_draws_match_eager_draws():
    """State, alpha, viewport origin, colour and config changes between
    draws: the graph handler renders each frame bit for bit as the eager
    one, recapturing only for a new key."""
    he, hg = _spawned(False), _spawned(True)
    steps = [
        ("first", lambda h: None, VIEW),
        ("same", lambda h: setattr(h, "_frames", None), VIEW),
        ("update", lambda h: h.update(1 / 60), VIEW),
        ("alpha", lambda h: h.update(0.25 / 60), VIEW),
        ("origin", lambda h: None, (12.5, -7.25, 160, 128)),
        ("colour", lambda h: h.set_white_color(1, 0.5, 0.7, 0.9), VIEW),
        ("config", lambda h: h.set_white_config({"highlight_strength": 0.2,
                                                 "shadow_strength": 0.3}),
         VIEW),
        ("thickness", lambda h: h.set_yolk_config({"outline_thickness": 3.0}),
         VIEW),
        ("update_again", lambda h: h.update(1 / 60), VIEW),
    ]
    captures = []
    for what, change, view in steps:
        for h in (he, hg):
            change(h)
            h.draw(viewport=view)
        _assert_same_draw(he, hg, what)
        captures.append(hg._render_graphs.captures)
    # the first audited draw raises the peak-density hint, which resizes the
    # budget once (a new key); the thickness is a key; nothing else recaptures
    assert captures[-1] <= 3 and captures[-1] == captures[-2]
    assert captures[4] == captures[3]          # a new origin: a fill


def test_what_copies_in():
    h = _spawned(True)
    h.draw(viewport=VIEW)
    g = next(iter(h._render_graphs._graphs.values()))

    def load(origin=(0.0, 0.0)):
        return g.load(h.state, h.stats, h._device_cfg2(),
                      (h.interpolation_alpha, h._thresholding_threshold,
                       h._thresholding_smoothness, origin))
    assert load() == 0                       # it holds the draw's inputs
    h.update(1 / 60)
    assert load() == 7                       # pos, last_pos, vel, radius,
    assert load() == 0                       # centroids and the alpha
    assert load((3.0, 0.0)) == 1             # one fill of the origin
    h.set_white_config({"damping": 0.5})
    assert load((3.0, 0.0)) == len(vars(h._device_cfg2()))


def test_a_held_frame_is_not_overwritten():
    h = _spawned(True)
    f1 = h.draw(viewport=VIEW)
    kept = f1.clone()
    h.draw(viewport=(40.0, 30.0, 160, 128))          # same key: a replay
    f3 = h.draw(viewport=(-25.0, 10.0, 160, 128))
    assert h._render_graphs.captures >= 1
    assert torch.equal(f1, kept) and not torch.equal(f3, f1)
    (g,) = [g for g in h._render_graphs._graphs.values()]
    frame, canvases, audit = g.result(clone=False)
    assert frame is g._out[0] and torch.equal(frame, f3)   # the static one


def test_budget_boost_builds_a_new_key_and_the_cache_is_bounded():
    h = _spawned(True)
    h.draw(viewport=VIEW)
    h._frames = None
    h.draw(viewport=VIEW)                    # the peak hint has settled
    before = h._render_graphs.captures
    h._render_budget.k_boost = [2.0, 1.0]
    h._frames = None
    h.draw(viewport=VIEW)
    assert h._render_graphs.captures == before + 1
    for w in (96, 128, 192):                 # new viewport sizes: new keys
        h.draw(viewport=(0.0, 0.0, w, 128))
    assert h._render_graphs.captures == before + 4
    assert len(h._render_graphs._graphs) == RG.RenderGraphs.MAX_GRAPHS


def _clustered(graph):
    """``tests/test_overflow.py``'s scene with 300 white particles in the
    cluster (its 400 crowd one bin past the budget's cap of 256): a dense
    cluster in a huge AABB, whose first draw overflows the density-sized
    budget and whose boosted re-render drops nothing."""
    h = _handler(graph, capacity=1024, canvas_size=1024)
    h.add(200.0, 200.0, 20.0, 8.0, None, None, 300, 20)
    h.add(5000.0, 5000.0, 8.0, 4.0, None, None, 10, 3)
    h.step_once()
    return h


def test_overflow_reads_and_recaptures_as_the_eager_draw():
    he, hg = _clustered(False), _clustered(True)
    reads = {}
    for name, h in (("eager", he), ("graph", hg)):
        R.host_reads = 0
        h.draw(viewport=(0, 0, 256, 256), check_overflow=True)
        reads[name] = R.host_reads
    _assert_same_draw(he, hg, "overflow")
    assert max(hg._render_budget.k_boost) > 1.0
    assert hg._render_budget.k_boost == he._render_budget.k_boost
    assert int(hg._render_budget.audit[:, 0].sum()) == 0
    # stats + audit, then stats + audit of the boosted re-render
    assert reads == {"eager": 4, "graph": 4}
    assert hg._render_graphs.captures == 2


def test_draw_reads_the_device_twice_with_the_audit():
    h = _spawned(True)
    h.draw(viewport=VIEW)
    for audit, want in ((True, 2), (False, 1)):
        h._frames = None
        R.host_reads = 0
        h.draw(viewport=VIEW, check_overflow=audit)
        assert R.host_reads == want


def test_bench_frames_render_through_the_graphs():
    he, hg = _spawned(False), _spawned(True)
    alphas = torch.tensor([0.25, 0.75])
    sums, audits = [], []
    for h in (he, hg):
        au = []
        fn = render_frame_fn(h, VIEW, au, alphas)
        sums.append([fn(h.state, h.stats, t) for t in range(3)])
        audits.append(au)
    assert hg._render_graphs.captures == 1
    for a, b in zip(*sums):
        assert torch.equal(a, b)
    assert not torch.equal(sums[1][0], sums[1][1])
    for a, b in zip(*audits):
        assert torch.equal(a, b)


def test_cpu_handler_renders_eagerly():
    h = _spawned(False)
    h.draw(viewport=VIEW)
    assert h._render_graphs is None and h._renderers() is None
    h._render_graphs = RG.EAGER
    assert h._renderers() is None
