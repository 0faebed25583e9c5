"""The plain versions of kernels B, D and E at ragged shapes, where the card
check ``chip_smoke.py`` (``check.sweep_shapes``) leans on them as oracles.

The inputs are ``chip_smoke.sweep_shape_case``: small (G, K) grids that a
tile of the CUDA kernels does not divide (one smaller than a tile in both
directions, one with a fractional fresh modulus), every edge slot occupied, particles drifted out of their
cells, pairs that collide across the torus seam in rows and in lanes, a few
coincident pairs (the tie direction), cell counts up to 2K in ``FIELD_OCC``
and an ordered cutoff that binds for half the slots.

- ``sweep_planes_plain`` (kernel D) against the JAX golden model
  ``dense.sweep_planes_jnp``, windows 1 and 3 (fresh mask), with and without
  the ordered cutoff: rtol 1e-4, atol 1e-5 (as ``test_torch_plane_sweep``:
  the same math in the same order, rsqrt rounding differs by an ulp between
  XLA and PyTorch).
- ``sweep_planes_sym_plain`` (kernel E) against ``sweep_planes_plain``,
  windows 1 and 3, with and without the ordered cutoff (rtol 1e-4, atol 1e-5:
  the same pair terms, each unordered pair once, summed in another order),
  and, at the shapes the TPU kernel ``_sweep_pallas_sym`` takes in interpret
  mode (its row block divides G and holds its 8 spill rows), against that
  kernel with the same tolerance.
- ``substep_pass_plain`` (kernel B) against a numpy reference written here
  from the pair formulas in float64, partner cell by partner cell on the
  torus (no lane offsets, no lane mask, no fixed summation order), with and
  without ``integrate``: 1e-4 px (float32 sums of up to ~400 terms against
  float64). With ``integrate`` the elementwise prologue is held to float64
  on its own (1e-4 px) and the pair sums start from the float32 positions it
  gave: a one-ulp difference in a position would be amplified by the stiff
  pair terms. The TPU kernel needs 32-row blocks and 128-lane multiples, so
  it cannot serve at these shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as tsweep

RTOL, ATOL = 1e-4, 1e-5
PX_TOL = 1e-4
EPS = 1e-8
TIE = (0.5403023, 0.8414710)        # ops.dense.TIE_X, TIE_Y
SHAPES = [pytest.param(g, k, fm, id=f"G{g}K{k}")
          for g, k, fm in chip_smoke.SWEEP_SHAPES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(g, k, fresh_mod=0.0):
    return chip_smoke.sweep_shape_case(g, k, seed=100 + g, fresh_mod=fresh_mod)


def test_case_has_seam_pairs_and_ties():
    """The generator gives what the checks rely on: occupied edges,
    colliding pairs across both seams, coincident pairs."""
    g, k = 20, 3
    c = _case(g, k)
    x, y = c["xy"].astype(np.float64)
    r, occ = c["stat"][1].astype(np.float64), c["stat"][3] > 0
    assert occ[0].all() and occ[-1].all() and occ[:, 0].all() and occ[:, -1].all()
    # row g-1 against row 0, same lane: within the collision distance
    reach = 2.0 * (r[-1] + r[0])
    assert (np.hypot(x[-1] - x[0], y[-1] - y[0]) <= reach).any()
    # the last cell column against the first, same row
    reach = 2.0 * (r[:, -1] + r[:, 0])
    assert (np.hypot(x[:, -1] - x[:, 0], y[:, -1] - y[:, 0]) <= reach).any()
    twins = occ[:, 1:] & occ[:, :-1] & (x[:, 1:] == x[:, :-1]) \
        & (y[:, 1:] == y[:, :-1])
    assert twins.sum() >= 3
    assert c["planes"].shape == (8, g + 16, g * k)
    np.testing.assert_array_equal(c["planes"][:, :8], c["planes"][:, g:g + 8])


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "all"])
@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
@pytest.mark.parametrize("g,k,fresh_mod", SHAPES)
def test_sweep_planes_plain_ragged_matches_golden_model(g, k, fresh_mod,
                                                        window, ordered):
    c = _case(g, k, fresh_mod)
    ref = jdense.sweep_planes_jnp(
        jnp.asarray(c["planes"]),
        jdense.SweepParams(*[jnp.float32(v) for v in c["params"]]), k, True,
        ordered, window=window, fresh_mask=window == 3)
    got = tsweep.sweep_planes_plain(
        torch.from_numpy(c["planes"]), torch.from_numpy(c["params"]), k,
        cohesion=True, ordered_budget=ordered, window=window,
        fresh_mask=window == 3)
    ref = np.asarray(jax.block_until_ready(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    # the seam rows and lanes carry corrections, not only the interior
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert float(edge.abs().max()) > 0.1


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "all"])
@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
@pytest.mark.parametrize("g,k,fresh_mod", SHAPES)
def test_sweep_planes_sym_plain_ragged_matches_one_sided(g, k, fresh_mod,
                                                         window, ordered):
    c = _case(g, k, fresh_mod)
    planes, params = torch.from_numpy(c["planes"]), torch.from_numpy(c["params"])
    kw = dict(cohesion=True, ordered_budget=ordered, window=window,
              fresh_mask=window == 3)
    one = tsweep.sweep_planes_plain(planes, params, k, **kw)
    sym = tsweep.sweep_planes_sym_plain(planes, params, k, **kw)
    np.testing.assert_allclose(sym.numpy(), one.numpy(), rtol=RTOL, atol=ATOL)
    # the partner's push crosses the seam: rows and lanes at both edges move
    for edge in (sym[:, 0], sym[:, -1], sym[:, :, 0], sym[:, :, -1]):
        assert float(edge.abs().max()) > 0.1
    assert float(sym[:, c["planes"][7, 8:8 + g] == 0].abs().max()) == 0.0


def _tpu_sym_kernel_takes(g: int) -> bool:
    """``_sweep_pallas_sym`` cuts G into row blocks of min(32, G) rows that
    must divide G and hold the 8 spill rows of the symmetric output."""
    b = min(jsweep._BLOCK_ROWS, g)
    return g % b == 0 and b >= jsweep.OUT_PAD


@pytest.mark.parametrize("ordered", [True, False], ids=["ordered", "all"])
@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
@pytest.mark.parametrize("g,k,fresh_mod", [
    p for p in SHAPES if _tpu_sym_kernel_takes(p.values[0])])
def test_sweep_planes_sym_plain_ragged_matches_tpu_kernel(g, k, fresh_mod,
                                                          window, ordered):
    c = _case(g, k, fresh_mod)
    ref = jsweep._sweep_pallas_sym(
        jnp.asarray(c["planes"]), jnp.asarray(c["params"]), k, True, ordered,
        window=window, fresh_mask=window == 3, interpret=True)
    got = tsweep.sweep_planes_sym_plain(
        torch.from_numpy(c["planes"]), torch.from_numpy(c["params"]), k,
        cohesion=True, ordered_budget=ordered, window=window,
        fresh_mask=window == 3)
    ref = np.asarray(jax.block_until_ready(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    assert float(np.abs(ref).max()) > 1.0


def _prologue_reference(c):
    """Damped integration and the XPBD follow correction in float64."""
    f64 = {n: v.astype(np.float64) for n, v in c.items()}
    X, Y = f64["xy"]
    W, OC = f64["stat"][0], f64["stat"][3]
    damp, follow_c = f64["aux"][:2]
    xi = X + damp * (X - f64["prev"][0])
    yi = Y + damp * (Y - f64["prev"][1])
    TX, TY, TD = f64["follow"]
    dx, dy = TX - xi, TY - yi
    dist = np.sqrt(dx * dx + dy * dy)
    apply = (OC > 0) & (W > EPS) & (dist > TD)
    scale = np.where(apply, (dist - TD) / (W + follow_c) * W
                     / np.maximum(dist, EPS), 0.0)
    return np.stack([xi + dx * scale, yi + dy * scale])


def _pair_reference(c, xy, k, window):
    """Kernel B's pair sums in float64 from the positions ``xy``, one partner
    cell offset and slot at a time over the whole grid:
    out = x + relax * sum of the pair terms (0 for empty slots)."""
    g = xy.shape[1]
    f64 = {n: v.astype(np.float64) for n, v in c.items()}
    X, Y = xy.astype(np.float64)
    W, R, BA, OC = f64["stat"]
    (collision_c, cohesion_c, overlap_f, cohesion_f, _, cell_size, fresh_mod,
     _) = f64["params"]
    relax = f64["aux"][2]
    fm = fresh_mod if fresh_mod > 0 else float(g)
    cells = lambda a: a.reshape(g, g, k)            # (row, cell column, slot)
    fx, fy = np.floor(X / cell_size) % fm, np.floor(Y / cell_size) % fm
    near = lambda a, b: np.abs((a - b + 0.5 * fm) % fm - 0.5 * fm) <= 1.0
    slot = np.arange(k)[None, None, :]
    tx, ty = np.zeros((g, g, k)), np.zeros((g, g, k))
    for cy in range(-window, window + 1):
        for cx in range(-window, window + 1):
            part = {n: np.roll(cells(a), (-cy, -cx), axis=(0, 1))
                    for n, a in dict(x=X, y=Y, w=W, r=R, b=BA, oc=OC, fx=fx,
                                     fy=fy).items()}
            for j in range(k):
                o = {n: a[:, :, j:j + 1] for n, a in part.items()}
                valid = (cells(OC) > 0) & (o["oc"] > 0)
                if cy == 0 and cx == 0:
                    valid = valid & (slot != j)
                if window == 3:
                    valid = valid & near(cells(fx), o["fx"]) \
                        & near(cells(fy), o["fy"])
                ddx, ddy = o["x"] - cells(X), o["y"] - cells(Y)
                dist2 = ddx * ddx + ddy * ddy
                deg = dist2 <= EPS * EPS
                inv_d = np.where(deg, 1.0, 1.0 / np.sqrt(np.maximum(dist2, EPS * EPS)))
                nd = np.where(deg, 0.0, 1.0)
                w_sum = cells(W) + o["w"]
                ok = valid & (w_sum >= EPS)
                sum_r = cells(R) + o["r"]
                min_d, coh_d = overlap_f * sum_r, cohesion_f * sum_r
                f_l = np.where(ok & (dist2 <= min_d * min_d),
                               min_d * inv_d - nd, 0.0)
                f_c = np.where(ok & (cells(BA) == o["b"])
                               & (dist2 <= coh_d * coh_d),
                               coh_d * inv_d - nd, 0.0)
                dl = np.maximum(w_sum + collision_c, 1.0)
                dc = np.maximum(w_sum + cohesion_c, 1.0)
                s_eff = (f_c / dc + f_l / dl) * (cells(W) * o["oc"])
                # the tie direction: + for partners in later rows, or in the
                # same row at a lower lane (lane offset d > 0)
                d = slot - cx * k - j
                sgn = np.where((cy > 0) | ((cy == 0) & (d > 0)), 1.0, -1.0)
                tx -= np.where(deg, sgn * TIE[0], ddx) * s_eff
                ty -= np.where(deg, sgn * TIE[1], ddy) * s_eff
    occ = OC > 0
    out = np.stack([np.where(occ, X + relax * tx.reshape(g, -1), 0.0),
                    np.where(occ, Y + relax * ty.reshape(g, -1), 0.0)])
    return out


@pytest.mark.parametrize("integrate", [True, False], ids=["integrate", "pairs"])
@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
@pytest.mark.parametrize("g,k,fresh_mod", SHAPES)
def test_substep_pass_plain_ragged_matches_cell_reference(g, k, fresh_mod,
                                                          window, integrate):
    c = _case(g, k, fresh_mod)
    t = {n: torch.from_numpy(v) for n, v in c.items()}
    kw = dict(cohesion=True, window=window, fresh_mask=window == 3,
              integrate=integrate)
    if integrate:
        kw.update(prev=t["prev"], follow=t["follow"])
    got = tsweep.substep_pass_plain(t["xy"], t["stat"], t["params"], t["aux"],
                                    k, **kw)
    if integrate:
        got, prev = got
        assert torch.equal(prev, t["xy"])       # the position before the pass
    xy = c["xy"]
    if integrate:
        # the prologue is elementwise: hold it to float64 on its own (a pass
        # with relaxation 0 returns the integrated positions), then sum the
        # pairs from the float32 positions the pass itself started from
        still = t["aux"].clone()
        still[2] = 0.0
        xy = tsweep.substep_pass_plain(t["xy"], t["stat"], t["params"], still,
                                       k, **kw)[0].numpy()
        occ = c["stat"][3] > 0
        assert float(np.abs(xy - _prologue_reference(c))[:, occ].max()) \
            <= PX_TOL
        assert float(np.abs(xy - c["xy"]).max()) > 1.0
    want = _pair_reference(c, xy, k, window)
    assert float(np.abs(got.numpy() - want).max()) <= PX_TOL
    moved = np.abs(got.numpy() - c["xy"])
    for edge in (moved[:, 0], moved[:, -1], moved[:, :, 0], moved[:, :, -1]):
        assert float(edge.max()) > 0.1
