"""Plane sweeps and the ordered layout of the PyTorch port against the JAX
package, on seeded G = 32, K = 4 planes (as ``tests/test_sweep_kernel.py``).

- ``bin_to_planes(rotate=False, cum=...)``, ``update_cum_field`` and
  ``_dense_add_cum``: integer and copy operations, held BIT-IDENTICAL to the
  JAX scatter branch (slots, every plane, aux columns, ``pidx_grid``).
- ``count_planes_plain`` (kernel F's plain version): integer-valued, EQUAL
  to ``dense.count_planes_jnp`` and to ``_count_pallas`` in interpret mode.
- ``sweep_planes_plain`` (kernel D's plain version) against the golden model
  ``dense.sweep_planes_jnp`` for every (cohesion, ordered budget) pair, at
  window 1 and at window 3 with the fresh-cell mask on a drifted (stale)
  layout: rtol 1e-4, atol 1e-5 (the tolerance the JAX package holds its
  own kernel to: the same math, rsqrt rounding differs by an ulp between
  XLA and PyTorch).
- ``sweep_planes_plain`` against ``_sweep_pallas`` and
  ``sweep_planes_sym_plain`` (kernel E's plain version) against
  ``_sweep_pallas_sym``, both in interpret mode, for the cases JAX keeps in
  its fast tier; and the symmetric sum against the one-sided one: rtol
  1e-4, atol 1e-5 (summation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egg_fluid_simulation_tpu.ops import dense as jdense
from egg_fluid_simulation_tpu.ops import solver as jsolver
from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
from egg_fluid_simulation_tpu_torch.ops import dense as tdense
from egg_fluid_simulation_tpu_torch.ops import solver as tsolver
from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as tsweep

G, K = 32, 4
RTOL, ATOL = 1e-4, 1e-5
# collision/cohesion compliance, overlap, cohesion factor, max_pairs, cell
# size, fresh modulus (0 = the plane's own G), occupancy cap
PARAMS = np.array([10.0, 50.0, 2.0, 2.0, 1000.0, 8.0, 0.0, 8.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(jax.block_until_ready(x))


def _scene(n=512, seed=2, crowd=40):
    """Random particles (a crowd over K in a few cells, 10% inactive) and a
    prefix whose top half passes ``max_pairs`` = 1000, so the ordered cutoff
    binds for some pairs and not for others."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 150, (n, 2)).astype(np.float32)
    pos[:crowd] = rng.uniform(60, 70, (crowd, 2))
    inv = rng.uniform(0.5, 1.5, n).astype(np.float32)
    rad = np.full(n, 4.0, np.float32)
    batch = rng.integers(0, 3, n).astype(np.int32)
    act = rng.random(n) < 0.9
    cum = np.cumsum(rng.random(n) * 8.0).astype(np.float32)
    aux = rng.normal(size=(n, 7)).astype(np.float32)
    return pos, inv, rad, batch, act, cum, aux


def _both_binnings(pos, inv, rad, batch, act, cum=None, aux=None, g=G):
    jb = jdense.bin_to_planes(
        jnp.asarray(pos), jnp.asarray(inv), jnp.asarray(rad),
        jnp.asarray(batch), jnp.asarray(act), jnp.float32(8.0), grid_dim=g,
        slots_per_cell=K, cum=None if cum is None else jnp.asarray(cum),
        aux_cols=None if aux is None else jnp.asarray(aux))
    tb = tdense.bin_to_planes(
        torch.from_numpy(pos), torch.from_numpy(inv), torch.from_numpy(rad),
        torch.from_numpy(batch), torch.from_numpy(act), torch.tensor(8.0),
        grid_dim=g, slots_per_cell=K,
        cum=None if cum is None else torch.from_numpy(cum),
        aux_cols=None if aux is None else torch.from_numpy(aux))
    return jb, tb


@pytest.fixture(scope="module")
def planes():
    """(8, G + 16, L) ordered-layout planes with the positions of occupied
    slots drifted by up to 0.4 cell after binning (a stale layout, as the
    solver's in-place passes leave it), halo refreshed."""
    pos, inv, rad, batch, act, cum, _ = _scene()
    tb = _both_binnings(pos, inv, rad, batch, act, cum)[1]
    p = tb.planes.clone()
    rng = np.random.default_rng(9)
    occ = p[tdense.FIELD_OCC] > 0
    drift = torch.from_numpy(rng.uniform(-3.2, 3.2, (2,) + occ.shape)
                             .astype(np.float32))
    p[:2] = torch.where(occ, p[:2] + drift, p[:2])
    return tdense.refresh_halo_xy(p)


@pytest.mark.parametrize("with_aux", [False, True], ids=["planes", "aux"])
@pytest.mark.parametrize("g,seed", [(32, 0), (64, 1)])
def test_bin_to_planes_ordered_bit_identical(g, seed, with_aux):
    """The stable (cell, idx) layout with a prefix column: slots, planes,
    aux columns and pidx_grid equal the JAX scatter branch exactly."""
    pos, inv, rad, batch, act, cum, aux = _scene(n=900, seed=seed)
    jb, tb = _both_binnings(pos, inv, rad, batch, act, cum,
                            aux if with_aux else None, g=g)
    np.testing.assert_array_equal(tb.slot.numpy(), _np(jb.slot))
    np.testing.assert_array_equal(tb.planes.numpy(), _np(jb.planes))
    np.testing.assert_array_equal(tb.pidx_grid.numpy(), _np(jb.pidx_grid))
    if with_aux:
        np.testing.assert_array_equal(tb.aux.numpy(), _np(jb.aux))
    # FIELD_OCC is 0/1 in this layout, and some cells are over budget
    assert set(np.unique(tb.planes[tdense.FIELD_OCC].numpy())) == {0.0, 1.0}
    assert (tb.slot.numpy() == g * g * K).sum() > (~act).sum()


def test_update_cum_field_and_dense_add_cum_bit_identical():
    pos, inv, rad, batch, act, cum, _ = _scene()
    jb, tb = _both_binnings(pos, inv, rad, batch, act)
    fresh = np.random.default_rng(4).random(len(pos)).astype(np.float32)
    ju = jdense.update_cum_field(jb, jnp.asarray(fresh))
    tu = tdense.update_cum_field(tb, torch.from_numpy(fresh))
    np.testing.assert_array_equal(tu.planes.numpy(), _np(ju.planes))
    jc = jsolver._dense_add_cum(jb, K, use_pallas=False)
    tc = tsolver._dense_add_cum(tb, K)
    np.testing.assert_array_equal(tc.planes.numpy(), _np(jc.planes))
    assert tc.planes[tdense.FIELD_CUM].max() > 100.0


def test_count_planes_plain_matches_jnp_and_tpu_kernel(planes):
    jp = jnp.asarray(planes.numpy())
    got = tsweep.count_planes_plain(planes, K).numpy()
    np.testing.assert_array_equal(got, _np(jdense.count_planes_jnp(jp, K)))
    np.testing.assert_array_equal(got, _np(jsweep._count_pallas(
        jp, K, interpret=True)))
    assert got.max() > 4 and np.all(got == np.round(got))


def _jparams():
    return jdense.SweepParams(*[jnp.float32(v) for v in PARAMS])


@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
@pytest.mark.parametrize("cohesion,budget", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_sweep_planes_plain_matches_golden_model(planes, cohesion, budget,
                                                 window):
    ref = jdense.sweep_planes_jnp(jnp.asarray(planes.numpy()), _jparams(), K,
                                  cohesion, budget, window=window,
                                  fresh_mask=window == 3)
    got = tsweep.sweep_planes_plain(planes, torch.from_numpy(PARAMS), K,
                                    cohesion=cohesion, ordered_budget=budget,
                                    window=window, fresh_mask=window == 3)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)
    assert np.abs(got.numpy()).max() > 1.0


def test_sweep_planes_plain_matches_tpu_kernel(planes):
    jp = jnp.asarray(planes.numpy())
    ref = jsweep._sweep_pallas(jp, jnp.asarray(PARAMS), K, False, True,
                               interpret=True)
    got = tsweep.sweep_planes_plain(planes, torch.from_numpy(PARAMS), K,
                                    cohesion=False, ordered_budget=True)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


def test_sweep_planes_sym_plain_matches_tpu_kernel(planes):
    jp = jnp.asarray(planes.numpy())
    ref = jsweep._sweep_pallas_sym(jp, jnp.asarray(PARAMS), K, True, False,
                                   interpret=True)
    got = tsweep.sweep_planes_sym_plain(planes, torch.from_numpy(PARAMS), K,
                                        cohesion=True, ordered_budget=False)
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("window", [1, 3], ids=["w1", "w3_fresh"])
def test_symmetric_sweep_matches_one_sided(planes, window):
    """Each unordered pair once, both sides accumulated: the one-sided sums
    to summation-order rounding, with the ordered cutoff and cohesion."""
    kw = dict(cohesion=True, ordered_budget=True, window=window,
              fresh_mask=window == 3)
    p = torch.from_numpy(PARAMS)
    one = tsweep.sweep_planes_plain(planes, p, K, **kw)
    sym = tsweep.sweep_planes_sym_plain(planes, p, K, **kw)
    np.testing.assert_allclose(sym.numpy(), one.numpy(), rtol=RTOL, atol=ATOL)


def test_dispatch_on_cpu_takes_plain_versions(planes):
    """CPU tensors take the plain versions (no launch is counted); the wide
    flag picks window 3 + fresh mask; other devices raise."""
    p = torch.from_numpy(PARAMS)
    before = (tsweep.sweep_launches, tsweep.sweep_sym_launches,
              tsweep.count_launches)
    for symmetric, plain in ((False, tsweep.sweep_planes_plain),
                             (True, tsweep.sweep_planes_sym_plain)):
        for wide in (False, True):
            got = tsweep.sweep_planes(planes, p, K, cohesion=True,
                                      ordered_budget=False,
                                      symmetric=symmetric,
                                      wide=torch.tensor(wide))
            want = plain(planes, p, K, cohesion=True, ordered_budget=False,
                         window=3 if wide else 1, fresh_mask=wide)
            assert torch.equal(got, want)
    assert torch.equal(tsweep.count_planes(planes, K),
                       tsweep.count_planes_plain(planes, K))
    assert (tsweep.sweep_launches, tsweep.sweep_sym_launches,
            tsweep.count_launches) == before
    meta = torch.zeros(planes.shape, device="meta")
    with pytest.raises(RuntimeError):
        tsweep.sweep_planes(meta, p.to("meta"), K, cohesion=True,
                            ordered_budget=False)
    with pytest.raises(RuntimeError):
        tsweep.count_planes(meta, K)
