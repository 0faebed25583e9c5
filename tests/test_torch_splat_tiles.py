"""Kernel G's plain version (``splat_tiles_plain``) against the JAX
package's slot-major splat ``splat_tiles`` run in interpret mode.

The same seeded numpy candidates go to both: per tile, chunks of 128
candidates with the render payload's nine fields. Cases: trips of 0, a
partial count and the full count; nonzero garbage in the chunks past a
tile's trips (it must not be read); a small ``max_splat_px`` that binds the
box test; two tile shapes. Tolerance: atol 1e-5 on alpha. Both sides take
the same products in the same order (per lane over the chunks, then a
pairwise halving over the 128 lanes); what is left is ``exp`` and the
interpret mode's rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from egg_fluid_simulation_tpu.ops.pallas import splat_kernel as jsplat
from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel

TOL = 1e-5


def candidates(n_tiles, n_chunks, th, tw, ntx, n_cand, seed, garbage=True):
    """(T, n_chunks, 9, 128) slot-major candidates around each tile: the
    first ``n_cand[t]`` slots of tile t are live, the rest zero, or noise
    when ``garbage`` (the chunks past trips hold data the kernel skips)."""
    rng = np.random.RandomState(seed)
    cand = np.zeros((n_tiles, n_chunks * 128, 9), np.float32)
    for t in range(n_tiles):
        oy, ox = (t // ntx) * th, (t % ntx) * tw
        n = n_cand[t]
        ang = rng.uniform(0, 2 * np.pi, n)
        ext = rng.uniform(1.0, 6.0, n)
        smear = rng.uniform(1.0, 2.5, n)
        cand[t, :n, 0] = ox + rng.uniform(-8.0, tw + 8.0, n)
        cand[t, :n, 1] = oy + rng.uniform(-8.0, th + 8.0, n)
        cand[t, :n, 2] = np.cos(ang)
        cand[t, :n, 3] = np.sin(ang)
        cand[t, :n, 4] = ext
        cand[t, :n, 5] = ext * smear
        cand[t, :n, 6] = 1.0 / (ext * smear)
        cand[t, :n, 7] = 1.0 / ext
        cand[t, :n, 8] = rng.uniform(0.2, 1.0, n)
    trips = -(-np.asarray(n_cand) // 128)
    cand = cand.reshape(n_tiles, n_chunks, 128, 9).transpose(0, 1, 3, 2).copy()
    if garbage:
        for t in range(n_tiles):
            tail = cand[t, trips[t]:]
            tail[...] = rng.uniform(-50.0, 50.0, tail.shape)
            tail[:, 8] = rng.uniform(0.5, 1.0, tail[:, 8].shape)
    return cand, trips.astype(np.int32)


def _both(cand, trips, th, tw, ntx, msp):
    want = jsplat.splat_tiles(jnp.asarray(cand), jnp.asarray(trips), th=th,
                              tw=tw, ntx=ntx, max_splat_px=msp,
                              interpret=True)
    got = splat_kernel.splat_tiles_plain(torch.from_numpy(cand),
                                         torch.from_numpy(trips), th, tw,
                                         ntx, msp)
    return got.numpy(), np.asarray(jax.block_until_ready(want))


@pytest.mark.parametrize("th,tw", [(8, 16), (16, 8)], ids=["8x16", "16x8"])
@pytest.mark.parametrize("case", ["trips", "garbage", "cap_binds"])
def test_splat_tiles_plain_matches_jax_interpret(case, th, tw):
    n_tiles, ntx, n_chunks = 8, 4, 3
    # per tile: no candidates (trips 0), partial chunks, the full count
    n_cand = [0, 1, 60, 128, 129, 200, 300, 384]
    msp = 2 if case == "cap_binds" else 64
    cand, trips = candidates(n_tiles, n_chunks, th, tw, ntx, n_cand, seed=3,
                             garbage=case != "trips")
    got, want = _both(cand, trips, th, tw, ntx, msp)
    assert got.shape == (n_tiles, th, tw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert np.all(got[0] == 0.0)                 # trips 0: nothing read
    assert got[1:].max() > 0.3
    if case == "cap_binds":
        # the cap trims the splats: a share of the pixels lose coverage
        wide, _ = _both(cand, trips, th, tw, ntx, 64)
        assert np.all(got <= wide + TOL)
        assert np.mean(got < wide - 1e-3) > 0.05
    if case == "garbage":
        # the tail past trips is ignored: zeroing it changes nothing
        clean = cand.copy()
        for t in range(n_tiles):
            clean[t, trips[t]:] = 0.0
        got_clean, _ = _both(clean, trips, th, tw, ntx, msp)
        np.testing.assert_array_equal(got, got_clean)


def test_splat_tiles_dispatch_takes_plain_on_cpu_and_rejects_other_devices():
    cand, trips = candidates(4, 2, 8, 16, 2, [10, 0, 130, 256], seed=5)
    c, tr = torch.from_numpy(cand), torch.from_numpy(trips)
    before = splat_kernel.tiles_launches
    got = splat_kernel.splat_tiles(c, tr, 8, 16, 2, 64)
    want = splat_kernel.splat_tiles_plain(c, tr, 8, 16, 2, 64)
    assert torch.equal(got, want)
    assert splat_kernel.tiles_launches == before   # no kernel on the CPU
    with pytest.raises(RuntimeError):
        splat_kernel.splat_tiles(c.to("meta"), tr.to("meta"), 8, 16, 2, 64)
    assert splat_kernel.tiles_launches == before
