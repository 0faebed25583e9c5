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


def _exact_test(cand, th, tw, ntx, msp):
    """(T, th * tw, n_chunks * 128) bool: the (pixel, candidate) pairs that
    pass the TPU kernel's normalised box test, in float32."""
    n_tiles = cand.shape[0]
    f = cand.permute(0, 1, 3, 2).reshape(n_tiles, -1, 9)
    pix = torch.arange(th * tw)
    tiles = torch.arange(n_tiles)
    px = ((pix % tw).float() + 0.5)[None, :, None] \
        + ((tiles % ntx) * tw).float()[:, None, None]
    py = ((pix // tw).float() + 0.5)[None, :, None] \
        + ((tiles // ntx) * th).float()[:, None, None]
    dx = px - f[:, None, :, 0]
    dy = py - f[:, None, :, 1]
    nx = dx * (f[:, None, :, 2] * f[:, None, :, 6]) \
        + dy * (f[:, None, :, 3] * f[:, None, :, 6])
    ny = dy * (f[:, None, :, 2] * f[:, None, :, 7]) \
        - dx * (f[:, None, :, 3] * f[:, None, :, 7])
    m = torch.maximum(torch.maximum(nx.abs(), ny.abs()),
                      (1.0 / msp) * torch.maximum(dx.abs(), dy.abs()))
    return m <= 1.0


@pytest.mark.parametrize("msp", [2, 5, 64])
def test_tiles_cull_keeps_every_contributor(msp):
    """Kernel G's cull (``tiles_cull``, its arithmetic): every candidate
    that passes the exact test at some pixel of its tile is staged,
    candidates placed just inside and just outside the reach included;
    the cull drops some candidates wherever the cap binds."""
    th, tw, ntx, n_tiles = 8, 16, 4, 8
    cand, _ = candidates(n_tiles, 3, th, tw, ntx, [384] * n_tiles, seed=msp,
                         garbage=False)
    c = torch.from_numpy(cand)
    # slide the first 64 candidates of each tile to the edge of the reach:
    # msp + 1 +- a little from the pixel centres, left, right, up, down
    rng = np.random.RandomState(msp)
    for t in range(n_tiles):
        ox, oy = (t % ntx) * tw, (t // ntx) * th
        d = msp + 1.0 + rng.uniform(-0.05, 0.05, 64).astype(np.float32)
        side = np.arange(64) % 4
        x = np.where(side == 0, ox + 0.5 - d, np.where(side == 1,
                     ox + tw - 0.5 + d, ox + tw / 2))
        y = np.where(side == 2, oy + 0.5 - d, np.where(side == 3,
                     oy + th - 0.5 + d, oy + th / 2))
        c[t, 0, 0, :64] = torch.from_numpy(x.astype(np.float32))
        c[t, 0, 1, :64] = torch.from_numpy(y.astype(np.float32))
        c[t, 0, 6:8, :64] = 0.0        # no shape limit: the cap decides
    keep = splat_kernel.tiles_cull(c, th, tw, ntx, msp)
    contributes = _exact_test(c, th, tw, ntx, msp).any(dim=1)
    assert bool((keep | ~contributes).all())
    # the edge candidates straddle the reach: some kept, some dropped; past
    # them, all kept where the random placement stays within the cap
    edge = keep[:, :64]
    assert bool(edge.any()) and not bool(edge.all())
    if msp == 64:
        assert bool(keep[:, 64:].all())


@pytest.mark.parametrize("msp", [2, 64])
def test_tiles_cull_changes_nothing(msp):
    """The plain splat with the culled candidates' weights set to zero is
    the plain splat, bit for bit: a culled candidate's factor is exactly 1
    at every pixel of its tile, as kernel G's cull assumes."""
    th, tw, ntx = 8, 16, 4
    n_cand = [0, 1, 60, 128, 129, 200, 300, 384]
    cand, trips = candidates(8, 3, th, tw, ntx, n_cand, seed=7)
    c, tr = torch.from_numpy(cand), torch.from_numpy(trips)
    keep = splat_kernel.tiles_cull(c, th, tw, ntx, msp)
    culled = c.clone()
    a = culled[:, :, 8, :].reshape(8, -1)
    a[~keep] = 0.0
    culled[:, :, 8, :] = a.reshape(8, 3, 128)
    want = splat_kernel.splat_tiles_plain(c, tr, th, tw, ntx, msp)
    got = splat_kernel.splat_tiles_plain(culled, tr, th, tw, ntx, msp)
    assert torch.equal(got, want)
    assert float(want.max()) > 0.3
