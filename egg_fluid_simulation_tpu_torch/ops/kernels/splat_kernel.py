"""Kernels C and G: per-tile gaussian splat accumulation (``csrc/splat.cu``,
``csrc/splat_tiles.cu``).

Replaces ``egg_fluid_simulation_tpu/ops/pallas/splat_kernel.py``
(``splat_rows`` and ``splat_tiles_v2``: one kernel covers both). Per pixel
of the effective canvas, ``alpha = 1 - prod(1 - g_i)`` over the candidates
of the pixel's tile window, ``g_i = a_i * exp(-(4 pi / 3) r^2)`` in the
particle's velocity-rotated, extent-normalized frame, zero outside the quad
extent or past ``max_splat_px``; with ``use_rgb`` also three products of
``(1 - g_i * rgb_i)``.

The kernel reads the bin-resident payload ``(n_bins + 1, K, F)`` and the
per-bin counts directly: one thread block per evaluation tile, one pixel a
thread up to 256 pixels a tile (2 to 8 a thread above, 2048 pixels at most),
the products in registers. The block's first warp walks the window's bins
in raster order and compacts the occupied candidates whose extent box
reaches the tile (:func:`cull_counts` is the plain form of that cull; a
culled candidate's factor is exactly 1.0 at every pixel of the tile) into a
shared-memory buffer of 128 candidates, one barrier pair per buffer-full.
On the H100 it is bound by instructions and by the warps in flight: about
33 instructions per candidate and pixel under ``--fmad=false``, term for
term the plain scan's, on a canvas of only a few thousand tiles. Its
products run in raster bin order, the plain scan's in 128-candidate chunks,
so the two agree to rounding.

:func:`splat` dispatches on the payload's device: CPU tensors take
:func:`splat_plain` (the plain scan of ``ops/render.py`` in the JAX
package); CUDA tensors launch the kernel, or raise. ``launches`` counts
kernel launches.

Kernel G, :func:`splat_tiles`, replaces the slot-major splat of the same
file (``splat_tiles``): candidates pre-gathered per tile into chunks of
128, ``cand`` (T, n_chunks, 9, 128), of which only the first ``trips[t]``
chunks of tile ``t`` are read. Its box test is the TPU kernel's normalised
one (``max(|nx|, |ny|, max(|dx|, |dy|) / max_splat_px) <= 1``), not kernel
C's extent test, so the two are separate kernels. On the card it culls
each chunk at staging, as C does: a candidate farther than
``max_splat_px + 1`` pixels from the tile's pixel centres in x or y
(:func:`tiles_cull`, the plain form of that cull) has a factor of exactly
1.0 at every pixel of the tile; the survivors are compacted in candidate
order. :func:`splat_tiles_plain` is its plain version; ``tiles_launches``
counts its launches.
"""

from __future__ import annotations

import math

import torch

__all__ = ["splat", "splat_plain", "cull_counts", "extent_box", "launches", "splat_tiles",
           "splat_tiles_plain", "tiles_cull", "tiles_launches"]

launches = 0           # kernel C
tiles_launches = 0     # kernel G

_GAUSS_COEFF = 4.0 * math.pi / 3.0  # particle_texture.glsl:8
_SPLAT_CHUNK = 128                  # candidates per product step of the scan


def splat_plain(payload: torch.Tensor, counts: torch.Tensor, opts,
                use_rgb: bool):
    """Plain PyTorch splat: every tile's window candidates in chunks of 128,
    the product of each chunk folded into the running product.

    ``counts`` is not needed here (empty payload rows contribute exactly
    nothing); it is taken for the signature the kernel shares."""
    from ..render import _tile_bins
    del counts
    dev = payload.device
    s, th, tw = opts.eff_size, opts.tile_h, opts.tile_w
    nty, ntx = s // th, s // tw
    k = opts.tile_capacity
    n_f = payload.shape[-1]
    nb = _tile_bins(opts, dev)                              # (T, W) bin ids
    n_tiles, w_bins = nb.shape
    n_cand = w_bins * k
    chunk = min(_SPLAT_CHUNK, n_cand)
    n_chunks = -(-n_cand // chunk)
    cpad = n_chunks * chunk - n_cand
    msp = float(opts.max_splat_px)

    py_grid = (torch.arange(th, device=dev, dtype=torch.float32)[:, None]
               + 0.5).expand(th, tw)
    px_grid = (torch.arange(tw, device=dev, dtype=torch.float32)[None, :]
               + 0.5).expand(th, tw)
    flat_payload = payload.reshape(-1, k * n_f)
    # tiles run in groups bounding the live (TC, th, tw, chunk) intermediate
    tc = max(1, min(n_tiles, (8 << 20) // (th * tw * chunk * 4)))
    tiles_a, tiles_rgb = [], []
    for t0 in range(0, n_tiles, tc):
        ids = torch.arange(t0, min(t0 + tc, n_tiles), device=dev)
        m = ids.shape[0]
        win = flat_payload[nb[ids]].reshape(m, n_cand, n_f)
        if cpad:
            win = torch.cat([win, win.new_zeros((m, cpad, n_f))], dim=1)
        cp = win.reshape(m, n_chunks, chunk, n_f)
        tyi = (ids // ntx) * th
        txi = (ids % ntx) * tw
        px = (px_grid[None] + txi.to(torch.float32)[:, None, None])[..., None]
        py = (py_grid[None] + tyi.to(torch.float32)[:, None, None])[..., None]
        acc = torch.ones((m, th, tw), dtype=torch.float32, device=dev)
        acc_rgb = (torch.ones((m, th, tw, 3), dtype=torch.float32, device=dev)
                   if use_rgb else None)
        for c in range(n_chunks):
            xs = cp[:, c][:, None, None]                    # (m, 1, 1, C, F)
            pcx, pcy, ca, sa, bs, bs_sm, isx, isy, ap = (
                xs[..., j] for j in range(9))
            dx = px - pcx                                   # (m, th, tw, C)
            dy = py - pcy
            # rotate into the velocity frame (instanced_draw.glsl:27-35)
            d_par = dx * ca + dy * sa
            d_perp = -dx * sa + dy * ca
            nx = d_par * isx
            ny = d_perp * isy
            r2 = nx * nx + ny * ny
            # quad extent + static splat cap; empty slots have bs == 0 and
            # ap == 0, so they contribute exactly nothing
            inside = ((torch.abs(d_par) <= bs_sm) & (torch.abs(d_perp) <= bs)
                      & (torch.abs(dx) <= msp) & (torch.abs(dy) <= msp))
            g = torch.where(inside, torch.exp(-_GAUSS_COEFF * r2) * ap, 0.0)
            acc = acc * torch.prod(1.0 - g, dim=-1)         # screen blend
            if use_rgb:
                crgb = xs[..., 9:12]
                acc_rgb = acc_rgb * torch.prod(1.0 - g[..., None] * crgb,
                                               dim=-2)
        tiles_a.append(1.0 - acc)
        if use_rgb:
            tiles_rgb.append(1.0 - acc_rgb)
    alpha = (torch.cat(tiles_a).reshape(nty, ntx, th, tw)
             .permute(0, 2, 1, 3).reshape(s, s))
    rgb = None
    if use_rgb:
        rgb = (torch.cat(tiles_rgb).reshape(nty, ntx, th, tw, 3)
               .permute(0, 2, 1, 3, 4).reshape(s, s, 3))
    return alpha, rgb


def extent_box(payload: torch.Tensor, max_splat_px):
    """Half-extents ``(ex, ey)`` of a box around each candidate's centre
    that holds its whole footprint: the bounding box of the rotated quad,
    ``(|cos| e_par + |sin| e_perp) / (cos^2 + sin^2)`` and its mirror, cut by
    ``max_splat_px`` (which also stands in where the direction is zero) and
    widened by 0.1% + 0.01 px against rounding. Kernel C's cull, in its
    arithmetic; works in the payload's dtype."""
    ca, sa = payload[..., 2], payload[..., 3]
    e_perp, e_par = payload[..., 4], payload[..., 5]
    ac, as_ = torch.abs(ca), torch.abs(sa)
    n2 = ca * ca + sa * sa
    cap = torch.full_like(n2, float(max_splat_px))
    ex = torch.fmin((ac * e_par + as_ * e_perp) / n2 * 1.001, cap) + 0.01
    ey = torch.fmin((as_ * e_par + ac * e_perp) / n2 * 1.001, cap) + 0.01
    return ex, ey


def cull_counts(payload: torch.Tensor, counts: torch.Tensor, opts):
    """``(in_window, staged)``, each ``(n_tiles,)`` int64: per evaluation
    tile the occupied candidates of its window of bins, and those of them
    whose :func:`extent_box` reaches the rectangle of the tile's pixel
    centres: the candidates kernel C stages. The rest have ``g = 0`` at
    every pixel of the tile."""
    from ..render import _tile_bins
    dev = payload.device
    s, th, tw = opts.eff_size, opts.tile_h, opts.tile_w
    k = opts.tile_capacity
    ntx = s // tw
    nb = _tile_bins(opts, dev)                              # (T, W) bin ids
    filled = torch.clamp(counts.to(device=dev, dtype=torch.int64), max=k)
    occupied = torch.arange(k, device=dev)[None, :] < filled[:, None]
    ex, ey = extent_box(payload, opts.max_splat_px)
    tiles = torch.arange(nb.shape[0], device=dev)
    x_lo = ((tiles % ntx) * tw).to(payload.dtype)[:, None, None] + 0.5
    y_lo = ((tiles // ntx) * th).to(payload.dtype)[:, None, None] + 0.5
    pcx, pcy = payload[..., 0][nb], payload[..., 1][nb]     # (T, W, K)
    reach = ((pcx >= x_lo - ex[nb]) & (pcx <= x_lo + (tw - 1) + ex[nb])
             & (pcy >= y_lo - ey[nb]) & (pcy <= y_lo + (th - 1) + ey[nb]))
    occ = occupied[nb]
    return occ.sum(dim=(1, 2)), (occ & reach).sum(dim=(1, 2))


def splat(payload: torch.Tensor, counts: torch.Tensor, opts, use_rgb: bool):
    """(s, s) splat alpha and, with ``use_rgb``, (s, s, 3) rgb (else None)
    from the bin-resident payload ``(n_bins + 1, K, F)`` and the per-bin
    counts ``(n_bins + 1,)``."""
    dev = payload.device
    if dev.type == "cpu":
        return splat_plain(payload, counts, opts, use_rgb)
    if dev.type != "cuda":
        raise RuntimeError(f"splat: no kernel for device {dev}")
    from ..render import _ring_depth
    from . import library
    s, th, tw = opts.eff_size, opts.tile_h, opts.tile_w
    bh, bw, k = opts.bin_h, opts.bin_w, opts.tile_capacity
    ry, rx = _ring_depth(opts)
    nby, nbx = s // bh + 2 * ry, s // bw + 2 * rx
    n_f = payload.shape[-1]
    if (payload.shape != (nby * nbx + 1, k, n_f) or payload.dtype != torch.float32
            or n_f < (12 if use_rgb else 9)
            or counts.shape != (nby * nbx + 1,) or counts.device != dev):
        raise ValueError("splat: float32 payload (n_bins+1, K, F) and counts "
                         "(n_bins+1,) of the render options' geometry expected")
    if th * tw > 2048:
        raise ValueError("splat: evaluation tiles above 2048 pixels unsupported")
    payload = payload.contiguous()
    counts32 = counts.to(torch.int32).contiguous()
    alpha = torch.empty((s, s), dtype=torch.float32, device=dev)
    rgb = (torch.empty((s, s, 3), dtype=torch.float32, device=dev)
           if use_rgb else None)
    wy, wx = th // bh + 2 * ry, tw // bw + 2 * rx
    lib = library.load()
    err = lib.egg_splat(payload.data_ptr(), counts32.data_ptr(),
                        alpha.data_ptr(), library.ptr(rgb), s, th, tw, bh, bw,
                        nbx, wy, wx, k, n_f, int(opts.max_splat_px),
                        int(use_rgb), library.stream_handle(dev))
    library.check("splat", err)
    global launches
    launches += 1
    return alpha, rgb


# ------------------------------------------------ kernel G: slot-major tiles --

_TILES_FIELDS = 9      # x, y, cos, sin, extent_perp, extent_par, inv_sx,
                       # inv_sy, a (ops/render.py's payload columns)


def tiles_cull(cand: torch.Tensor, th: int, tw: int, ntx: int,
               max_splat_px: int) -> torch.Tensor:
    """(T, n_chunks * 128) bool: the slot-major candidates ``cand`` (T,
    n_chunks, 9, 128) that kernel G stages for their tile, in its float32
    arithmetic: the candidate's position within ``max_splat_px + 1`` pixels
    of the tile's pixel centres in x and in y. The others fail the exact
    box test at every pixel of the tile (``max(|dx|, |dy|) / max_splat_px
    > 1``), so their factor is exactly 1."""
    n_tiles = cand.shape[0]
    dev = cand.device
    cx = cand[:, :, 0, :].reshape(n_tiles, -1)
    cy = cand[:, :, 1, :].reshape(n_tiles, -1)
    tiles = torch.arange(n_tiles, device=dev)
    x0 = ((tiles % ntx) * tw).to(torch.float32)[:, None]
    y0 = ((tiles // ntx) * th).to(torch.float32)[:, None]
    reach = float(max_splat_px) + 1.0
    ox = torch.clamp(torch.maximum((0.5 + x0) - cx, cx - ((tw - 0.5) + x0)),
                     min=0.0)
    oy = torch.clamp(torch.maximum((0.5 + y0) - cy, cy - ((th - 0.5) + y0)),
                     min=0.0)
    return (ox <= reach) & (oy <= reach)


def splat_tiles_plain(cand: torch.Tensor, trips: torch.Tensor, th: int,
                      tw: int, ntx: int, max_splat_px: int) -> torch.Tensor:
    """Plain PyTorch slot-major splat, in the TPU kernel's order: per tile,
    a running product per candidate lane over the chunks ``c < trips[t]``,
    then one product over the 128 lanes by pairwise halving."""
    n_tiles, n_chunks, n_f, chunk = cand.shape
    dev = cand.device
    icap = 1.0 / float(max_splat_px)
    trips = trips.to(device=dev, dtype=torch.int64)
    py_g = torch.arange(th, device=dev, dtype=torch.float32)[:, None, None] + 0.5
    px_g = torch.arange(tw, device=dev, dtype=torch.float32)[None, :, None] + 0.5
    out = torch.empty((n_tiles, th, tw), dtype=torch.float32, device=dev)
    # tiles in groups bounding the (TC, th, tw, 128) intermediates
    tc = max(1, min(n_tiles, (8 << 20) // (th * tw * chunk * 4)))
    for t0 in range(0, n_tiles, tc):
        ids = torch.arange(t0, min(t0 + tc, n_tiles), device=dev)
        px = px_g + ((ids % ntx) * tw).to(torch.float32)[:, None, None, None]
        py = py_g + ((ids // ntx) * th).to(torch.float32)[:, None, None, None]
        acc = torch.ones((ids.shape[0], th, tw, chunk), dtype=torch.float32,
                         device=dev)
        n_run = int(trips[t0:t0 + tc].max()) if ids.shape[0] else 0
        for c in range(min(n_run, n_chunks)):
            f = cand[t0:t0 + tc, c][:, None, None]            # (m, 1, 1, F, C)
            pcx, pcy, ca, sa = f[..., 0, :], f[..., 1, :], f[..., 2, :], f[..., 3, :]
            isx, isy, ap = f[..., 6, :], f[..., 7, :], f[..., 8, :]
            cax, sax = ca * isx, sa * isx
            cay, say = ca * isy, sa * isy
            dx = px - pcx                                     # (m, th, tw, C)
            dy = py - pcy
            nx = dx * cax + dy * sax
            ny = dy * cay - dx * say
            r2 = nx * nx + ny * ny
            m = torch.maximum(torch.maximum(torch.abs(nx), torch.abs(ny)),
                              icap * torch.maximum(torch.abs(dx),
                                                   torch.abs(dy)))
            g = torch.where(m <= 1.0, torch.exp(-_GAUSS_COEFF * r2) * ap, 0.0)
            live = (c < trips[t0:t0 + tc])[:, None, None, None]
            acc = torch.where(live, acc * (1.0 - g), acc)     # screen blend
        w = chunk
        while w > 1:
            w //= 2
            acc = acc[..., :w] * acc[..., w:2 * w]
        out[t0:t0 + tc] = 1.0 - acc[..., 0]
    return out


def splat_tiles(cand: torch.Tensor, trips: torch.Tensor, th: int, tw: int,
                ntx: int, max_splat_px: int) -> torch.Tensor:
    """(n_tiles, th, tw) splat alpha per evaluation tile from slot-major
    candidates ``cand`` (n_tiles, n_chunks, 9, 128) float32 and the chunk
    counts ``trips`` (n_tiles,) int32; tile ``t``'s origin is
    ``((t // ntx) * th, (t % ntx) * tw)`` effective canvas pixels."""
    dev = cand.device
    if dev.type == "cpu":
        return splat_tiles_plain(cand, trips, th, tw, ntx, max_splat_px)
    if dev.type != "cuda":
        raise RuntimeError(f"splat_tiles: no kernel for device {dev}")
    from . import library
    if (cand.dim() != 4 or cand.shape[2] != _TILES_FIELDS
            or cand.shape[3] != _SPLAT_CHUNK or cand.dtype != torch.float32
            or trips.shape != (cand.shape[0],) or trips.device != dev):
        raise ValueError("splat_tiles: float32 cand (T, n_chunks, 9, 128) "
                         "and trips (T,) on one device expected")
    if not 0 < th * tw <= 1024:
        raise ValueError("splat_tiles: tiles of 1 to 1024 pixels supported")
    n_tiles, n_chunks = cand.shape[0], cand.shape[1]
    cand = cand.contiguous()
    trips32 = trips.to(torch.int32).contiguous()
    out = torch.empty((n_tiles, th, tw), dtype=torch.float32, device=dev)
    lib = library.load()
    err = lib.egg_splat_tiles(cand.data_ptr(), trips32.data_ptr(),
                              out.data_ptr(), n_tiles, n_chunks, th, tw, ntx,
                              int(max_splat_px), library.stream_handle(dev))
    library.check("splat_tiles", err)
    global tiles_launches
    tiles_launches += 1
    return out
