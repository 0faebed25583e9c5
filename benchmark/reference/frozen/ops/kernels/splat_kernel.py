# Frozen copy of egg_fluid_simulation_tpu_torch/ops/kernels/splat_kernel.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
# every wrapper runs its plain version on every device (the kernel routes are cut).
"""Kernel C: per-tile gaussian splat accumulation (``csrc/splat.cu``; the
slot-major kernel G is left out of this copy).

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
"""

from __future__ import annotations

import math

import torch

__all__ = ["splat", "splat_plain", "cull_counts", "extent_box", "launches"]

launches = 0           # kernel C

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
    return splat_plain(payload, counts, opts, use_rgb)


