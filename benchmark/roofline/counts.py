"""A kernel call's least time on the card, from the call's inputs.

Frozen from ``chip_smoke.py`` (commit e9e0aedb87f3): the peaks, the
operation counts per unit of work, ``bound``, ``nbytes``, ``window_pairs``
and ``splat_inside_pairs``, the B and C counts of its ``check.substep_pass``
and ``check.splat``, and kernel H's sweep count of its
``check.gather_pairs`` (its bytes narrowed to what the sweep reads, see
``gather_sweep_seconds``). A kernel's bound is the larger
of its operations over the FP32 peak and its bytes (each input read once,
each output written once) over the HBM peak; the operations count only what
this call's data needs, so the counts are the same whichever implementation
runs the call.
"""

from __future__ import annotations

import torch

# Peaks of one H100 SXM (vendor datasheet, 700 W): HBM3 bytes/s and FP32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per unit of work, counted from the kernels' sources:
PAIR_OPS = 36        # one (self, partner) term of pair_terms.cuh's
                     # projection with its accumulation (kernels B and H)
PROLOGUE_OPS = 20    # kernel B's integrate + follow prologue, per slot
SPLAT_OPS = 28       # kernel C: one candidate at one pixel, exp as one
SPLAT_BOX_OPS = 27   # kernel C: one window candidate's extent box against
                     # its tile (splat_kernel.extent_box and the four tests)


def bound(ops: float, nbytes: float) -> float:
    """The least seconds the card could take."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def window_pairs(occ, k: int, w: int) -> float:
    """(self, partner) terms between occupied slots of cells within +-w
    rows and columns on the torus: what a sweep over the (G, G*K) slots
    ``occ`` (> 0 = occupied) evaluates on this data."""
    g = occ.shape[0]
    n = (occ > 0).reshape(g, -1, k).sum(-1).to(torch.float64)
    near = sum(torch.roll(n, (dy, dx), (0, 1))
               for dy in range(-w, w + 1) for dx in range(-w, w + 1))
    return float((n * near).sum() - n.sum())


def substep_pass_seconds(xy, stat, k: int, window: int, prev=None,
                         follow=None, out=None) -> float:
    """Kernel B's bound for one pass over ``xy`` (2, G, G*K) with slot
    stats ``stat`` (row 3 > 0 = occupied) at ``window`` (1 or 3); ``prev``
    and ``follow`` given for the integrating pass, ``out`` its outputs."""
    occupied = float((stat[3] > 0).sum())
    ops = window_pairs(stat[3], k, window) * PAIR_OPS
    if prev is not None:
        ops += occupied * PROLOGUE_OPS
    outs = out if isinstance(out, tuple) else (out,)
    return bound(ops, nbytes(xy, stat, prev, follow, *outs))


def splat_inside_pairs(payload, counts, opts, tile_bins) -> float:
    """The (candidate, pixel) pairs of the splat whose factor is not 1.0 by
    construction: occupied candidates of a tile's window at the pixels of
    the tile that pass the plain version's ``inside`` test (quad extent and
    static cap), summed over the tiles. ``tile_bins(opts, device)`` gives
    each tile's window of bins."""
    dev = payload.device
    th, tw = opts.tile_h, opts.tile_w
    ntx = opts.eff_size // tw
    msp = float(opts.max_splat_px)
    nb = tile_bins(opts, dev)                              # (T, W)
    filled = torch.clamp(counts.to(torch.int64), max=opts.tile_capacity)
    k_used = max(int(filled.max()), 1)
    occ = torch.arange(k_used, device=dev)[None, :] < filled[:, None]
    fields = payload[:, :k_used, :6]
    n_tiles, n_cand = nb.shape[0], nb.shape[1] * k_used
    pix = torch.arange(th * tw, device=dev)
    px_t = ((pix % tw).to(torch.float32) + 0.5)[None, :, None]
    py_t = ((pix // tw).to(torch.float32) + 0.5)[None, :, None]
    tc = max(1, (16 << 20) // (th * tw * n_cand))          # tiles per chunk
    total = 0.0
    for t0 in range(0, n_tiles, tc):
        ids = torch.arange(t0, min(t0 + tc, n_tiles), device=dev)
        m = ids.shape[0]
        win = fields[nb[ids]].reshape(m, 1, n_cand, 6)
        live = occ[nb[ids]].reshape(m, 1, n_cand)
        dx = px_t + ((ids % ntx) * tw).to(torch.float32)[:, None, None] \
            - win[..., 0]
        dy = py_t + ((ids // ntx) * th).to(torch.float32)[:, None, None] \
            - win[..., 1]
        ca, sa = win[..., 2], win[..., 3]
        d_par = dx * ca + dy * sa
        d_perp = -dx * sa + dy * ca
        inside = ((torch.abs(d_par) <= win[..., 5])
                  & (torch.abs(d_perp) <= win[..., 4])
                  & (torch.abs(dx) <= msp) & (torch.abs(dy) <= msp) & live)
        total += float(inside.sum())
    return total


def splat_seconds(payload, counts, opts, alpha, rgb, cull_counts,
                  tile_bins) -> float:
    """Kernel C's bound for one splat: the full term at the (candidate,
    pixel) pairs inside the candidate's quad, a box test a window
    candidate and tile; bytes: the filled payload rows read, the counts
    read and the canvases written. ``cull_counts(payload, counts, opts)``
    gives each tile's window candidates (the plain version's cull)."""
    in_window, _ = cull_counts(payload, counts, opts)
    n_window = float(in_window.to(torch.float64).sum())
    n_inside = splat_inside_pairs(payload, counts, opts, tile_bins)
    filled = torch.clamp(counts, max=opts.tile_capacity)
    moved = (float(filled[:-1].sum()) * payload.shape[-1] * 4
             + nbytes(counts, alpha, rgb))
    return bound(n_inside * SPLAT_OPS + n_window * SPLAT_BOX_OPS, moved)


def gather_sweep_seconds(pairs: float, record, rows: int, slots: int,
                         budgeted: int) -> float:
    """Kernel H's sweep bound for one pass: ``pairs`` (self, candidate)
    pairs in the true 3x3 cells, each a pair term. Bytes: the (N, 8)
    records (every particle reads its own); the ``rows`` distinct slot
    table rows of ``slots`` int32 each that the live particles' 3x3 cells
    hash to (a particle reads only those, and a warp with no live particle
    reads none); the budget's prefix at the ``budgeted`` live particles
    (0 with the budget off); 8 bytes a particle written. The smoke charged
    the whole table and prefix, which the sweep does not read."""
    return bound(pairs * PAIR_OPS,
                 nbytes(record) + (rows * slots + budgeted) * 4
                 + record.shape[0] * 8)
