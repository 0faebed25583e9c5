"""Kernel B's plain pair sums, every partner offset of a chunk at once.

The frozen ``sweep_kernel._occupied_sums`` takes one (d, dy) partner
offset at a time: some thirty small operations per offset, 44 offsets a
pass at window 1 and 216 at window 3, which leaves a run of the reference
bound by launches (0.75 s a step at 1.1M particles, 0.88 s at 15k, on an
H100). :func:`occupied_sums` computes the same terms for a chunk of
offsets in one broadcast, operation by operation as ``_pair_term`` does,
and subtracts them from the running sums one offset after another in the
frozen order, so every sum rounds as the frozen loop's does: bit for bit
the same result (``tests/test_bench_reference.py`` holds it so).
``install()`` puts it in the frozen module's place.
"""

from __future__ import annotations

import torch

from .frozen.ops import dense as D
from .frozen.ops.kernels import sweep_kernel
from .frozen.utils.mathx import EPS

# elements of one (offsets, slots) operand: bounds a chunk's memory
CHUNK_ELEMS = 1 << 24
# the frozen loop, kept to hold the batched sums to
LOOP = sweep_kernel._occupied_sums
# the pair term's reciprocal square root and the order the offsets' terms
# are summed in: the frozen path's, which ``control.reordered`` swaps for a
# float32 program that rounds otherwise
RSQRT = torch.rsqrt
REVERSE = False


def _pair_terms(f, o, lane_ok, sgn, cohesion: bool, consts):
    """``sweep_kernel._pair_term`` over a chunk of offsets: ``f`` the self
    fields (1, n), ``o`` the partners' (c, n), ``sgn`` (c, 1) the tie
    direction of each offset."""
    collision_c, cohesion_c, overlap_f, cohesion_f, fm = consts
    xf, yf, W, R, OC = f[:5]
    ox, oy, ow, orr, oocc = o[:5]
    valid = (OC > 0.0) & (oocc > 0.0) & lane_ok
    if fm is not None:
        half = 0.5 * fm
        for a, b in ((f[-2], o[-2]), (f[-1], o[-1])):
            dd = torch.remainder(a - b + half, fm) - half
            valid = valid & (torch.abs(dd) <= 1.0)
    ddx = ox - xf
    ddy = oy - yf
    dist2 = ddx * ddx + ddy * ddy
    deg = dist2 <= EPS * EPS
    inv_d1 = torch.where(deg, 1.0,
                         RSQRT(torch.clamp(dist2, min=EPS * EPS)))
    nd = torch.where(deg, 0.0, 1.0)
    w_sum = W + ow
    ok = valid & (w_sum >= EPS)
    sum_r = R + orr
    min_d = overlap_f * sum_r
    hit_l = ok & (dist2 <= min_d * min_d)
    f_l = torch.where(hit_l, min_d * inv_d1 - nd, 0.0)
    dl = torch.clamp(w_sum + collision_c, min=1.0)
    if cohesion:
        coh_d = cohesion_f * sum_r
        hit_c = ok & (f[5] == o[5]) & (dist2 <= coh_d * coh_d)
        f_c = torch.where(hit_c, coh_d * inv_d1 - nd, 0.0)
        dc = torch.clamp(w_sum + cohesion_c, min=1.0)
        num = f_c * dl + f_l * dc
        den = dc * dl
    else:
        num = f_l
        den = dl
    s_eff = (num / den) * (W * oocc)
    ux = torch.where(deg, sgn * D.TIE_X, ddx)
    uy = torch.where(deg, sgn * D.TIE_Y, ddy)
    return ux * s_eff, uy * s_eff


def occupied_sums(fields, k: int, w: int, cohesion: bool, consts):
    """``sweep_kernel._occupied_sums``, bit for bit."""
    g, lanes = fields[0].shape
    dev = fields[0].device
    flat = torch.stack(fields).reshape(len(fields), -1)
    idx = torch.nonzero(fields[4].reshape(-1) > 0.0).squeeze(1)
    row, lane = (idx // lanes)[None], (idx % lanes)[None]
    n = idx.numel()
    f = [x[None] for x in flat[:, idx]]
    tx = torch.zeros((n,), dtype=flat.dtype, device=dev)
    ty = torch.zeros((n,), dtype=flat.dtype, device=dev)
    offs = sweep_kernel._offsets(k, w)
    if REVERSE:
        offs = offs[::-1]
    c = max(1, CHUNK_ELEMS // max(n, 1))
    for j0 in range(0, len(offs), c):
        chunk = offs[j0:j0 + c]
        d = torch.tensor([o[0] for o in chunk], device=dev)[:, None]
        dy = torch.tensor([o[1] for o in chunk], device=dev)[:, None]
        sgn = torch.tensor([1.0 if (b > 0 or (b == 0 and a > 0)) else -1.0
                            for a, b in chunk], dtype=flat.dtype,
                           device=dev)[:, None]
        partner = ((row + dy) % g) * lanes + (lane - d) % lanes
        o = [flat[i][partner] for i in range(len(fields))]
        lane_ok = torch.abs(-torch.div(lane % k - d, k,
                                       rounding_mode="floor")) <= w
        ax, ay = _pair_terms(f, o, lane_ok, sgn, cohesion, consts)
        for j in range(len(chunk)):
            tx = tx - ax[j]
            ty = ty - ay[j]
    out = torch.zeros((2, g * lanes), dtype=flat.dtype, device=dev)
    out[0, idx] = tx
    out[1, idx] = ty
    return out[0].reshape(g, lanes), out[1].reshape(g, lanes)


def install() -> None:
    """Use :func:`occupied_sums` in the frozen plain B."""
    sweep_kernel._occupied_sums = occupied_sums
