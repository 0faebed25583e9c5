# Frozen copy of egg_fluid_simulation_tpu_torch/ops/kernels/sweep_kernel.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
# every wrapper runs its plain version on every device (the kernel routes are cut).
"""The dense engine's fused collision pass: kernel B's plain version
(``csrc/substep_pass.cu`` in the port; kernels D, E and F of the
plane-resident step are left out of this copy).

Kernel B, one fused collision pass in component layout, replaces
``egg_fluid_simulation_tpu/ops/pallas/sweep_kernel.py``
(``_substep_pass_pallas``; pair math ``_pair_terms(occ_is_boost=True)``,
prologue ``_follow_prologue``). With ``integrate`` a pass first applies
damped integration ``x += damp * (x - prev)`` and the XPBD follow correction
toward (TX, TY) outside the dead zone TD; then it sums the pair corrections
over the 3x3-cell neighbourhood (window 1) or 7x7 (window 3 with the
fresh-cell mask): collision, plus same-batch cohesion with one shared
divide, scaled by the slot's inverse mass times the partner cell's boost. It
returns ``x + relax * sum`` and, with ``integrate``, ``prev`` = the position
before integration. Empty slots give 0. The grid is a torus in rows and
lanes. ``wide`` (a 0-dim tensor) selects window 3 + fresh mask when true,
window 1 when false. ``launches`` counts the calls.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.mathx import EPS
from .. import dense as D

__all__ = ["substep_pass", "substep_pass_plain", "launches"]

launches = 0             # kernel B


def _follow_prologue(xi, yi, W, OC, TX, TY, TD, follow_c):
    """XPBD follow correction, the math of solver._follow_delta."""
    dx = TX - xi
    dy = TY - yi
    dist = torch.sqrt(dx * dx + dy * dy)
    inv_dist = torch.where(dist > EPS, 1.0 / torch.clamp(dist, min=EPS), 0.0)
    violation = dist - TD
    delta_lambda = violation / (W + follow_c)
    apply = (OC > 0.0) & (W > EPS) & (dist > TD)
    scale = torch.where(apply, delta_lambda * W * inv_dist, 0.0)
    return xi + dx * scale, yi + dy * scale


def substep_pass_plain(xy, stat, params, aux, k: int, *, cohesion: bool,
                       window: int = 1, fresh_mask: bool = False,
                       prev=None, follow=None, integrate: bool = False):
    """Plain PyTorch pass, one (d, dy) partner offset at a time, in the
    order of the TPU kernel's ``_pair_terms`` (d outer, dy inner), so the
    sums round as the kernel's do. The pair sums are taken at the occupied
    slots only (:func:`_occupied_sums`); an empty slot's terms are exact
    zeros, so the result is bit for bit that of the whole grid."""
    _, g, lanes = xy.shape
    X, Y = xy[0], xy[1]
    W, R, BA, OC = stat[0], stat[1], stat[2], stat[3]
    damp, follow_c, relax = aux[0], aux[1], aux[2]
    if integrate:
        xi = X + damp * (X - prev[0])
        yi = Y + damp * (Y - prev[1])
        xf, yf = _follow_prologue(xi, yi, W, OC, follow[0], follow[1],
                                  follow[2], follow_c)
    else:
        xf, yf = X, Y
    (collision_c, cohesion_c, overlap_f, cohesion_f, _max_pairs, cell_size,
     fresh_mod, _occ_cap) = params.unbind(0)

    fields = [xf, yf, W, R, OC]
    if cohesion:
        fields.append(BA)
    fm = None
    if fresh_mask:
        fm = torch.where(fresh_mod > 0, fresh_mod,
                         torch.tensor(float(g), device=xy.device))
        fields += [torch.remainder(torch.floor(xf / cell_size), fm),
                   torch.remainder(torch.floor(yf / cell_size), fm)]
    consts = (collision_c, cohesion_c, overlap_f, cohesion_f, fm)
    tx, ty = _occupied_sums(fields, k, window, cohesion, consts)
    out = torch.stack([xf + relax * tx, yf + relax * ty])
    if integrate:
        return out, torch.stack([X, Y])
    return out


def _offsets(k: int, w: int):
    """The kernel's partner offsets in its order: lane offset ``d`` outer,
    row offset ``dy`` inner, the slot itself left out."""
    d_hi = (w + 1) * k
    return [(d, dy) for d in range(-(d_hi - 1), d_hi)
            for dy in range(-w, w + 1) if dy or d]


def _pair_term(f, o, lane_ok, d: int, dy: int, cohesion: bool, consts):
    """One partner's correction of each self slot, ``(ux * s, uy * s)``:
    self fields ``f`` and partner fields ``o`` in ``substep_pass_plain``'s
    order, ``lane_ok`` the slots whose partner cell lies in the window."""
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
                         torch.rsqrt(torch.clamp(dist2, min=EPS * EPS)))
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
    sgn = 1.0 if (dy > 0 or (dy == 0 and d > 0)) else -1.0
    ux = torch.where(deg, sgn * D.TIE_X, ddx)
    uy = torch.where(deg, sgn * D.TIE_Y, ddy)
    return ux * s_eff, uy * s_eff


def _lane_ok(lane, k: int, d: int, w: int):
    return torch.abs(-torch.div(lane % k - d, k, rounding_mode="floor")) <= w


def _occupied_sums(fields, k: int, w: int, cohesion: bool, consts):
    """The (G, L) pair sums, taken at the occupied slots only (the partner
    of slot (r, l) at offset (d, dy) is slot ((r + dy) mod G, (l - d) mod
    L), gathered); every other slot's sums are zero, as the whole grid
    gives them."""
    g, lanes = fields[0].shape
    flat = torch.stack(fields).reshape(len(fields), -1)
    idx = torch.nonzero(fields[4].reshape(-1) > 0.0).squeeze(1)
    row, lane = idx // lanes, idx % lanes
    f = list(flat[:, idx])
    tx = torch.zeros_like(f[0])
    ty = torch.zeros_like(f[1])
    for d, dy in _offsets(k, w):
        partner = ((row + dy) % g) * lanes + (lane - d) % lanes
        ax, ay = _pair_term(f, list(flat[:, partner]),
                            _lane_ok(lane, k, d, w), d, dy, cohesion, consts)
        tx = tx - ax
        ty = ty - ay
    out = torch.zeros((2, g * lanes), dtype=flat.dtype, device=flat.device)
    out[0, idx] = tx
    out[1, idx] = ty
    return out[0].reshape(g, lanes), out[1].reshape(g, lanes)


def substep_pass(xy, stat, params, aux, k: int, *, cohesion: bool,
                 window: int = 1, fresh_mask: bool = False, prev=None,
                 follow=None, integrate: bool = False,
                 wide: Optional[torch.Tensor] = None):
    """One fused collision pass -> updated ``xy`` (and, with ``integrate``,
    the new previous-position tensor).

    ``params``: (8,) float32 ``SweepParams.pack()``; ``aux``: (4,) float32
    ``[damp, follow_compliance, relaxation, 0]``. ``wide``, when given,
    overrides ``window``/``fresh_mask``: true selects window 3 + fresh mask,
    false window 1."""
    dev = xy.device
    if wide is not None:
        window, fresh_mask = (3, True) if bool(wide) else (1, False)
    return substep_pass_plain(xy, stat, params, aux, k,
                              cohesion=cohesion, window=window,
                              fresh_mask=fresh_mask, prev=prev,
                              follow=follow, integrate=integrate)


