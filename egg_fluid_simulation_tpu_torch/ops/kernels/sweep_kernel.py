"""Kernel B: one fused collision pass in component layout
(``csrc/substep_pass.cu``).

Replaces ``egg_fluid_simulation_tpu/ops/pallas/sweep_kernel.py``
(``_substep_pass_pallas``; pair math ``_pair_terms(occ_is_boost=True)``,
prologue ``_follow_prologue``). With ``integrate`` a pass first applies
damped integration ``x += damp * (x - prev)`` and the XPBD follow correction
toward (TX, TY) outside the dead zone TD; then it sums the pair corrections
over the 3x3-cell neighbourhood (window 1) or 7x7 (window 3 with the
fresh-cell mask): collision, plus same-batch cohesion with one shared
divide, scaled by the slot's inverse mass times the partner cell's boost. It
returns ``x + relax * sum`` and, with ``integrate``, ``prev`` = the position
before integration. Empty slots give 0. The grid is a torus in rows and
lanes.

On the H100 the kernel runs one thread per slot and is bound by the pair
arithmetic and L1/L2 traffic of the partner reads (see the source). The
violence gate can stay on the device: ``wide`` (a 0-dim tensor) selects
window 3 + fresh mask when true, window 1 when false, and the kernel reads it
itself.

:func:`substep_pass` dispatches on the tensors' device: CPU tensors take
:func:`substep_pass_plain`; CUDA tensors launch the kernel, or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.mathx import EPS
from .. import dense as D

__all__ = ["substep_pass", "substep_pass_plain", "launches"]

launches = 0


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
    """Plain PyTorch pass: the whole grid, one (d, dy) partner offset at a
    time, in the order of the TPU kernel's ``_pair_terms`` (d outer, dy
    inner), so the sums round as the kernel's do."""
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
    if fresh_mask:
        fm = torch.where(fresh_mod > 0, fresh_mod,
                         torch.tensor(float(g), device=xy.device))
        sfx = torch.remainder(torch.floor(xf / cell_size), fm)
        sfy = torch.remainder(torch.floor(yf / cell_size), fm)
        fields += [sfx, sfy]

        def torus_adj(a, b):
            half = 0.5 * fm
            dd = torch.remainder(a - b + half, fm) - half
            return torch.abs(dd) <= 1.0

    s_lane = torch.arange(lanes, device=xy.device) % k
    tx = torch.zeros_like(xf)
    ty = torch.zeros_like(yf)
    w = window
    d_hi = (w + 1) * k
    for d in range(-(d_hi - 1), d_hi):
        cell_diff = -torch.div(s_lane - d, k, rounding_mode="floor")
        mask = (torch.abs(cell_diff) <= w)[None, :]
        rolled = [torch.roll(f, d, dims=1) if d else f for f in fields]
        for dy in range(-w, w + 1):
            if dy == 0 and d == 0:
                continue
            o = [torch.roll(f, -dy, dims=0) if dy else f for f in rolled]
            ox, oy, ow, orr, oocc = o[:5]
            valid = (OC > 0.0) & (oocc > 0.0) & mask
            if fresh_mask:
                valid = valid & torus_adj(sfx, o[-2]) & torus_adj(sfy, o[-1])
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
                ob = o[5]
                coh_d = cohesion_f * sum_r
                hit_c = ok & (BA == ob) & (dist2 <= coh_d * coh_d)
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
            tx = tx - ux * s_eff
            ty = ty - uy * s_eff

    out = torch.stack([xf + relax * tx, yf + relax * ty])
    if integrate:
        return out, torch.stack([X, Y])
    return out


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
    if dev.type == "cpu":
        if wide is not None:
            window, fresh_mask = (3, True) if bool(wide) else (1, False)
        return substep_pass_plain(xy, stat, params, aux, k,
                                  cohesion=cohesion, window=window,
                                  fresh_mask=fresh_mask, prev=prev,
                                  follow=follow, integrate=integrate)
    if dev.type != "cuda":
        raise RuntimeError(f"substep_pass: no kernel for device {dev}")
    from . import library
    _, g, lanes = xy.shape
    tensors = [xy, stat, params, aux] + ([prev, follow] if integrate else [])
    if (xy.shape[0] != 2 or stat.shape != (4, g, lanes) or lanes != g * k
            or params.shape != (8,) or aux.shape != (4,)
            or (integrate and (prev.shape != xy.shape
                               or follow.shape != (3, g, lanes)))
            or any(t.dtype != torch.float32 or t.device != dev
                   for t in tensors)):
        raise ValueError("substep_pass: float32 xy (2,G,G*K), stat (4,G,G*K)"
                         ", params (8,), aux (4,) [, prev, follow] on one "
                         "device expected")
    if window not in (1, 3):
        raise ValueError("substep_pass: window must be 1 or 3")
    xy, stat, params, aux = (t.contiguous() for t in (xy, stat, params, aux))
    out_xy = torch.empty_like(xy)
    out_prev = None
    if integrate:
        prev, follow = prev.contiguous(), follow.contiguous()
        out_prev = torch.empty_like(xy)
    wide_i = None
    if wide is not None:
        wide_i = wide.to(device=dev, dtype=torch.int32).reshape(1)
    lib = library.load()
    err = lib.egg_substep_pass(
        xy.data_ptr(), stat.data_ptr(), library.ptr(prev),
        library.ptr(follow), params.data_ptr(), aux.data_ptr(),
        library.ptr(wide_i), out_xy.data_ptr(), library.ptr(out_prev),
        g, lanes, k, window, int(fresh_mask), int(cohesion), int(integrate),
        library.stream_handle(dev))
    library.check("substep_pass", err)
    global launches
    launches += 1
    if integrate:
        return out_xy, out_prev
    return out_xy
