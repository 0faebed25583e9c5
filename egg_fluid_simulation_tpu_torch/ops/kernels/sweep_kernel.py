"""The dense engine's pair sweeps: kernel B (``csrc/substep_pass.cu``),
kernels D and E (``csrc/sweep_planes.cu``) and kernel F
(``csrc/count_planes.cu``).

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
lanes.

Kernels D, E and F run on the halo-padded ``(8, G + 2*ROW_PAD, L)`` planes of
the plane-resident step and the per-pass route (``ops/dense.py``):

- D (:func:`sweep_planes`) replaces ``_sweep_pallas``: the (2, G, L) sums of
  the same pair corrections, one-sided (each slot its own half of each
  pair), with the ordered-budget cutoff ``cum_min < max_pairs`` and the
  occupancy boost ``clip(occ / K, 1, cap)`` read from ``FIELD_OCC``;
- E (``sweep_planes(symmetric=True)``) replaces ``_sweep_pallas_sym``: the
  same sums to rounding, each unordered pair evaluated once and both sides
  accumulated;
- F (:func:`count_planes`) replaces ``_count_pallas``: per occupied slot the
  count of occupied 3x3-neighbour slots with a larger particle index, the
  examined-pair count of the ordered 0.05 n^2 budget.

On the H100, B, D and E are shared-memory tiled sweeps
(``csrc/sweep_tile.cuh``): a block owns 8 rows x 128 lanes, lists the tile's
occupied slots (an empty tile ends there), stages the tile and its halo once
(wrap, B's prologue and the fresh cells once per staged slot; 34 KB for B,
45 KB for D and 51 KB for E at window 1, K = 4; 69, 85 and 82 KB at window
3) and lets its threads walk the list with partners read from shared memory.
E stages only the rows at and below the tile (its half-space), keeps two
accumulators per staged slot in shared memory for the partners' pushes
(``atomicAdd`` on shared memory) and flushes them with one global
``atomicAdd`` a component onto an output that starts zeroed (the wrapper's
``torch.zeros``). What bounds the three is the instruction count of the
partner walk and the pair arithmetic, not bytes (B 40 registers and 8 bytes
spilled, D 62 and none, E 60 and none; see the sources); E's shared-memory
float atomics are compare-and-swap loops and cost what its halved pair
arithmetic saves at window 1. F uses the same tile at window 1: it lists
the occupied slots (an empty tile writes its zeros and ends), stages one key
a slot (``FIELD_IDX`` where occupied, -inf where not; 7.4 KB with the list
at K = 4) and counts each listed slot's partners of larger key from shared
memory. The violence gate can stay on the device: ``wide`` (a 0-dim
tensor) selects window 3 + fresh mask when true, window 1 when false, and
the kernel reads it itself; a launch with ``wide`` is sized for window 3.

The dispatchers take the tensors' device: CPU tensors take the ``*_plain``
version; CUDA tensors launch the kernel, or raise. Launch counters, one per
kernel: ``launches`` (B), ``sweep_launches`` (D), ``sweep_sym_launches``
(E), ``count_launches`` (F).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...utils.mathx import EPS
from .. import dense as D

__all__ = ["substep_pass", "substep_pass_plain", "sweep_planes",
           "sweep_planes_plain", "sweep_planes_sym_plain", "count_planes",
           "count_planes_plain", "launches", "sweep_launches",
           "sweep_sym_launches", "count_launches"]

launches = 0             # kernel B
sweep_launches = 0       # kernel D
sweep_sym_launches = 0   # kernel E
count_launches = 0       # kernel F


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


# ------------------------------------------------ halo-padded plane sweeps --

def _fields_at(planes, dy: int, d: int, fields):
    """(len(fields), G, L) partner fields at row offset ``dy`` (read through
    the halo rows) and lane offset ``d`` (out[l] = in[l - d], wrapped)."""
    g = planes.shape[1] - 2 * D.ROW_PAD
    rows = planes[fields, D.ROW_PAD + dy:D.ROW_PAD + dy + g]
    return torch.roll(rows, d, dims=-1) if d else rows


_PAIR_FIELDS = [D.FIELD_X, D.FIELD_Y, D.FIELD_W, D.FIELD_R, D.FIELD_OCC,
                D.FIELD_BATCH, D.FIELD_IDX, D.FIELD_CUM]


def _sweep_setup(planes, params, k: int, fresh_mask: bool):
    """The scalars of ``params``, the self slots' fields (real rows, in
    ``_PAIR_FIELDS`` order) and, with ``fresh_mask``, the fresh torus cells
    of every plane row (2, G + 2*ROW_PAD, L)."""
    (collision_c, cohesion_c, overlap_f, cohesion_f, max_pairs, cell_size,
     fresh_mod, occ_cap) = params.unbind(0)
    lanes = planes.shape[2]
    g = planes.shape[1] - 2 * D.ROW_PAD
    fm = torch.where(fresh_mod > 0, fresh_mod,
                     torch.tensor(float(lanes // k), device=planes.device))
    c = dict(collision_c=collision_c, cohesion_c=cohesion_c,
             overlap_f=overlap_f, cohesion_f=cohesion_f, max_pairs=max_pairs,
             fm=fm, boost_hi=torch.clamp(occ_cap, min=1.0))
    self_fields = planes[_PAIR_FIELDS, D.ROW_PAD:D.ROW_PAD + g]
    fresh = None
    if fresh_mask:
        fresh = torch.remainder(torch.floor(planes[:2] / cell_size), fm)
    return c, self_fields, fresh


def _fresh_ok(valid, fresh, dy: int, d: int, fm):
    """``valid`` and the fresh-cell mask of the wide sweep: the self and
    partner slots' fresh cells are torus-adjacent in x and y."""
    g = fresh.shape[1] - 2 * D.ROW_PAD
    sfx, sfy = fresh[:, D.ROW_PAD:D.ROW_PAD + g]
    ofx, ofy = _fields_at(fresh, dy, d, [0, 1])
    return valid & _torus_adj(sfx, ofx, fm) & _torus_adj(sfy, ofy, fm)


def _torus_adj(a, b, fm):
    half = 0.5 * fm
    return torch.abs(torch.remainder(a - b + half, fm) - half) <= 1.0


def _pair_ratio(ddx, ddy, ok, sw, ow, sr, orr, sb, ob, c, cohesion: bool):
    """The trimmed XPBD projection of ``_pair_terms``: returns (deg, num /
    den), the shared-divide correction factor (0 where no constraint
    fires)."""
    dist2 = ddx * ddx + ddy * ddy
    deg = dist2 <= EPS * EPS
    inv_d1 = torch.where(deg, 1.0,
                         torch.rsqrt(torch.clamp(dist2, min=EPS * EPS)))
    nd = torch.where(deg, 0.0, 1.0)
    w_sum = sw + ow
    ok = ok & (w_sum >= EPS)
    sum_r = sr + orr
    min_d = c["overlap_f"] * sum_r
    hit_l = ok & (dist2 <= min_d * min_d)
    f_l = torch.where(hit_l, min_d * inv_d1 - nd, 0.0)
    dl = torch.clamp(w_sum + c["collision_c"], min=1.0)
    if cohesion:
        coh_d = c["cohesion_f"] * sum_r
        hit_c = ok & (sb == ob) & (dist2 <= coh_d * coh_d)
        f_c = torch.where(hit_c, coh_d * inv_d1 - nd, 0.0)
        dc = torch.clamp(w_sum + c["cohesion_c"], min=1.0)
        return deg, (f_c * dl + f_l * dc) / (dc * dl)
    return deg, f_l / dl


def sweep_planes_plain(planes, params, k: int, *, cohesion: bool,
                       ordered_budget: bool, window: int = 1,
                       fresh_mask: bool = False):
    """Plain PyTorch one-sided sweep -> (2, G, L) correction sums.

    The math and summation order of the JAX golden model
    ``dense.sweep_planes_jnp`` (dy outer, d inner), one (dy, d) partner
    offset over the whole grid at a time."""
    lanes = planes.shape[2]
    c, (sx, sy, sw, sr, socc, sb, sidx, scum), fresh = _sweep_setup(
        planes, params, k, fresh_mask)
    tx = torch.zeros_like(sx)
    ty = torch.zeros_like(sy)
    w = window
    d_hi = (w + 1) * k
    for dy in range(-w, w + 1):
        for d in range(-(d_hi - 1), d_hi):
            if dy == 0 and d == 0:
                continue
            ox, oy, ow, orr, oocc, ob, oidx, ocum = _fields_at(
                planes, dy, d, _PAIR_FIELDS)
            valid = ((socc > 0.0) & (oocc > 0.0)
                     & D.lane_mask(lanes, k, d, w, planes.device)[None, :])
            if ordered_budget:
                cum_min = torch.where(oidx < sidx, ocum, scum)
                valid = valid & (cum_min < c["max_pairs"])
            if fresh_mask:
                valid = _fresh_ok(valid, fresh, dy, d, c["fm"])
            ddx = ox - sx
            ddy = oy - sy
            deg, ratio = _pair_ratio(ddx, ddy, valid, sw, ow, sr, orr, sb, ob,
                                     c, cohesion)
            boost = torch.minimum(torch.clamp(oocc * (1.0 / k), min=1.0),
                                  c["boost_hi"])
            s_eff = ratio * (sw * boost)
            sgn = 1.0 if (dy > 0 or (dy == 0 and d > 0)) else -1.0
            ux = torch.where(deg, sgn * D.TIE_X, ddx)
            uy = torch.where(deg, sgn * D.TIE_Y, ddy)
            tx = tx - ux * s_eff
            ty = ty - uy * s_eff
    return torch.stack([tx, ty])


def sweep_planes_sym_plain(planes, params, k: int, *, cohesion: bool,
                           ordered_budget: bool, window: int = 1,
                           fresh_mask: bool = False):
    """Plain PyTorch symmetric sweep -> (2, G, L) correction sums.

    The whole-torus form of the TPU kernel's ``_pair_terms_sym``: only the
    half-space of offsets ``dy > 0``, or ``dy == 0 and d > 0``, is
    evaluated, each unordered pair once; the self side accumulates in place
    and the other side's opposite push lands at ``(row + dy, lane - d)``,
    wrapped on the torus, so no spill rows need folding. Same sums as
    :func:`sweep_planes_plain` to rounding (d outer, dy inner)."""
    lanes = planes.shape[2]
    c, (sx, sy, sw, sr, socc, sb, sidx, scum), fresh = _sweep_setup(
        planes, params, k, fresh_mask)
    boost_o = torch.minimum(torch.clamp(socc * (1.0 / k), min=1.0),
                            c["boost_hi"])
    tx = torch.zeros_like(sx)
    ty = torch.zeros_like(sy)
    oxa = torch.zeros_like(sx)
    oya = torch.zeros_like(sy)
    w = window
    d_hi = (w + 1) * k
    for d in range(-(d_hi - 1), d_hi):
        mask = D.lane_mask(lanes, k, d, w, planes.device)[None, :]
        odx = torch.zeros_like(sx)
        ody = torch.zeros_like(sy)
        for dy in range(0, w + 1):
            if dy == 0 and d <= 0:
                continue            # dy = 0 pairs are taken from the d > 0 side
            ox, oy, ow, orr, oocc, ob, oidx, ocum = _fields_at(
                planes, dy, d, _PAIR_FIELDS)
            valid = (socc > 0.0) & (oocc > 0.0) & mask
            if ordered_budget:      # cum of the lower-index side: symmetric
                cum_min = torch.where(oidx < sidx, ocum, scum)
                valid = valid & (cum_min < c["max_pairs"])
            if fresh_mask:
                valid = _fresh_ok(valid, fresh, dy, d, c["fm"])
            ddx = ox - sx
            ddy = oy - sy
            deg, ratio = _pair_ratio(ddx, ddy, valid, sw, ow, sr, orr, sb, ob,
                                     c, cohesion)
            boost_s = torch.minimum(torch.clamp(oocc * (1.0 / k), min=1.0),
                                    c["boost_hi"])
            # the half-space carries sgn = +1; the other side gets the
            # opposite push through the + below
            ux = torch.where(deg, D.TIE_X, ddx)
            uy = torch.where(deg, D.TIE_Y, ddy)
            tx = tx - ux * (ratio * (sw * boost_s))
            ty = ty - uy * (ratio * (sw * boost_s))
            vx = ux * (ratio * (ow * boost_o))
            vy = uy * (ratio * (ow * boost_o))
            odx = odx + (torch.roll(vx, dy, dims=0) if dy else vx)
            ody = ody + (torch.roll(vy, dy, dims=0) if dy else vy)
        oxa = oxa + torch.roll(odx, -d, dims=1)
        oya = oya + torch.roll(ody, -d, dims=1)
    return torch.stack([tx + oxa, ty + oya])


def count_planes_plain(planes, k: int):
    """Plain PyTorch examined-pair count -> (G, L) float32, integer-valued:
    per occupied slot, the occupied 3x3-neighbour slots with a larger
    ``FIELD_IDX`` (``dense.count_planes_jnp``)."""
    _, rows, lanes = planes.shape
    g = rows - 2 * D.ROW_PAD
    s = planes[:, D.ROW_PAD:D.ROW_PAD + g]
    sidx, socc = s[D.FIELD_IDX], s[D.FIELD_OCC]
    total = torch.zeros_like(sidx)
    for dy in (-1, 0, 1):
        for d in range(-(2 * k - 1), 2 * k):
            if dy == 0 and d == 0:
                continue
            oidx, oocc = _fields_at(planes, dy, d, [D.FIELD_IDX, D.FIELD_OCC])
            new_pair = ((socc > 0.0) & (oocc > 0.0)
                        & D.lane_mask(lanes, k, d, 1, planes.device)[None, :]
                        & (oidx > sidx))
            total = total + new_pair.to(torch.float32)
    return total


def _check_planes(name: str, planes, k: int, params=None):
    _, rows, lanes = planes.shape
    ok = (planes.shape[0] == D.N_FIELDS and planes.dtype == torch.float32
          and rows > 2 * D.ROW_PAD and lanes % k == 0
          and (params is None or (params.shape == (8,)
                                  and params.dtype == torch.float32
                                  and params.device == planes.device)))
    if not ok:
        raise ValueError(f"{name}: float32 planes (8, R + 2*ROW_PAD, L) with "
                         f"R >= 1 real rows and L a multiple of K = {k} "
                         "[and params (8,)] on one device expected")


def sweep_planes(planes, params, k: int, *, cohesion: bool,
                 ordered_budget: bool, window: int = 1,
                 fresh_mask: bool = False, symmetric: bool = False,
                 wide: Optional[torch.Tensor] = None):
    """(2, G, L) pair-correction sums of halo-padded planes.

    The planes are a torus (the single-device layout: the halo rows copy
    the opposite edge, ``L = G*K``) or a window of one (the 2D spatial
    layer's: the halo rows and lanes hold the neighbours' slots, ``L`` any
    multiple of K): rows are read through the halo rows, lanes wrap mod
    ``L``, and the fresh-cell modulus is ``params[6]`` (0: ``L / K``).
    ``params``: (8,) float32 ``SweepParams.pack()``. ``symmetric`` takes
    kernel E (each unordered pair once) instead of D. ``wide``, when given
    (a 0-dim device tensor), overrides ``window``/``fresh_mask``: true
    selects window 3 + fresh mask, false window 1."""
    dev = planes.device
    if dev.type == "cpu":
        if wide is not None:
            window, fresh_mask = (3, True) if bool(wide) else (1, False)
        plain = sweep_planes_sym_plain if symmetric else sweep_planes_plain
        return plain(planes, params, k, cohesion=cohesion,
                     ordered_budget=ordered_budget, window=window,
                     fresh_mask=fresh_mask)
    if dev.type != "cuda":
        raise RuntimeError(f"sweep_planes: no kernel for device {dev}")
    from . import library
    _check_planes("sweep_planes", planes, k, params)
    if window not in (1, 3):
        raise ValueError("sweep_planes: window must be 1 or 3")
    _, rows, lanes = planes.shape
    g = rows - 2 * D.ROW_PAD
    planes, params = planes.contiguous(), params.contiguous()
    wide_i = None
    if wide is not None:
        wide_i = wide.to(device=dev, dtype=torch.int32).reshape(1)
    lib = library.load()
    global sweep_launches, sweep_sym_launches
    if symmetric:
        out = torch.zeros((2, g, lanes), dtype=torch.float32, device=dev)
        fn, name = lib.egg_sweep_planes_sym, "sweep_planes_sym"
    else:
        out = torch.empty((2, g, lanes), dtype=torch.float32, device=dev)
        fn, name = lib.egg_sweep_planes, "sweep_planes"
    err = fn(planes.data_ptr(), params.data_ptr(), library.ptr(wide_i),
             out.data_ptr(), g, lanes, k, window, int(fresh_mask),
             int(cohesion), int(ordered_budget), library.stream_handle(dev))
    library.check(name, err)
    if symmetric:
        sweep_sym_launches += 1
    else:
        sweep_launches += 1
    return out


def count_planes(planes, k: int):
    """(G, L) float32 examined-pair counts for the ordered budget."""
    dev = planes.device
    if dev.type == "cpu":
        return count_planes_plain(planes, k)
    if dev.type != "cuda":
        raise RuntimeError(f"count_planes: no kernel for device {dev}")
    from . import library
    _check_planes("count_planes", planes, k)
    _, rows, lanes = planes.shape
    g = rows - 2 * D.ROW_PAD
    planes = planes.contiguous()
    out = torch.empty((g, lanes), dtype=torch.float32, device=dev)
    lib = library.load()
    err = lib.egg_count_planes(planes.data_ptr(), out.data_ptr(), g, lanes, k,
                               library.stream_handle(dev))
    library.check("count_planes", err)
    global count_launches
    count_launches += 1
    return out
