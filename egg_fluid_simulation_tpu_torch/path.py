"""Polyline path with (arc-length) parameterization — demo-support class.

A copy of ``egg_fluid_simulation_tpu/path.py`` (numpy only) over this
package's ``utils``, so the port imports nothing of the JAX package; the two
agree bit for bit. Capability parity with the reference's ``Path`` (``path.lua``):
``at(t)`` / ``tangent_at(t)`` / ``get_segment(t)`` (:42-68), uniform resampling
(:391-461), arc-length parameterization (:305-323), custom per-segment
fractions (``override_parameterization``, :123-155), closest-point query with a
t-range (:170-255), ``get_points`` / ``get_length`` / ``get_segment_count``.

Implementation is vectorized numpy: segments live in flat arrays and the
binary-search segment lookup (:345-382) becomes ``np.searchsorted`` over the
cumulative-fraction table, so ``at`` accepts scalars *or* arrays of t — handy
for driving many batch targets at once from a single query.
"""

from __future__ import annotations

import numpy as np

from .utils import log
from .utils.mathx import EPS

__all__ = ["Path"]


class Path:
    def __init__(self, points=None, *more):
        if points is None:
            points = [0.0, 0.0, 0.0, 0.0]
        self._use_arclength = False
        self.create_from(points, *more)

    # --------------------------------------------------------- constructors --

    def create_from(self, points, *more):
        """Build with uniform per-segment parameterization (reference :76-83)."""
        return self._create_from(False, False, points, *more)

    def create_from_and_reparameterize(self, points, *more):
        """Build with arc-length parameterization (reference :88-95)."""
        return self._create_from(False, True, points, *more)

    def create_from_and_resample(self, points, *more):
        """Resample to uniform spacing, then arc-length parameterize (reference :100-107)."""
        return self._create_from(True, True, points, *more)

    def _create_from(self, resample: bool, use_arclength: bool, points, *more):
        if isinstance(points, (int, float)):
            points = [points, *more]
        points = [float(p) for p in points]
        if len(points) < 2:
            points = [0.0, 0.0, 0.0, 0.0]
        elif len(points) < 4:
            points = points + points[:2]
        if len(points) % 2 != 0:
            log.error("In Path: number of point coordinates must be even")

        pts = np.asarray(points, np.float64).reshape(-1, 2)
        if resample:
            pts = self._resample_uniform(pts)

        self._points = pts
        self._use_arclength = use_arclength
        self._update()
        return self

    @staticmethod
    def _resample_uniform(pts: np.ndarray) -> np.ndarray:
        """Resample to equidistant points along the polyline (reference :391-461)."""
        seg = np.diff(pts, axis=0)
        seg_len = np.hypot(seg[:, 0], seg[:, 1])
        cum = np.concatenate([[0.0], np.cumsum(seg_len)])
        total = cum[-1]
        if total <= 0:
            return pts
        n = len(pts)
        targets = np.linspace(0.0, total, n)
        # interpolate x and y independently along cumulative distance
        x = np.interp(targets, cum, pts[:, 0])
        y = np.interp(targets, cum, pts[:, 1])
        out = np.stack([x, y], axis=-1)
        out[0], out[-1] = pts[0], pts[-1]
        return out

    def _update(self):
        """Rebuild segment tables (reference ``_update`` :266-340)."""
        pts = self._points
        frm, to = pts[:-1], pts[1:]
        delta = to - frm
        dist = np.hypot(delta[:, 0], delta[:, 1])
        with np.errstate(invalid="ignore", divide="ignore"):
            direction = np.where(dist[:, None] > EPS, delta / np.maximum(dist, EPS)[:, None], 0.0)

        n = len(dist)
        self._from, self._to = frm, to
        self._dir = direction
        self._dist = dist
        self._length = float(dist.sum())

        if n == 1:
            fraction = np.array([0.0])
            fraction_len = np.array([1.0])
        elif self._use_arclength and self._length > 0:
            cum = np.concatenate([[0.0], np.cumsum(dist)])
            fraction = cum[:-1] / self._length
            fraction_len = dist / self._length
        else:
            fraction = np.arange(n) / n
            fraction_len = np.full(n, 1.0 / n)
        self._fraction = fraction
        self._fraction_len = fraction_len

    # -------------------------------------------------------------- queries --

    def _segment_index(self, t):
        """Segment index containing parameter t (vectorized binary search)."""
        t = np.clip(np.asarray(t, np.float64), 0.0, 1.0)
        idx = np.searchsorted(self._fraction, t, side="right") - 1
        return np.clip(idx, 0, len(self._fraction) - 1), t

    def at(self, t):
        """Position at parameter t in [0, 1] (reference :42-54). Accepts arrays."""
        idx, t = self._segment_index(t)
        local = (t - self._fraction[idx]) / np.maximum(self._fraction_len[idx], EPS)
        d = local * self._dist[idx]
        p = self._from[idx] + self._dir[idx] * d[..., None]
        if p.ndim == 1:
            return float(p[0]), float(p[1])
        return p

    def tangent_at(self, t):
        """Normalized direction at parameter t (reference :63-68)."""
        idx, _ = self._segment_index(t)
        d = self._dir[idx]
        if d.ndim == 1:
            return float(d[0]), float(d[1])
        return d

    def get_segment(self, t):
        """Endpoints of the segment containing t (reference :57-60)."""
        idx, _ = self._segment_index(t)
        f, s = self._from[idx], self._to[idx]
        return float(f[0]), float(f[1]), float(s[0]), float(s[1])

    def get_points(self):
        """Flat [x1, y1, x2, y2, ...] list (reference :263-265)."""
        return [float(v) for v in self._points.reshape(-1)]

    def get_length(self) -> float:
        return self._length

    def get_segment_count(self) -> int:
        return len(self._dist)

    def override_parameterization(self, *fractions):
        """Replace per-segment fractions; must sum to 1 (reference :123-155)."""
        n = len(self._dist)
        if len(fractions) != n:
            log.error("In Path.override_parameterization: expected `", n,
                      "` parameters, got `", len(fractions), "`")
        fr = np.asarray(fractions, np.float64)
        if np.any(fr < 0):
            log.error("In Path.override_parameterization: parameters must be non-negative numbers")
        if abs(fr.sum() - 1.0) > 1e-10:
            log.error("In Path.override_parameterization: total length of override "
                      "parameters is `", fr.sum(), "`, but `1` was expected")
        self._fraction_len = fr
        self._fraction = np.concatenate([[0.0], np.cumsum(fr)[:-1]])

    def get_closest_point(self, x, y, min_t=None, max_t=None):
        """Closest point on the path within [min_t, max_t] (reference :170-255).

        Returns (x, y, t) or (None, None, None) if the path is empty.
        """
        if len(self._dist) == 0:
            return None, None, None
        lo = float(np.clip(0.0 if min_t is None else min_t, 0.0, 1.0))
        hi = float(np.clip(1.0 if max_t is None else max_t, 0.0, 1.0))
        if lo > hi:
            lo, hi = hi, lo

        frac, flen = self._fraction, self._fraction_len
        seg_end = frac + flen
        in_range = (seg_end >= lo) & (frac <= hi)
        if not np.any(in_range):
            in_range = np.zeros_like(in_range)
            in_range[self._segment_index(lo)[0]] = True

        q = np.array([x, y], np.float64)
        fr, to = self._from, self._to
        seg = to - fr
        seg_len2 = np.sum(seg * seg, axis=-1)

        with np.errstate(invalid="ignore", divide="ignore"):
            raw_t = np.sum((q - fr) * seg, axis=-1) / np.maximum(seg_len2, EPS)
        lo_local = np.clip((lo - frac) / np.maximum(flen, EPS), 0.0, 1.0)
        hi_local = np.clip((hi - frac) / np.maximum(flen, EPS), 0.0, 1.0)
        local_t = np.clip(raw_t, lo_local, hi_local)
        local_t = np.where(seg_len2 < EPS, 0.5 * (lo_local + hi_local), local_t)

        proj = fr + seg * local_t[:, None]
        d2 = np.sum((proj - q) ** 2, axis=-1)
        d2 = np.where(in_range, d2, np.inf)
        best = int(np.argmin(d2))
        t = float(frac[best] + flen[best] * local_t[best])
        return float(proj[best, 0]), float(proj[best, 1]), t
