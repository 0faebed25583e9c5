"""Render pipeline: the reference's four GLSL passes on tensors.

The counterpart of ``egg_fluid_simulation_tpu/ops/render.py``. Reference
pipeline: ``simulation_handler.lua:1992-2175`` plus the four shaders.

1. **Splat accumulation** — every particle is a gaussian-alpha quad,
   screen-blended (``1 - prod(1 - a_i)``), evaluated analytically per pixel:
   particles are binned by centre into canvas bins, and each evaluation tile
   multiplies in the candidates of its window of bins (kernel C on CUDA).
2. **Outline** — 8-direction dilation of the accumulated alpha, then a
   smoothstep edge.
3. **Lighting** — thresholded alpha, Sobel normal, Blinn-Phong specular and
   a smoothstepped lambert shadow.
4. **Composite** — per population, outline under lighting, canvas placed at
   ``centroid - canvas/2``, white before yolk, alpha blending: the post
   pass's RGBA upsampled to the canvas, shifted and pasted in one pass over
   the viewport (kernel I on CUDA, ``kernels/composite_kernel.py``).

Canvases are sized per population to the particle AABB plus the reference's
velocity padding, snapped to a static bucket and clamped at 2560.

Precision: float32 throughout. The bilinear upsample is kernel I on CUDA;
its plain version on the CPU is the JAX package's pair of interpolation
matrix products, which run in full float32 (TF32 is switched off below).

The JAX package jits :func:`_render_frame` into one program. Here it is one
CUDA graph replay on a CUDA handler (``ops/render_graph.py``), so nothing in
it reads the device or copies from the host: the paste lands at a device
offset, the bin counts have a fixed size, the outline offsets come from the
host config, and the frame's scalars are fills.

A handler's render budget has one owner, its :class:`RenderBudget`: the
boosts, the peak-density hints, the host copy of the stats and the last
audit, and the policy over them. :func:`draw`, the draw of both handlers,
takes the budget, the handler's render as a callable and plain values; it
reads the device once for the canvas-bucket stats
(:meth:`RenderBudget.read_options`) and once for the overflow audit;
``host_reads`` counts those reads, ``rerenders`` the budget's re-renders
(:meth:`RenderBudget.audit_frame`), ``rerenders_skipped`` the re-renders it
skipped because their options equal those just drawn, and ``dropped`` the
splats the audits read on the host found dropped. Each read and re-render
is a span (``utils.profiling.span``: ``egg.draw.*``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import population_config
from ..utils.mathx import EPS
from ..utils.profiling import span
from .grid import count_pairs
from .kernels import composite_kernel, splat_kernel
# the plain paste and upsampling matrix, reachable from the render as before
from .kernels.composite_kernel import _paste_src_over_frac, _resize_matrix  # noqa: F401

__all__ = ["RenderOptions", "RenderBudget", "CANVAS_BUCKETS",
           "splat_population", "outline_pass", "lighting_pass",
           "render_population", "post_population", "draw",
           "auto_render_options", "pick_canvas_bucket",
           "host_reads", "rerenders", "rerenders_skipped", "dropped"]

# Positions and canvases must never pass through reduced precision.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# static canvas sizes; last entry is the reference's hard clamp (:1953-1954)
CANVAS_BUCKETS = (256, 512, 1024, 2048, 2560)

host_reads = 0      # device-to-host reads of draw: the stats and the audit
rerenders = 0       # renders RenderBudget.audit_frame repeated
rerenders_skipped = 0   # re-renders it skipped: options equal to those drawn
dropped = 0         # splats the audits read on the host found dropped


@dataclass(frozen=True)
class RenderOptions:
    """Render configuration of one population for one draw.

    ``downsample`` evaluates the splat at ``canvas_size / downsample`` and
    bilinearly upsamples. Tile/bin dims and ``max_splat_px`` are in
    EFFECTIVE (downsampled) pixels. ``post_mode``: ``"coarse"`` runs
    outline/lighting at the effective resolution, ``"full"`` at canvas
    resolution, ``"super"`` at 2x canvas resolution with a 2x2 box filter
    (the analog of the reference's MSAA-4 canvases, :453, :1962).
    """
    canvas_size: int = 512
    tile_h: int = 32
    tile_w: int = 128
    bin_h: int = 32
    bin_w: int = 128
    max_splat_px: int = 64
    tile_capacity: int = 64
    max_outline_steps: int = 8
    shift_pad: int = 16
    downsample: int = 1
    use_particle_color: bool = False
    post_mode: str = "coarse"

    @property
    def eff_size(self) -> int:
        return self.canvas_size // self.downsample

    def __post_init__(self):
        eff = self.canvas_size // self.downsample
        if not (self.canvas_size % self.downsample == 0
                and eff % self.tile_h == 0 and eff % self.tile_w == 0
                and self.tile_h % self.bin_h == 0
                and self.tile_w % self.bin_w == 0
                and self.post_mode in ("coarse", "full", "super")):
            raise ValueError(f"inconsistent RenderOptions: {self}")


def auto_render_options(config: dict, canvas_size: int,
                        use_particle_color: bool = False,
                        density: Optional[float] = None,
                        k_boost: float = 1.0,
                        post_mode: str = "coarse",
                        peak_density: Optional[float] = None) -> RenderOptions:
    """Render parameters from a (host) population config, as the JAX
    package derives them: splat reach ``max_radius * texture_scale`` capped
    at 64 px, evaluation resolution from the reach, bins ~ the splat
    footprint, the per-bin budget from the measured (peak) density, and
    ``ceil(thickness) + 1`` outline steps."""
    splat_full = max(4, min(64, int(math.ceil(config["max_radius"]
                                              * config["texture_scale"]))))
    ds = 1
    while ds < 4 and splat_full // (2 * ds) >= 12 and canvas_size % (2 * ds) == 0:
        ds *= 2
    splat = max(4, -(-splat_full // ds))                 # effective px
    eff = canvas_size // ds

    def pow2_clamp(v, lo, hi):
        p = lo
        while p * 2 <= min(v, hi):
            p *= 2
        return p

    bin_h = pow2_clamp(max(splat // 2, 8), 8, min(32, eff))
    bin_w = pow2_clamp(max(splat // 2, 8), 8, min(32, eff))
    tile_h = min(max(bin_h, 8), eff)
    tile_w = min(2 * bin_w, eff)

    spacing = 2.0 * config["collision_overlap_factor"] * config["min_radius"] / ds
    d_eff = 1.0 / max(spacing * spacing * 0.72, 1.0)     # hex-ish packing
    slack = 3.0
    if density is not None and density > 0.0:
        d_eff = density * ds * ds
        slack = 1.75
    if peak_density is not None and peak_density > 0.0:
        d_eff = peak_density * (ds * ds)
        slack = 1.3
    k = int(math.ceil(bin_h * bin_w * d_eff * slack / 8.0)) * 8
    k = max(8, min(256, k))
    if k_boost != 1.0:
        k = min(256, int(math.ceil(k * k_boost / 8.0)) * 8)

    thickness = float(config["outline_thickness"])
    steps = int(math.ceil(thickness)) + 1                # outline.glsl:14
    if steps > 64:
        from ..utils import log
        log.warning("outline_thickness `", thickness, "` needs ", steps,
                    " dilation steps; clamping to 64 (reach preserved)")
        steps = 64
    reach = int(math.ceil(thickness)) + 2
    shift_pad = max(16, 2 * reach if post_mode == "super" else reach)

    return RenderOptions(canvas_size=canvas_size, tile_h=tile_h, tile_w=tile_w,
                         bin_h=bin_h, bin_w=bin_w, max_splat_px=splat,
                         tile_capacity=k, max_outline_steps=steps,
                         shift_pad=shift_pad, downsample=ds,
                         use_particle_color=use_particle_color,
                         post_mode=post_mode)


def pick_canvas_bucket(aabb_min, aabb_max, max_radius_ts, max_vel,
                       motion_blur, fixed: Optional[int]) -> int:
    """Canvas size for one population (reference :1944-1954)."""
    if fixed is not None:
        return int(fixed)
    pad = max_radius_ts * (1.0 + max(1.0, max_vel) * motion_blur)
    extent = float(max(aabb_max[0] - aabb_min[0], aabb_max[1] - aabb_min[1]))
    need = extent + 2.0 * pad
    for b in CANVAS_BUCKETS:
        if need <= b:
            return b
    return CANVAS_BUCKETS[-1]


def _smoothstep(e0, e1, x):
    width = e1 - e0
    width = (torch.clamp(width, min=EPS) if isinstance(width, torch.Tensor)
             else max(width, EPS))
    t = torch.clamp((x - e0) / width, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


# -------------------------------------------------------------- splat pass --

def _ring_depth(opts: RenderOptions) -> Tuple[int, int]:
    """Bin-grid ring rows/cols beyond each canvas edge: a splat centre up to
    ``max_splat_px`` outside the canvas still touches it."""
    e = opts.max_splat_px
    return -(-e // opts.bin_h), -(-e // opts.bin_w)


def _bin_particles(p_canvas, active, opts: RenderOptions, cols):
    """Bin each particle once by its centre bin (the grid extends one ring of
    ``_ring_depth`` bins beyond every canvas edge).

    Returns ``(payload, audit, counts)``: the bin-resident payload
    ``(n_bins + 1, K, F)`` of the ``cols`` (F per-particle float32 columns;
    empty slots zero; the last row holds nothing), ``audit`` = int32
    ``[n_overflow, max_count]`` (canvas-reaching particles dropped past the
    per-bin budget K, and the peak bin occupancy) and the per-bin counts
    ``(n_bins + 1,)`` int32."""
    dev = p_canvas.device
    s, bh, bw, e = opts.eff_size, opts.bin_h, opts.bin_w, opts.max_splat_px
    ry, rx = _ring_depth(opts)
    nby, nbx = s // bh + 2 * ry, s // bw + 2 * rx
    n_bins = nby * nbx

    n = p_canvas.shape[0]
    by = torch.floor(p_canvas[:, 1] / bh).to(torch.int32) + ry
    bx = torch.floor(p_canvas[:, 0] / bw).to(torch.int32) + rx
    reach_y = (p_canvas[:, 1] > -e) & (p_canvas[:, 1] < s + e)
    reach_x = (p_canvas[:, 0] > -e) & (p_canvas[:, 0] < s + e)
    by = torch.clamp(by, 0, nby - 1).to(torch.int64)
    bx = torch.clamp(bx, 0, nbx - 1).to(torch.int64)
    ok = active & reach_x & reach_y
    bucket = torch.where(ok, by * nbx + bx, n_bins)

    order = torch.sort(bucket, stable=True).indices
    pack_sorted = torch.stack(cols, dim=1)[order]            # (N, F)
    k = opts.tile_capacity
    cnt2 = count_pairs(torch.where(ok, by, nby), torch.where(ok, bx, nbx),
                       nby, nbx)
    flat_counts = cnt2.reshape(-1)
    n_sent = n - torch.sum(flat_counts)
    all_counts = torch.cat([flat_counts, n_sent.reshape(1)])
    starts = torch.cumsum(all_counts, 0) - all_counts       # (n_bins+1,)
    overflow = torch.sum(torch.clamp(all_counts[:n_bins] - k, min=0))
    maxcnt = torch.max(all_counts[:n_bins])
    ar = torch.arange(k, device=dev)
    pos_in = starts[:, None] + ar[None, :]
    valid = ar[None, :] < all_counts[:, None]
    # row n_bins backs out-of-canvas window positions and must stay empty
    valid = valid & (torch.arange(n_bins + 1, device=dev) < n_bins)[:, None]
    capped = torch.clamp(pos_in, max=max(n - 1, 0))
    payload = torch.where(valid[..., None], pack_sorted[capped], 0.0)
    audit = torch.stack([overflow, maxcnt]).to(torch.int32)
    return payload, audit, all_counts.to(torch.int32)


def _host_peak_density(pos: np.ndarray, opts: RenderOptions) -> float:
    """The peak bin occupancy of host positions ``pos`` ((n > 0, 2) world
    px) over the area of a bin of :func:`_bin_particles` at ``opts``
    (``bin_h * downsample`` by ``bin_w * downsample`` full-resolution px):
    the max over a 2x2 set of half-bin-shifted grids, because the render's
    bins are anchored to the canvas origin, which is not known here."""
    wh = opts.bin_h * opts.downsample
    ww = opts.bin_w * opts.downsample
    peak = 0
    for sy in (0.0, 0.5 * wh):
        for sx in (0.0, 0.5 * ww):
            by = np.floor((pos[:, 1] + sy) / wh).astype(np.int64)
            bx = np.floor((pos[:, 0] + sx) / ww).astype(np.int64)
            by -= by.min()
            bx -= bx.min()
            cnt = np.bincount(by * (int(bx.max()) + 1) + bx)
            peak = max(peak, int(cnt.max()))
    return float(peak) / float(wh * ww)


def _tile_bins(opts: RenderOptions, device="cpu") -> torch.Tensor:
    """(n_tiles, n_window_bins) bin ids per evaluation tile: every bin
    intersecting the tile dilated by the splat reach (ring-extended bin
    coordinates, so every window position is a real bin)."""
    s, th, tw = opts.eff_size, opts.tile_h, opts.tile_w
    bh, bw = opts.bin_h, opts.bin_w
    nty, ntx = s // th, s // tw
    ry, rx = _ring_depth(opts)
    nbx = s // bw + 2 * rx
    wy = th // bh + 2 * ry
    wx = tw // bw + 2 * rx
    tids = torch.arange(nty * ntx, device=device)
    by0 = (tids // ntx) * (th // bh)
    bx0 = (tids % ntx) * (tw // bw)
    dy = torch.arange(wy, device=device).repeat_interleave(wx)
    dx = torch.arange(wx, device=device).repeat(wy)
    return (by0[:, None] + dy[None, :]) * nbx + (bx0[:, None] + dx[None, :])


def _splat_payload(pos, last_pos, vel, radius, color, active, canvas_center,
                   interpolation_alpha, texture_scale, motion_blur,
                   opts: RenderOptions):
    """Bin-resident candidate payload ``(n_bins+1, K, F)`` + audit + counts.

    Frame interpolation (instanced_draw.glsl:40) and canvas placement:
    canvas pixel (0,0) sits at canvas_center - S/2 (reference :2090, :2060).
    All geometry is in EFFECTIVE (downsampled) canvas pixels."""
    ds = float(opts.downsample)
    p_world = last_pos + (pos - last_pos) * interpolation_alpha
    origin = canvas_center - 0.5 * opts.canvas_size
    p_canvas = (p_world - origin) / ds

    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    inv_speed = 1.0 / torch.clamp(speed, min=EPS)
    cos_a = torch.where(speed > EPS, vel[:, 0] * inv_speed, 1.0)
    sin_a = torch.where(speed > EPS, vel[:, 1] * inv_speed, 0.0)
    base_scale = radius * texture_scale / ds
    smear = 1.0 + speed * motion_blur                        # instanced_draw.glsl:25

    a_p = torch.where(active, color[:, 3], 0.0)
    inv_sx = 1.0 / torch.clamp(base_scale * smear, min=EPS)  # stretched axis
    inv_sy = 1.0 / torch.clamp(base_scale, min=EPS)
    cols = [p_canvas[:, 0], p_canvas[:, 1], cos_a, sin_a,
            base_scale, base_scale * smear, inv_sx, inv_sy, a_p]
    if opts.use_particle_color:
        cols += [color[:, 0], color[:, 1], color[:, 2]]
    return _bin_particles(p_canvas, active, opts, cols)


def splat_population(pos, last_pos, vel, radius, color, active,
                     canvas_center, interpolation_alpha,
                     texture_scale, motion_blur,
                     opts: RenderOptions):
    """Accumulated density canvas(es) for one population, at the effective
    (downsampled) resolution.

    Returns ``(alpha, rgb_or_None, audit)``: ``alpha`` is the screen-blend
    accumulated gaussian density; ``rgb`` only with
    ``opts.use_particle_color``; ``audit`` = [overflow count, peak bin
    occupancy]."""
    payload, audit, counts = _splat_payload(
        pos, last_pos, vel, radius, color, active, canvas_center,
        interpolation_alpha, texture_scale, motion_blur, opts)
    alpha, rgb = splat_kernel.splat(payload, counts, opts,
                                    use_rgb=opts.use_particle_color)
    return alpha, rgb, audit


# ------------------------------------------------------- post-process passes --

def _shift_bilinear(img, dx, dy, pad: int, padded=None):
    """Sample ``img`` at (x + dx, y + dy) with bilinear weights, zero-padded.

    ``dx``/``dy`` are host float32 offsets (numpy scalars), so the integer
    part selects slices and the fractional part rounds as float32 does on
    the device. ``padded`` lets hot loops pre-pad once."""
    if padded is None:
        padded = torch.nn.functional.pad(img, (pad, pad, pad, pad))
    fx, fy = np.floor(dx), np.floor(dy)
    ax, ay = np.float32(dx - fx), np.float32(dy - fy)
    iy, ix = int(fy), int(fx)
    h, w = img.shape
    hp, wp = padded.shape

    def tap(sy, sx):
        y0 = min(max(pad + sy, 0), hp - h)   # dynamic_slice clamps its start
        x0 = min(max(pad + sx, 0), wp - w)
        return padded[y0:y0 + h, x0:x0 + w]

    one = np.float32(1.0)
    return (tap(iy, ix) * float(one - ax) * float(one - ay)
            + tap(iy, ix + 1) * float(ax) * float(one - ay)
            + tap(iy + 1, ix) * float(one - ax) * float(ay)
            + tap(iy + 1, ix + 1) * float(ax) * float(ay))


_DIAG = float(np.sqrt(2.0) / 2.0)
_OUTLINE_DIRECTIONS = [(1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0),
                       (_DIAG, _DIAG), (-_DIAG, _DIAG),
                       (_DIAG, -_DIAG), (-_DIAG, -_DIAG)]


def outline_pass(alpha, outline_thickness, threshold, opts: RenderOptions,
                 px_scale: float = 1.0):
    """Morphological 8-direction dilation + smoothstep edge
    (simulation_handler_outline.glsl). Returns outline coverage in [0, 1].

    The sample offsets depend on the thickness only, formed in float32 on
    the host: ``outline_thickness`` is a host float (the config's), or a
    device scalar read to the host here."""
    f32 = np.float32
    thick = f32(float(outline_thickness))
    steps_f = f32(np.ceil(thick)) + f32(1.0)
    step_size = thick / (steps_f * f32(px_scale))
    pad = opts.shift_pad
    padded = torch.nn.functional.pad(alpha, (pad, pad, pad, pad))
    max_alpha = torch.zeros_like(alpha)
    for step in range(1, opts.max_outline_steps + 1):
        if not f32(step) <= steps_f:
            continue          # masked to 0, which never raises the max
        d = min(f32(step) * step_size, f32(opts.shift_pad - 1))
        for dx, dy in _OUTLINE_DIRECTIONS:
            sampled = _shift_bilinear(alpha, d * f32(dx), d * f32(dy), pad,
                                      padded=padded)
            max_alpha = torch.maximum(max_alpha, sampled)
    max_alpha = torch.clamp(max_alpha, max=1.0)

    outline_threshold = 0.5 * threshold                      # glsl:44
    coverage = _smoothstep(outline_threshold, outline_threshold + 0.035,
                           max_alpha)
    return torch.where(alpha > 0.0, coverage, 0.0)           # glsl:11 discard


_SPEC_LIGHT = np.array([1.0, -1.0, 1.0]) / np.linalg.norm([1.0, -1.0, 1.0])
_VIEW = np.array([0.0, 0.0, 1.0])
_HALF = (_SPEC_LIGHT + _VIEW) / np.linalg.norm(_SPEC_LIGHT + _VIEW)
_SHADOW_LIGHT = np.array([-0.5, 0.75, 0.0]) / np.linalg.norm([-0.5, 0.75, 0.0])
_SPECULAR_FOCUS = 48.0


def lighting_pass(alpha, rgb, cfg_color, highlight_strength, shadow_strength,
                  threshold, smoothness, use_lighting: bool,
                  use_particle_color: bool, grad_scale: float = 1.0):
    """Threshold + Sobel-normal Blinn-Phong pass (simulation_handler_lighting.glsl).

    Returns (rgb, a) as the shader outputs them:
    ``vec4(center.rgb - shadow + specular, center.a)``."""
    value = _smoothstep(threshold - smoothness, threshold + smoothness, alpha)
    if use_particle_color:
        center_rgb = rgb * cfg_color[:3]
    else:
        center_rgb = value[..., None] * cfg_color[:3]
    center_a = value * cfg_color[3]

    # 3x3 Sobel over the *raw* accumulated alpha (glsl:37-46)
    z = torch.nn.functional.pad(alpha, (1, 1, 1, 1))
    tl, tm, tr = z[:-2, :-2], z[:-2, 1:-1], z[:-2, 2:]
    ml, mr = z[1:-1, :-2], z[1:-1, 2:]
    bl, bm, br = z[2:, :-2], z[2:, 1:-1], z[2:, 2:]
    gx = (-tl + tr - 2.0 * ml + 2.0 * mr - bl + br) * grad_scale
    gy = (-tl - 2.0 * tm - tr + bl + 2.0 * bm + br) * grad_scale

    inv_len = torch.rsqrt(gx * gx + gy * gy + 1.0)
    nx, ny, nz = -gx * inv_len, -gy * inv_len, inv_len

    out_rgb = center_rgb
    if use_lighting:
        ndoth = torch.clamp(nx * float(_HALF[0]) + ny * float(_HALF[1])
                            + nz * float(_HALF[2]), min=0.0)
        specular = highlight_strength * torch.pow(ndoth, _SPECULAR_FOCUS)
        specular = torch.where(highlight_strength > 0.0, specular, 0.0)

        ndotl = (nx * float(_SHADOW_LIGHT[0]) + ny * float(_SHADOW_LIGHT[1])
                 + nz * float(_SHADOW_LIGHT[2]))
        shadow = _smoothstep(0.0, 1.0, torch.clamp(ndotl * shadow_strength,
                                                   0.0, 1.0))
        shadow = torch.where(shadow_strength > 0.0, shadow, 0.0)
        out_rgb = center_rgb - shadow[..., None] + specular[..., None]

    return out_rgb, center_a


def _src_over(dst_rgb, dst_a, src_rgb_premul, src_a):
    """Standard alpha blending, premultiplied source."""
    a = torch.clamp(src_a, 0.0, 1.0)
    out_rgb = src_rgb_premul + dst_rgb * (1.0 - a[..., None])
    out_a = a + dst_a * (1.0 - a)
    return out_rgb, out_a


def render_population(alpha, rgb, cfg, thresholding_threshold,
                      thresholding_smoothness, use_lighting: bool,
                      opts: RenderOptions, px_scale: float = 1.0,
                      outline_thickness: Optional[float] = None):
    """Outline + lighting for one population's canvas; returns straight RGBA
    (outline under lighting, :2139-2159). ``outline_thickness``: the
    config's as a host float, else ``cfg.outline_thickness`` is read."""
    out_rgb = torch.zeros(alpha.shape + (3,), dtype=torch.float32,
                          device=alpha.device)
    out_a = torch.zeros_like(alpha)

    thickness = (cfg.outline_thickness if outline_thickness is None
                 else outline_thickness)
    coverage = outline_pass(alpha, thickness, thresholding_threshold, opts,
                            px_scale=px_scale)
    coverage = torch.where(cfg.outline_thickness > 0.0, coverage, 0.0)
    o_rgb = cfg.outline_color[:3] * (coverage * cfg.outline_color[3])[..., None]
    o_a = coverage * cfg.outline_color[3]
    out_rgb, out_a = _src_over(out_rgb, out_a, o_rgb, o_a)

    l_rgb, l_a = lighting_pass(
        alpha, rgb, cfg.color, cfg.highlight_strength, cfg.shadow_strength,
        thresholding_threshold, thresholding_smoothness, use_lighting,
        opts.use_particle_color, grad_scale=1.0 / px_scale)
    out_rgb, out_a = _src_over(out_rgb, out_a,
                               l_rgb * torch.clamp(l_a, 0.0, 1.0)[..., None],
                               l_a)
    return torch.cat([out_rgb, out_a[..., None]], dim=-1)


def post_population(alpha, rgb, cfg, threshold, smoothness,
                    use_lighting: bool, opts: RenderOptions,
                    outline_thickness: Optional[float] = None):
    """The straight RGBA of one population from its splat at the effective
    resolution: outline and lighting at the resolution ``opts.post_mode``
    names, returned at the effective resolution (``"coarse"``), the
    canvas's (``"full"``) or twice the canvas's box-filtered to it
    (``"super"``); :func:`composite_kernel.composite` upsamples it to the
    canvas as it pastes it."""
    s = opts.canvas_size
    if opts.post_mode == "coarse":
        return render_population(alpha, rgb, cfg, threshold, smoothness,
                                 use_lighting, opts,
                                 px_scale=float(opts.downsample),
                                 outline_thickness=outline_thickness)
    scale = 1 if opts.post_mode == "full" else 2
    e = s * scale
    alpha_hi = composite_kernel.upsample(alpha, e)
    rgb_hi = None
    if rgb is not None and rgb.dim() == 3:
        rgb_hi = composite_kernel.upsample(rgb, e)
    rgba = render_population(alpha_hi, rgb_hi, cfg, threshold, smoothness,
                             use_lighting, opts, px_scale=1.0 / scale,
                             outline_thickness=outline_thickness)
    if scale > 1:
        rgba = rgba.reshape(s, scale, s, scale, 4).mean(dim=(1, 3))
    return rgba


# ------------------------------------------------------------ orchestration --

@torch.no_grad()
def _render_frame(state, stats, cfg2, interpolation_alpha,
                  threshold, smoothness, viewport_origin,
                  opts2: Tuple[RenderOptions, RenderOptions],
                  use_lighting: bool, vw: int, vh: int, pop_caps=None,
                  thickness: Optional[Tuple[float, float]] = None):
    """Full-frame render: both populations splatted, shaded, composited.

    ``interpolation_alpha``, ``threshold``, ``smoothness`` are 0-dim float32
    tensors and ``viewport_origin`` a (2,) float32 tensor on the state's
    device. ``thickness``: each population's outline thickness as a host
    float (the host config's); without it the outline pass reads
    ``cfg2``'s from the device. Returns ``(frame (vh, vw, 4), canvases,
    audits (2, 2))``."""
    dev = state.device
    active = state.active_mask()
    centers = (stats.last_centroid
               + (stats.centroid - stats.last_centroid) * interpolation_alpha)

    def pop_canvas(i, opts):
        cap = state.capacity if pop_caps is None else min(pop_caps[i],
                                                          state.capacity)
        cfg = population_config(cfg2, i)
        alpha, rgb, audit = splat_population(
            state.pos[i, :cap], state.last_pos[i, :cap], state.vel[i, :cap],
            state.radius[i, :cap], state.color[i, :cap], active[i, :cap],
            centers[i], interpolation_alpha,
            cfg.texture_scale, cfg.motion_blur, opts)
        rgba = post_population(alpha, rgb, cfg, threshold, smoothness,
                               use_lighting, opts,
                               None if thickness is None else thickness[i])
        return rgba, composite_kernel.upsample(alpha, opts.canvas_size), audit

    frame = torch.empty((vh, vw, 4), dtype=torch.float32, device=dev)
    canvases = []
    audits = []
    for i in (0, 1):  # white first, then yolk (:2163-2171)
        rgba, raw_alpha, audit = pop_canvas(i, opts2[i])
        canvases.append(raw_alpha)
        audits.append(audit)
        # canvas top-left in viewport pixels (reference :2132-2133); the
        # content is centred on the INTERPOLATED centroid but pasted at the
        # END-OF-STEP centroid, exactly like the reference
        corner = stats.centroid[i] - 0.5 * opts2[i].canvas_size - viewport_origin
        composite_kernel.composite(frame, rgba, opts2[i].canvas_size, corner,
                                   over_zero=i == 0)
    return frame, tuple(canvases), torch.stack(audits)


def _frame_scalars(scalars, device):
    """The render's scalars ``(alpha, threshold, smoothness, (x, y))`` as
    the tensors :func:`_render_frame` takes, on ``device``: the alpha a
    float or a 0-dim device tensor (taken as it is), the rest host floats,
    each a fill (a launch, not a copy from the host)."""
    alpha, threshold, smoothness, (x, y) = scalars
    f32 = dict(dtype=torch.float32, device=device)
    if not isinstance(alpha, torch.Tensor):
        alpha = torch.full((), float(alpha), **f32)
    origin = torch.full((2,), float(x), **f32)
    origin[1].fill_(float(y))
    return (alpha, torch.full((), float(threshold), **f32),
            torch.full((), float(smoothness), **f32), origin)


def _read_audits(audits_t) -> np.ndarray:
    global host_reads, dropped
    with span("egg.draw.read_audit"):
        audits = audits_t.cpu().numpy()
    host_reads += 1
    dropped += int(audits[:, 0].sum())
    return audits


class RenderBudget:
    """The render budget of one handler, and its one owner: each
    population's budget boost ``k_boost`` and peak-density hint
    ``peak_density``, the host copy of the stats the options were last
    formed from (``host_stats``) and the device audit of the last frame
    drawn (``audit``, (pop, [drops, peak bin occupancy])). Its methods take
    plain values; ``inputs`` are :meth:`options`' keyword arguments."""

    def __init__(self):
        self.k_boost = [1.0, 1.0]
        self.peak_density = [None, None]
        self.host_stats: Optional[np.ndarray] = None
        self.audit: Optional[torch.Tensor] = None

    def read_options(self, stats, **inputs) -> Tuple[RenderOptions,
                                                     RenderOptions]:
        """Per-population RenderOptions of a frame (canvas buckets from
        ``stats``, reference :1944-1954). The stats come to the host in one
        read (``host_reads``), inside the span ``egg.draw.read_stats`` with
        the options built from them; the host copy is kept, for a re-render
        to form its options without a read."""
        global host_reads
        with span("egg.draw.read_stats"):
            self.host_stats = torch.cat([
                stats.aabb_min.reshape(-1), stats.aabb_max.reshape(-1),
                stats.max_velocity.reshape(-1)]).cpu().numpy()
            host_reads += 1
            return self.options(**inputs)

    def options(self, configs, counts, canvas_size, use_particle_color,
                post_mode) -> Tuple[RenderOptions, RenderOptions]:
        """The options of :meth:`read_options` from its host copy of the
        stats, at the current boost and peak-density hint: ``configs`` the
        (white, yolk) host configs, ``counts`` the live counts,
        ``canvas_size`` a fixed canvas size (None: the bucket of the
        stats), and the render's particle colour and post mode."""
        host = self.host_stats
        aabb_min_all = host[0:4].reshape(2, 2)
        aabb_max_all = host[4:8].reshape(2, 2)
        max_vel = host[8:10]
        opts = []
        for i, cfg in enumerate(configs):
            aabb_min, aabb_max = aabb_min_all[i], aabb_max_all[i]
            if canvas_size is not None:
                bucket = int(canvas_size)
            else:
                bucket = pick_canvas_bucket(
                    aabb_min, aabb_max,
                    cfg["max_radius"] * cfg["texture_scale"],
                    float(max_vel[i]), cfg["motion_blur"], None)
            area = float(max(aabb_max[0] - aabb_min[0], 1.0)
                         * max(aabb_max[1] - aabb_min[1], 1.0))
            density = counts[i] / area if area > 1.0 else None
            opts.append(auto_render_options(
                cfg, bucket, use_particle_color=use_particle_color,
                density=density, k_boost=self.k_boost[i],
                peak_density=self.peak_density[i], post_mode=post_mode))
        return tuple(opts)

    def seed(self, opts2, pos_all, active) -> None:
        """Set each population's peak-density hint from its host positions
        (``pos_all`` (2, N, 2), ``active`` (2, N)) binned as a frame at
        ``opts2`` bins them (:func:`_host_peak_density`), so the first draw
        of a clustered scene is sized right without a re-render."""
        dens = list(self.peak_density)
        for i in range(2):
            pos = pos_all[i][active[i]]
            if pos.shape[0] > 0:
                dens[i] = _host_peak_density(pos, opts2[i])
        self.peak_density = dens

    def audit_frame(self, opts2, frame, audits_t, render, stats, inputs):
        """The audit of a frame drawn at ``opts2`` (``audits_t`` on the
        device), read once a fresh frame (``host_reads``): the peak-density
        hint is raised (never lowered) to the measured peak; while a
        population dropped splats, its boost is sized from the measured
        peak and a warning logged, 3 attempts at most, as the JAX package's
        draw does.

        An attempt re-renders only if the options it would draw at (the new
        boost and hint over the kept host stats) differ from those just
        drawn: then ``render(opts2)`` (which draws the frame again and
        returns ``(frame, audits)``) runs at the options of a fresh read of
        ``stats``, a span ``egg.draw.rerender`` that holds its reads and its
        render, counted in ``rerenders``. Equal options would replay the
        same render of the same inputs, so the attempt draws nothing and
        reads nothing (``rerenders_skipped``): the frame and the audit stay
        those already drawn, and the next attempt's boost is sized from the
        same audit numbers that the repeated render would have read.
        Returns the last frame drawn and its audit."""
        global rerenders, rerenders_skipped
        audits = _read_audits(audits_t)
        dens = list(self.peak_density)
        for i in range(2):
            o = opts2[i]
            m = int(audits[i, 1])
            if m > 0:
                d = m / float(o.bin_h * o.bin_w * o.downsample ** 2)
                if dens[i] is None or d > dens[i]:   # only RAISE the hint
                    dens[i] = d
        self.peak_density = dens
        # auto-bump: size the per-bin budget of any overflowing population
        # from the MEASURED max bin occupancy and re-render until the frame
        # drops nothing
        for attempt in range(3):
            if audits[:, 0].sum() == 0:
                break
            from ..utils import log
            boosts = list(self.k_boost)
            for i in range(2):
                if audits[i, 0] > 0:
                    need = min(256, max(8, -(-int(audits[i, 1] * 1.2) // 8)
                                        * 8))
                    boosts[i] *= max(1.0, need / opts2[i].tile_capacity)
            self.k_boost = boosts
            log.warning("render budget overflow: dropped ", int(audits[0, 0]),
                        " white / ", int(audits[1, 0]), " yolk particles "
                        "past tile_capacity (peak bin occupancy ",
                        (int(audits[0, 1]), int(audits[1, 1])),
                        "); re-rendering with budget boost ", tuple(boosts))
            if self.options(**inputs) == tuple(opts2):
                rerenders_skipped += 1
                continue
            with span("egg.draw.rerender"):
                rerenders += 1
                opts2 = self.read_options(stats, **inputs)
                frame, audits_t = render(opts2)
                if attempt < 2:        # the last attempt's audit is not read
                    audits = _read_audits(audits_t)
        return frame, audits_t


def draw(budget: RenderBudget, render, stats, inputs: dict, background=None,
         check_overflow=True):
    """A frame drawn at ``budget``'s options: the draw of both handlers.

    ``render(opts2)`` renders the frame at ``opts2`` and returns ``(frame
    (H, W, 4) straight alpha, audits)``; ``stats`` and ``inputs`` are what
    the options are formed from. ``check_overflow`` (default ON — the
    reference drops nothing inside its canvas, :2054-2064) audits the frame
    and re-renders it with a boosted budget
    (:meth:`RenderBudget.audit_frame`); the audit of the frame drawn is kept
    on the budget.
    ``background``, an optional (r, g, b, a), is composited under
    everything."""
    opts2 = budget.read_options(stats, **inputs)
    frame, audits_t = render(opts2)
    if check_overflow:
        frame, audits_t = budget.audit_frame(opts2, frame, audits_t, render,
                                             stats, inputs)
    budget.audit = audits_t
    if background is not None:
        # a float operand, not a copy of the colour to the device
        bg = [float(v) for v in background]
        a = frame[..., 3:4]
        frame = torch.cat([frame[..., c:c + 1] * 1.0 + bg[c] * (1.0 - a)
                           for c in range(3)]
                          + [torch.clamp(a, min=bg[3])], dim=-1)
    return frame
