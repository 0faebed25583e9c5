"""Kernel I: the render's canvas-to-screen tail (``csrc/composite.cu``).

Replaces no TPU kernel: the JAX package writes the bilinear upsample of a
canvas as two interpolation-matrix products (``_resize_linear_up``) and
pastes it at a fractional corner (``_paste_src_over_frac``), and XLA fuses
the paste. In PyTorch that sequence is two FP32 matrix products a canvas
and dozens of full-resolution launches; kernel I computes it in one pass
over the output with no intermediate.

- :func:`composite`: one population's RGBA, at the resolution its post pass
  ran at, upsampled to the canvas size ``s``, shifted by the corner's
  fractional part and blended src-over onto the ``(vh, vw, 4)`` frame at the
  corner's floor, in place. ``over_zero`` takes the destination as zero and
  writes every pixel (the first population: no fill needed).
- :func:`upsample`: the same bilinear taps into an ``(s, s[, c])`` canvas:
  the raw alpha canvases the render returns, and the post pass's input in
  ``"full"`` and ``"super"`` modes.

The taps are :func:`_resize_matrix`'s, two a row and column, with the
float32 sum of both weights where the edge clamp lands them on one index;
rows first, then columns, as the products order them. :func:`composite_taps`
is kernel I's arithmetic pixel by pixel in PyTorch, which the CPU tests hold
against the plain version. On the card the kernel differs from the matrix
route by rounding alone (each product rounded, ``--fmad=false``).

CPU tensors take the plain versions (:func:`composite_plain`,
:func:`upsample_plain`: the render's former inline code); CUDA tensors
launch the kernel, or raise. ``launches`` counts composite launches and
``upsample_launches`` upsample launches (eager renders and captures; a
replayed render moves neither).
"""

from __future__ import annotations

import functools

import torch

__all__ = ["composite", "composite_plain", "composite_taps", "upsample",
           "upsample_plain", "tap_weights", "launches", "upsample_launches"]

launches = 0            # kernel I's composite
upsample_launches = 0   # kernel I's upsample


# ------------------------------------------------------------ plain versions --

@functools.lru_cache(maxsize=16)
def _resize_matrix(s_out: int, s_in: int, device: torch.device) -> torch.Tensor:
    """(s_out, s_in) row-interpolation matrix of a 'linear' UPSAMPLE
    (half-pixel centres, edge clamp), made once on ``device`` by device ops
    (no copy from the host)."""
    pos = (torch.arange(s_out, dtype=torch.float64, device=device) + 0.5) \
        * (s_in / s_out) - 0.5
    lo = torch.floor(pos)
    w = (pos - lo).to(torch.float32)
    lo = lo.to(torch.int64)
    m = torch.zeros((s_out, s_in), dtype=torch.float32, device=device)
    m.scatter_add_(1, torch.clamp(lo, 0, s_in - 1)[:, None], (1.0 - w)[:, None])
    m.scatter_add_(1, torch.clamp(lo + 1, 0, s_in - 1)[:, None], w[:, None])
    return m


def upsample_plain(img: torch.Tensor, s_out: int) -> torch.Tensor:
    """Bilinear upsample of a square (S, S[, C]) image via interpolation
    matrix products (full float32: TF32 is off)."""
    s_in = img.shape[0]
    if s_out == s_in:
        return img
    if s_out < s_in:
        raise ValueError("the matrix path is an upsampler")
    m = _resize_matrix(s_out, s_in, img.device)
    if img.dim() == 2:
        return m @ img @ m.T
    t = torch.einsum("oi,ijc->ojc", m, img)
    return torch.einsum("pj,ojc->opc", m, t)


def _paste_src_over_frac(dst_rgb, dst_a, src_rgba, corner):
    """Fractional-position paste: bilinear-shift the canvas by the corner's
    fractional part, then integer-paste at the corner's floor, which stays
    on the device."""
    ci = torch.floor(corner)
    frac = corner - ci                                       # in [0, 1)
    fx, fy = frac[0], frac[1]
    p = torch.nn.functional.pad(src_rgba, (0, 0, 1, 1, 1, 1))
    s00 = p[1:-1, 1:-1]
    s01 = p[1:-1, :-2]                                       # x-1
    s10 = p[:-2, 1:-1]                                       # y-1
    s11 = p[:-2, :-2]
    shifted = (s00 * (1 - fx) * (1 - fy) + s01 * fx * (1 - fy)
               + s10 * (1 - fx) * fy + s11 * fx * fy)
    x0, y0 = ci.to(torch.int64)
    return _paste_src_over(dst_rgb, dst_a, shifted, x0, y0)


def _paste_src_over(dst_rgb, dst_a, src_rgba, x0, y0):
    """Alpha-blend a canvas onto the screen at integer offset (x0, y0), 0-dim
    integer tensors on the device, clipped to the viewport: screen pixel
    (y, x) takes canvas pixel (y - y0, x - x0), zero off the canvas (the
    JAX package's ``dynamic_slice`` of a padded canvas, without the pad)."""
    vh, vw = dst_a.shape
    s = src_rgba.shape[0]
    dev = src_rgba.device
    ry = torch.arange(vh, device=dev) - y0
    rx = torch.arange(vw, device=dev) - x0
    inside = (((ry >= 0) & (ry < s))[:, None]
              & ((rx >= 0) & (rx < s))[None, :])
    placed = src_rgba.index_select(0, torch.clamp(ry, 0, s - 1)) \
        .index_select(1, torch.clamp(rx, 0, s - 1))
    placed = torch.where(inside[..., None], placed, 0.0)
    src_a = torch.clamp(placed[..., 3], 0.0, 1.0)
    src_rgb = placed[..., :3]
    out_rgb = src_rgb * src_a[..., None] + dst_rgb * (1.0 - src_a[..., None])
    out_a = src_a + dst_a * (1.0 - src_a)
    return out_rgb, out_a


def _destination(frame, over_zero: bool):
    """The frame's colour and alpha, or zeros of their shapes."""
    if over_zero:
        return (frame.new_zeros(frame.shape[:2] + (3,)),
                frame.new_zeros(frame.shape[:2]))
    return frame[..., :3], frame[..., 3]


def composite_plain(frame, rgba, s: int, corner, over_zero: bool):
    """:func:`composite` as the render computed it before kernel I:
    :func:`upsample_plain` to ``s``, then :func:`_paste_src_over_frac`."""
    dst_rgb, dst_a = _destination(frame, over_zero)
    out_rgb, out_a = _paste_src_over_frac(dst_rgb, dst_a,
                                          upsample_plain(rgba, s), corner)
    frame[..., :3] = out_rgb
    frame[..., 3] = out_a
    return frame


# ---------------------------------------------- kernel I's arithmetic, plain --

def tap_weights(s_in: int, s_out: int, device="cpu"):
    """Kernel I's taps of every output index ``o < s_out``: ``(lo, hi, w0,
    w1, merged)``, the two clamped source indices, their float32 weights and
    whether the clamp lands both on one index (then ``w0`` is the float32
    sum of the two weights, the matrix's one entry, and ``w1`` unused)."""
    pos = (torch.arange(s_out, dtype=torch.float64, device=device) + 0.5) \
        * (s_in / s_out) - 0.5
    fl = torch.floor(pos)
    w = (pos - fl).to(torch.float32)
    lo = torch.clamp(fl.to(torch.int64), 0, s_in - 1)
    hi = torch.clamp(fl.to(torch.int64) + 1, 0, s_in - 1)
    merged = lo == hi
    w0 = 1.0 - w
    return lo, hi, torch.where(merged, w0 + w, w0), w, merged


def _up_at(src, s: int, rows, cols):
    """The source (s_in, s_in, C) upsampled to ``s`` at the canvas pixels
    (rows, cols), as kernel I forms one value: rows first, two taps each."""
    s_in = src.shape[0]
    if s_in == s:
        return src[rows, cols]
    lo, hi, w0, w1, merged = tap_weights(s_in, s, src.device)

    def row_pass(col):
        top = src[lo[rows], col] * w0[rows, None]
        return torch.where(merged[rows, None], top,
                           top + src[hi[rows], col] * w1[rows, None])

    at_lo, at_hi = row_pass(lo[cols]), row_pass(hi[cols])
    first = at_lo * w0[cols, None]
    return torch.where(merged[cols, None], first,
                       first + at_hi * w1[cols, None])


def composite_taps(frame, rgba, s: int, corner, over_zero: bool):
    """:func:`composite` pixel by pixel as kernel I computes it: each screen
    pixel's canvas pixel from the corner's floor, four shift samples (zero
    off the canvas), each from two by two source taps, and the src-over
    blend; screen pixels off the canvas keep the frame (zero with
    ``over_zero``)."""
    vh, vw = frame.shape[:2]
    dev = frame.device
    ix, iy = torch.floor(corner[0]), torch.floor(corner[1])
    fx, fy = corner[0] - ix, corner[1] - iy
    r = (torch.arange(vh, device=dev)[:, None]
         - iy.to(torch.int64)).expand(vh, vw).reshape(-1)
    c = (torch.arange(vw, device=dev)[None, :]
         - ix.to(torch.int64)).expand(vh, vw).reshape(-1)
    inside = torch.nonzero((r >= 0) & (r < s) & (c >= 0) & (c < s))[:, 0]
    r, c = r[inside], c[inside]

    def sample(dr, dc):
        rr, cc = r - dr, c - dc
        v = _up_at(rgba, s, torch.clamp(rr, min=0), torch.clamp(cc, min=0))
        return torch.where(((rr >= 0) & (cc >= 0))[:, None], v, 0.0)

    ux, uy = 1.0 - fx, 1.0 - fy
    shifted = (sample(0, 0) * ux * uy + sample(0, 1) * fx * uy
               + sample(1, 0) * ux * fy + sample(1, 1) * fx * fy)
    a = torch.clamp(shifted[:, 3], 0.0, 1.0)
    out = frame.reshape(-1, 4).clone()
    if over_zero:
        out.zero_()
    dst = out[inside]
    keep = 1.0 - a
    out[inside] = torch.cat([shifted[:, :3] * a[:, None]
                             + dst[:, :3] * keep[:, None],
                             (a + dst[:, 3] * keep)[:, None]], dim=1)
    frame.copy_(out.reshape(vh, vw, 4))
    return frame


# ------------------------------------------------------------------ dispatch --

def composite(frame: torch.Tensor, rgba: torch.Tensor, s: int,
              corner: torch.Tensor, over_zero: bool) -> torch.Tensor:
    """Blend one population's straight RGBA ``rgba`` (s_in, s_in, 4), its
    canvas of size ``s`` (at least s_in) placed with its top-left corner
    at ``corner`` ((2,) float32 on the device: x, y in viewport pixels),
    src-over onto ``frame`` (vh, vw, 4), in place; with ``over_zero`` the
    frame's contents are not read. Returns ``frame``."""
    dev = frame.device
    if dev.type == "cpu":
        return composite_plain(frame, rgba, s, corner, over_zero)
    if dev.type != "cuda":
        raise RuntimeError(f"composite: no kernel for device {dev}")
    from . import library
    s_in = rgba.shape[0]
    if (rgba.shape != (s_in, s_in, 4) or not 0 < s_in <= s
            or frame.dim() != 3 or frame.shape[2] != 4
            or corner.shape != (2,)
            or any(t.dtype != torch.float32 or t.device != dev
                   for t in (rgba, corner))
            or frame.dtype != torch.float32 or not frame.is_contiguous()):
        raise ValueError("composite: float32 rgba (s_in, s_in, 4) with s_in "
                         "<= s, corner (2,) and a contiguous frame (vh, vw, "
                         "4) on one device expected")
    rgba = rgba.contiguous()
    corner = corner.contiguous()
    lib = library.load()
    err = lib.egg_composite(rgba.data_ptr(), corner.data_ptr(),
                            frame.data_ptr(), s_in, int(s), frame.shape[0],
                            frame.shape[1], int(over_zero),
                            library.stream_handle(dev))
    library.check("composite", err)
    global launches
    launches += 1
    return frame


def upsample(img: torch.Tensor, s_out: int) -> torch.Tensor:
    """Bilinear upsample of a square (S, S) or (S, S, C) float32 image to
    ``s_out`` (the image itself at ``s_out == S``)."""
    dev = img.device
    if dev.type == "cpu":
        return upsample_plain(img, s_out)
    if dev.type != "cuda":
        raise RuntimeError(f"upsample: no kernel for device {dev}")
    from . import library
    s_in = img.shape[0]
    channels = 1 if img.dim() == 2 else img.shape[2]
    if (img.dim() not in (2, 3) or img.shape[1] != s_in
            or not 1 <= channels <= 4 or img.dtype != torch.float32):
        raise ValueError("upsample: float32 (S, S) or (S, S, C <= 4) expected")
    if s_out < s_in:
        raise ValueError("upsample: an upsampler, s_out >= S")
    if s_out == s_in:
        return img
    img = img.contiguous()
    out = torch.empty((s_out, s_out) + tuple(img.shape[2:]),
                      dtype=torch.float32, device=dev)
    lib = library.load()
    err = lib.egg_upsample(img.data_ptr(), out.data_ptr(), s_in, int(s_out),
                           channels, library.stream_handle(dev))
    library.check("upsample", err)
    global upsample_launches
    upsample_launches += 1
    return out
