"""Kernel I's plain versions and its arithmetic, on the CPU
(``ops/kernels/composite_kernel.py``; the kernel is ``csrc/composite.cu``).

- ``composite_plain`` (white over a zero screen, then the yolk over that)
  and ``upsample_plain`` bit for bit against the render's former inline
  sequence, kept here as the reference: ``_resize_linear_up``, then
  ``_paste_src_over_frac`` onto separate colour and alpha screens, then one
  ``cat``. Factors 1, 2 and 4, a square and an 800 x 600 viewport, corners
  inside, partly off and fully off each edge, fractional parts 0, 0.25 and
  0.999.
- ``composite_taps``, kernel I's arithmetic pixel by pixel (two taps a row
  and column, the merged edge weight, four shift samples, the blend),
  within 1e-6 of the plain version on the same cases: the products of the
  interpolation matrices add the two taps' terms in their own order (and
  may fuse them), so the two differ by float32 rounding of values in [0, 1]
  (2.4e-7 measured).
- ``tap_weights``, the taps the kernel forms, rebuild ``_resize_matrix``
  bit for bit, and the merged edge weight is exactly 1.0 at factors 2 and
  4.
- The wrappers take the plain versions on the CPU and raise on a device
  without a kernel.
"""

import numpy as np
import pytest
import torch

from egg_fluid_simulation_tpu_torch.ops.kernels import composite_kernel as CK

S_WHITE, S_YOLK = 64, 32
VIEWPORTS = {"square": (96, 96), "800x600": (600, 800)}
FRACS = (0.0, 0.25, 0.999)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corners(vh, vw):
    """Integer corner parts (x, y) of the white canvas: inside, partly off
    and fully off each edge and a corner of the viewport."""
    s = S_WHITE
    return {
        "inside": (vw // 3, vh // 4),
        "part_left": (-s // 2, vh // 3),
        "part_right": (vw - s // 3, vh // 5),
        "part_top": (vw // 4, -s // 2),
        "part_bottom": (vw // 5, vh - s // 4),
        "part_top_left": (-s // 3, -s // 5),
        "gone_left": (-s - 3, vh // 3),
        "gone_right": (vw + 2, vh // 3),
        "gone_top": (vw // 3, -s - 1),
        "gone_bottom": (vw // 3, vh + 5),
        "edge_left": (-s, 0),
    }


# ------------------------------------ the render's former inline sequence --

def _resize_matrix_before(s_out, s_in):
    pos = (torch.arange(s_out, dtype=torch.float64) + 0.5) * (s_in / s_out) - 0.5
    lo = torch.floor(pos)
    w = (pos - lo).to(torch.float32)
    lo = lo.to(torch.int64)
    m = torch.zeros((s_out, s_in), dtype=torch.float32)
    m.scatter_add_(1, torch.clamp(lo, 0, s_in - 1)[:, None], (1.0 - w)[:, None])
    m.scatter_add_(1, torch.clamp(lo + 1, 0, s_in - 1)[:, None], w[:, None])
    return m


def _resize_linear_up_before(img, s_out):
    s_in = img.shape[0]
    if s_out == s_in:
        return img
    m = _resize_matrix_before(s_out, s_in)
    if img.dim() == 2:
        return m @ img @ m.T
    t = torch.einsum("oi,ijc->ojc", m, img)
    return torch.einsum("pj,ojc->opc", m, t)


def _paste_src_over_before(dst_rgb, dst_a, src_rgba, x0, y0):
    vh, vw = dst_a.shape
    s = src_rgba.shape[0]
    ry = torch.arange(vh) - y0
    rx = torch.arange(vw) - x0
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


def _paste_src_over_frac_before(dst_rgb, dst_a, src_rgba, corner):
    ci = torch.floor(corner)
    frac = corner - ci
    fx, fy = frac[0], frac[1]
    p = torch.nn.functional.pad(src_rgba, (0, 0, 1, 1, 1, 1))
    s00 = p[1:-1, 1:-1]
    s01 = p[1:-1, :-2]
    s10 = p[:-2, 1:-1]
    s11 = p[:-2, :-2]
    shifted = (s00 * (1 - fx) * (1 - fy) + s01 * fx * (1 - fy)
               + s10 * (1 - fx) * fy + s11 * fx * fy)
    x0, y0 = ci.to(torch.int64)
    return _paste_src_over_before(dst_rgb, dst_a, shifted, x0, y0)


def _frame_before(pops, vh, vw):
    screen_rgb = torch.zeros((vh, vw, 3), dtype=torch.float32)
    screen_a = torch.zeros((vh, vw), dtype=torch.float32)
    for rgba, s, corner in pops:
        screen_rgb, screen_a = _paste_src_over_frac_before(
            screen_rgb, screen_a, _resize_linear_up_before(rgba, s), corner)
    return torch.cat([screen_rgb, screen_a[..., None]], dim=-1)


# ------------------------------------------------------------------ cases --

def _case(factor, viewport, corner, frac):
    """(white, yolk) as (rgba at the post resolution, canvas size, corner)
    and the viewport: straight RGBA with alpha past [0, 1] (the blend
    clamps it) and colour below 0 (lighting's shadow), seeded."""
    vh, vw = VIEWPORTS[viewport]
    x, y = _corners(vh, vw)[corner]
    rng = np.random.RandomState(factor * 100 + len(corner) + int(frac * 8))
    pops = []
    for s, shift in ((S_WHITE, (0.0, 0.0)), (S_YOLK, (17.5, 11.75))):
        src = rng.uniform(-0.1, 1.2, (s // factor, s // factor, 4))
        c = np.asarray([x + frac + shift[0], y + frac + shift[1]], np.float32)
        pops.append((torch.from_numpy(src.astype(np.float32)), s,
                     torch.from_numpy(c)))
    return pops, vh, vw


def _frame(fn, pops, vh, vw):
    frame = torch.empty((vh, vw, 4), dtype=torch.float32)
    for i, (rgba, s, corner) in enumerate(pops):
        fn(frame, rgba, s, corner, over_zero=i == 0)
    return frame


CASES = pytest.mark.parametrize("frac", FRACS, ids=["f0", "f025", "f0999"])
VIEWS = pytest.mark.parametrize("viewport", sorted(VIEWPORTS))
FACTORS = pytest.mark.parametrize("factor", [1, 2, 4], ids=["x1", "x2", "x4"])
CORNERS = pytest.mark.parametrize("corner", sorted(_corners(96, 96)))


@CASES
@CORNERS
@VIEWS
@FACTORS
def test_composite_plain_is_the_former_sequence(factor, viewport, corner,
                                                frac):
    pops, vh, vw = _case(factor, viewport, corner, frac)
    got = _frame(CK.composite_plain, pops, vh, vw)
    assert torch.equal(got, _frame_before(pops, vh, vw))


@CASES
@CORNERS
@VIEWS
@FACTORS
def test_composite_taps_match_the_plain_version(factor, viewport, corner,
                                                frac):
    pops, vh, vw = _case(factor, viewport, corner, frac)
    want = _frame(CK.composite_plain, pops, vh, vw)
    got = _frame(CK.composite_taps, pops, vh, vw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    # off both canvases the frame stays zero
    covered = torch.zeros((vh, vw), dtype=torch.bool)
    for _, s, c in pops:
        x0, y0 = (int(v) for v in torch.floor(c))
        covered[max(y0, 0):max(y0 + s, 0), max(x0, 0):max(x0 + s, 0)] = True
    assert bool((got[~covered] == 0).all())


@FACTORS
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_upsample_plain_is_the_former_matrices(factor, channels):
    rng = np.random.RandomState(factor + channels)
    shape = (24, 24) if channels == 1 else (24, 24, channels)
    img = torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32))
    got = CK.upsample_plain(img, 24 * factor)
    assert torch.equal(got, _resize_linear_up_before(img, 24 * factor))
    assert torch.equal(CK.upsample(img, 24 * factor), got)


@pytest.mark.parametrize("sizes", [(256, 128), (512, 128), (640, 160),
                                   (2560, 640), (513, 64), (96, 96)])
def test_taps_rebuild_the_upsampling_matrix(sizes):
    s_out, s_in = sizes
    lo, hi, w0, w1, merged = CK.tap_weights(s_in, s_out)
    m = torch.zeros((s_out, s_in), dtype=torch.float32)
    rows = torch.arange(s_out)
    m[rows, lo] = w0
    m[rows[~merged], hi[~merged]] = w1[~merged]
    assert torch.equal(m, CK._resize_matrix(s_out, s_in, torch.device("cpu")))
    assert torch.equal(merged, lo == hi)
    if s_out in (2 * s_in, 4 * s_in):
        assert bool(merged.any()) and bool((w0[merged] == 1.0).all())


def test_wrappers_take_plain_on_cpu_and_reject_other_devices():
    pops, vh, vw = _case(4, "square", "inside", 0.25)
    before = (CK.launches, CK.upsample_launches)
    got = _frame(CK.composite, pops, vh, vw)
    assert torch.equal(got, _frame(CK.composite_plain, pops, vh, vw))
    assert (CK.launches, CK.upsample_launches) == before
    rgba, s, corner = pops[0]
    meta = torch.empty((vh, vw, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        CK.composite(meta, rgba.to("meta"), s, corner.to("meta"), True)
    with pytest.raises(RuntimeError, match="no kernel"):
        CK.upsample(rgba[..., 3].to("meta"), s)
    with pytest.raises(ValueError, match="upsampler"):
        CK.upsample(rgba, rgba.shape[0] // 2)
