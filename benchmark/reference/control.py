"""The stand-ins that set a compared number's two readings: the control,
the reference computed one precision below the configuration's float32
with bfloat16 storage (the upper reading), and the witness, a sound
float32 program that rounds otherwise (with the program's own runs, the
lower reading).

The step's work is elementwise float32 outside any matrix product, so the
nearest lower precision is bfloat16 (TF32 would change nothing there):
every collision pass (kernel B's plain version) reads its positions and
writes its results rounded to bfloat16, and every splat (kernel C's) writes
its density rounded to bfloat16. Its outputs, compared with the reference's
as the program's are, give each compared number's upper reading.

The witness (``reordered``) is the reference with kernel B's pair terms
summed over the partner offsets in the reverse order and ``1 / sqrt`` in
place of ``rsqrt``: the two liberties a faster kernel B takes (another
order of its sums, another reciprocal square root), each exact to float32
rounding. The program's kernels equal the reference's plain versions bit
for bit, so it is the witness that shows how far rounding alone carries a
checked unit.
"""

from __future__ import annotations

import contextlib

import torch

from . import batched
from .frozen.ops.kernels import splat_kernel, sweep_kernel


def bf16(t):
    if t is None:
        return None
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def lowered():
    """Run the reference in the control's precision inside the block."""
    pass_fn, splat_fn = sweep_kernel.substep_pass, splat_kernel.splat

    def substep_pass(xy, stat, params, aux, k, *, prev=None, **kw):
        out = pass_fn(bf16(xy), stat, params, aux, k, prev=bf16(prev), **kw)
        if isinstance(out, tuple):
            return tuple(bf16(t) for t in out)
        return bf16(out)

    def splat(payload, counts, opts, use_rgb):
        alpha, rgb = splat_fn(payload, counts, opts, use_rgb)
        return bf16(alpha), bf16(rgb)

    sweep_kernel.substep_pass, splat_kernel.splat = substep_pass, splat
    try:
        yield
    finally:
        sweep_kernel.substep_pass, splat_kernel.splat = pass_fn, splat_fn


@contextlib.contextmanager
def reordered():
    """Run the reference as the witness inside the block."""
    rsqrt, reverse = batched.RSQRT, batched.REVERSE
    batched.RSQRT = lambda x: 1.0 / torch.sqrt(x)
    batched.REVERSE = True
    try:
        yield
    finally:
        batched.RSQRT, batched.REVERSE = rsqrt, reverse
