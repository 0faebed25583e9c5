"""The stand-ins that set a compared number's two readings: the control,
the reference computed one precision below the configuration's float32
with bfloat16 storage (the upper reading), and the witness, a sound
float32 program that rounds otherwise (with the program's own runs, the
lower reading).

The step's work is elementwise float32 outside any matrix product, so the
nearest lower precision is bfloat16 (TF32 would change nothing there):
every collision pass (kernel B's plain version on the dense engine, kernel
H's sweep on the gather engine) reads its positions and writes its results
rounded to bfloat16, and every splat (kernel C's) writes its density
rounded to bfloat16. Its outputs, compared with the reference's as the
program's are, give each compared number's upper reading.

The witness (``reordered``) is the reference with kernel B's pair terms
summed over the partner offsets in the reverse order and ``1 / sqrt`` in
place of ``rsqrt``, and kernel H's sweep summing each particle's candidate
terms in the reverse order (the candidate lists handed to it reversed; the
budget's count and the bound's tally do not depend on their order): the
liberties a faster kernel takes (another order of its sums, another
reciprocal square root), each exact to float32 rounding. H computes
``1 / sqrt`` as the reference does, so its sweep keeps that. The program's
kernels equal the reference's plain versions but for the order of H's
sums, so it is the witness that shows how far rounding alone carries a
checked unit.
"""

from __future__ import annotations

import contextlib

import torch

from . import batched
from .frozen.ops.kernels import gather_kernel, splat_kernel, sweep_kernel


def bf16(t):
    if t is None:
        return None
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def lowered():
    """Run the reference in the control's precision inside the block."""
    pass_fn, splat_fn = sweep_kernel.substep_pass, splat_kernel.splat
    gather_fn = gather_kernel.gather_sweep

    def substep_pass(xy, stat, params, aux, k, *, prev=None, **kw):
        out = pass_fn(bf16(xy), stat, params, aux, k, prev=bf16(prev), **kw)
        if isinstance(out, tuple):
            return tuple(bf16(t) for t in out)
        return bf16(out)

    def gather_sweep(record, *args, **kw):
        rounded = record.clone()            # the cell and id words kept
        rounded[:, 0:2] = bf16(record[:, 0:2])
        return bf16(gather_fn(rounded, *args, **kw))

    def splat(payload, counts, opts, use_rgb):
        alpha, rgb = splat_fn(payload, counts, opts, use_rgb)
        return bf16(alpha), bf16(rgb)

    sweep_kernel.substep_pass, splat_kernel.splat = substep_pass, splat
    gather_kernel.gather_sweep = gather_sweep
    try:
        yield
    finally:
        sweep_kernel.substep_pass, splat_kernel.splat = pass_fn, splat_fn
        gather_kernel.gather_sweep = gather_fn


@contextlib.contextmanager
def reordered():
    """Run the reference as the witness inside the block."""
    rsqrt, reverse = batched.RSQRT, batched.REVERSE
    candidates = gather_kernel.candidates

    def reversed_candidates(*args, **kw):
        cand, valid = candidates(*args, **kw)
        return cand.flip(1), valid.flip(1)

    batched.RSQRT = lambda x: 1.0 / torch.sqrt(x)
    batched.REVERSE = True
    gather_kernel.candidates = reversed_candidates
    try:
        yield
    finally:
        batched.RSQRT, batched.REVERSE = rsqrt, reverse
        gather_kernel.candidates = candidates
