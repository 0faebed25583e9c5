# Frozen copy of egg_fluid_simulation_tpu_torch/ops/kernels/place_kernel.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
# every wrapper runs its plain version on every device (the kernel routes are cut).
"""Kernel A: dense plane placement (``csrc/place_planes.cu``).

Replaces ``egg_fluid_simulation_tpu/ops/pallas/place_kernel.py``
(``_place_pallas``): it expands the cell-sorted particle payload into the
``(F, G + 2*ROW_PAD, L)`` plane tensor, one entry per unique slot, every
other slot zero, and fills the torus halo rows in the same pass. On the TPU
this took a one-hot product per 512-slot chunk; on Hopper a block owns a
chunk of whole cells (512 slots at K = 4), finds the chunk's run of sorted
entries by a search of the sorted cell ids (the JAX wrapper's
``search_key``), stages the run's payload rows, read through
``pidx_sorted``, in shared memory by slot, and writes every element of its
slots once, halo copies included: no zero fill, no gathered copy of the
payload. The golden model is the scatter branch of
:func:`..dense.bin_to_planes`, which it matches bit for bit; unlike the TPU
kernel it never leaves an in-budget entry unplaced, however many
over-budget entries a cell's run holds.

:func:`place_planes` dispatches on the tensors' device: CPU tensors take
:func:`place_planes_plain`; CUDA tensors launch the kernel, or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import dense as D

__all__ = ["place_planes", "place_planes_plain", "launches"]

launches = 0


def place_planes_plain(cell_sorted: torch.Tensor, slot_sorted: torch.Tensor,
                       pidx_sorted: torch.Tensor, pack: torch.Tensor,
                       g: int, k: int) -> torch.Tensor:
    """Plain PyTorch placement: (F, G + 2*ROW_PAD, L) planes, halo filled.

    The outputs of :func:`..dense.sort_bin`: ``cell_sorted`` (N,) the
    entries' cell ids, ascending (``G*G`` for inactive entries);
    ``slot_sorted`` (N,) unpadded flat slots, ``G*L`` = not placed, an
    in-budget slot inside its entry's cell (``slot // K == cell``);
    ``pidx_sorted`` (N,) the particle of each entry; ``pack`` (N, F) float32
    payload in particle order. The placement follows from the slots alone:
    ``cell_sorted`` only tells the kernel where a chunk's entries lie."""
    del cell_sorted
    lanes = g * k
    rows = g + 2 * D.ROW_PAD
    n_f = pack.shape[1]
    out = torch.zeros((n_f, rows * lanes), dtype=torch.float32,
                      device=pack.device)
    ok = (slot_sorted >= 0) & (slot_sorted < g * lanes)
    slots = slot_sorted[ok].to(torch.int64) + D.ROW_PAD * lanes
    out[:, slots] = pack[pidx_sorted[ok]].T
    return D.fill_halo(out.reshape(n_f, rows, lanes))


def place_planes(cell_sorted: torch.Tensor, slot_sorted: torch.Tensor,
                 pidx_sorted: torch.Tensor, pack: torch.Tensor,
                 g: int, k: int) -> torch.Tensor:
    """(F, G + 2*ROW_PAD, L) planes from the cell sort's outputs (see
    :func:`place_planes_plain`)."""
    dev = pack.device
    return place_planes_plain(cell_sorted, slot_sorted, pidx_sorted,
                              pack, g, k)

