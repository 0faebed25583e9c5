"""Kernel A: dense plane placement (``csrc/place_planes.cu``).

Replaces ``egg_fluid_simulation_tpu/ops/pallas/place_kernel.py``
(``_place_pallas``): it expands the cell-sorted particle payload into the
``(F, G + 2*ROW_PAD, L)`` plane tensor, one entry per unique slot, every
other slot zero, and fills the torus halo rows in the same pass. On the TPU
this took a one-hot product per 512-slot chunk; on Hopper it is a direct
indexed store, one thread per sorted entry, bound by memory traffic (each
value moves once). The golden model is the scatter branch of
:func:`..dense.bin_to_planes`, which it matches bit for bit; unlike the TPU
kernel it never leaves an in-budget entry unplaced.

:func:`place_planes` dispatches on the tensors' device: CPU tensors take
:func:`place_planes_plain`; CUDA tensors launch the kernel, or raise.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import dense as D

__all__ = ["place_planes", "place_planes_plain", "launches"]

launches = 0


def place_planes_plain(slot_sorted: torch.Tensor, pack_sorted: torch.Tensor,
                       g: int, k: int) -> torch.Tensor:
    """Plain PyTorch placement: (F, G + 2*ROW_PAD, L) planes, halo filled.

    ``slot_sorted``: (N,) unpadded flat slots, ``G*L`` = not placed;
    ``pack_sorted``: (N, F) float32 payload in the same order."""
    lanes = g * k
    rows = g + 2 * D.ROW_PAD
    n_f = pack_sorted.shape[1]
    out = torch.zeros((n_f, rows * lanes), dtype=torch.float32,
                      device=pack_sorted.device)
    ok = (slot_sorted >= 0) & (slot_sorted < g * lanes)
    slots = slot_sorted[ok].to(torch.int64) + D.ROW_PAD * lanes
    out[:, slots] = pack_sorted[ok].T
    return D.fill_halo(out.reshape(n_f, rows, lanes))


def place_planes(slot_sorted: torch.Tensor, pack_sorted: torch.Tensor,
                 g: int, k: int) -> torch.Tensor:
    """(F, G + 2*ROW_PAD, L) planes from sorted slots + payload."""
    dev = pack_sorted.device
    if dev.type == "cpu":
        return place_planes_plain(slot_sorted, pack_sorted, g, k)
    if dev.type != "cuda":
        raise RuntimeError(f"place_planes: no kernel for device {dev}")
    from . import library
    n, n_f = pack_sorted.shape
    if (slot_sorted.shape != (n,) or pack_sorted.dtype != torch.float32
            or slot_sorted.device != dev):
        raise ValueError("place_planes: slot_sorted (N,) and float32 "
                         "pack_sorted (N, F) on one device expected")
    if g < 2 * D.ROW_PAD:
        raise ValueError("place_planes: grid_dim must be at least 2*ROW_PAD")
    slot32 = slot_sorted.to(torch.int32).contiguous()
    pack = pack_sorted.contiguous()
    lanes = g * k
    out = torch.zeros((n_f, g + 2 * D.ROW_PAD, lanes), dtype=torch.float32,
                      device=dev)
    lib = library.load()
    err = lib.egg_place_planes(slot32.data_ptr(), pack.data_ptr(),
                               out.data_ptr(), n, n_f, g, lanes, D.ROW_PAD,
                               library.stream_handle(dev))
    library.check("place_planes", err)
    global launches
    launches += 1
    return out
