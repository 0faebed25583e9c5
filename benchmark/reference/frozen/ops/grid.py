# Frozen copy of egg_fluid_simulation_tpu_torch/ops/grid.py at commit e9e0aedb87f3: the port's plain
# PyTorch path, kept as the benchmark's reference, trimmed to what the
# cells run.
"""Run-length helpers over sorted keys, and pair counting (the gather
engine's hash grid is left out of this copy).

The counterpart of ``egg_fluid_simulation_tpu/ops/grid.py``.
"""

from __future__ import annotations

import torch

__all__ = ["segmented_rank", "segment_extent", "count_pairs"]


def _run_bounds(sorted_keys: torch.Tensor):
    """Index, run start and run end (inclusive) of each element of a sorted
    key array. Two binary searches of the keys in themselves: the same
    bounds as the JAX package's forward cummax / reverse cummin scans, which
    are slow on a GPU for int64 (an index-tracking scan)."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_keys.device)
    keys = sorted_keys.contiguous()
    run_start = torch.searchsorted(keys, keys, right=False)
    run_end = torch.searchsorted(keys, keys, right=True) - 1
    return idx, run_start, run_end


def segmented_rank(sorted_keys: torch.Tensor) -> torch.Tensor:
    """(N,) int32 rank of each element within its run of equal sorted keys
    (the run's start only: one binary search)."""
    keys = sorted_keys.contiguous()
    idx = torch.arange(keys.shape[0], dtype=torch.int64, device=keys.device)
    return (idx - torch.searchsorted(keys, keys, right=False)).to(torch.int32)


def segment_extent(sorted_keys: torch.Tensor):
    """(rank, count) int32 of each element within its run of equal sorted keys.

    ``count`` is the run's TOTAL length — for cell-sorted particles, the
    cell's true occupancy including members past the slot budget."""
    idx, run_start, run_end = _run_bounds(sorted_keys)
    return ((idx - run_start).to(torch.int32),
            (run_end - run_start + 1).to(torch.int32))


def count_pairs(hi: torch.Tensor, lo: torch.Tensor, n_hi: int,
                n_lo: int) -> torch.Tensor:
    """(n_hi, n_lo) int64 occurrence counts of id pairs.

    The counterpart of the JAX package's ``count_pairs_mxu`` (a one-hot
    matrix product there), as an ``index_add_`` of ones into
    ``n_hi * n_lo + 1`` bins, the last a sentinel for ids outside
    ``[0, n_hi) x [0, n_lo)``, which count toward nothing. The output size
    is fixed, so nothing is read back from the device (``bincount`` reads
    the ids' maximum to size its output), and integer adds are exact."""
    hi = hi.to(torch.int64)
    lo = lo.to(torch.int64)
    ok = (hi >= 0) & (hi < n_hi) & (lo >= 0) & (lo < n_lo)
    flat = torch.where(ok, hi * n_lo + lo, n_hi * n_lo)
    counts = torch.zeros(n_hi * n_lo + 1, dtype=torch.int64, device=hi.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return counts[:n_hi * n_lo].reshape(n_hi, n_lo)
