"""The device mesh of the multi-device layers, on ``torch.distributed``.

The counterpart of the JAX package's ``jax.sharding.Mesh`` use in
``parallel/sharding.py`` (``make_mesh``) and ``parallel/spatial.py``
(``make_spatial_mesh``), and of ``parallel/_compat.py`` (its ``shard_map``
shim has no counterpart: the port is SPMD by construction). One process per
rank; every rank runs the same host calls, so replicated bookkeeping stays
equal everywhere. A mesh is a grid of ranks, rank ``b * dx + x`` at
coordinates ``(b, x)`` (the JAX package's device ``b * Dx + x``).

The collectives, as ``shard_map`` bodies use them there:

- :meth:`Mesh.ring_shift` (``lax.ppermute`` by a ring shift along one axis):
  ``dist.batch_isend_irecv`` on the axis group. On a one-rank axis it is a
  copy and no collective, as ``ppermute`` degenerates to a self-copy there;
  that is what lets a 1 x 1 mesh run on one card;
- :meth:`Mesh.psum` / :meth:`Mesh.pmax` / :meth:`Mesh.pmin` over the whole
  mesh: ``dist.all_reduce`` (nothing on a one-rank mesh);
- :meth:`Mesh.all_gather` along the particle axis of a 1D mesh:
  ``dist.all_gather_into_tensor``.

Every collective adds the bytes this rank sends to a per-category counter
(:class:`CollectiveCounter`, read by :mod:`.accounting`): a ring shift its
payload, an all-reduce or an all-gather its contribution (a replayed graph
adds the tally of its warm-up, :mod:`.spatial_graph`, :mod:`.sharding_graph`).

Backends: NCCL for CUDA tensors, gloo for CPU tensors. A mesh of more than
one rank needs a process group of exactly its size (``torchrun`` sets one
up from the environment, :func:`init_from_env`); it never falls back to
one rank. A 1 x 1 mesh starts a one-rank group in the process when none is
running (:func:`init_single_rank`: an in-memory store, no network).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import tempfile
import time
from typing import Dict, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["Mesh", "CollectiveCounter", "make_mesh", "make_spatial_mesh",
           "init_single_rank", "init_from_env", "backend_for", "spawn_ranks",
           "BANDS", "BLOCKS", "PARTICLES", "CAPTURE_ERROR_MODE"]

BANDS = "bands"          # spatial mesh axis 0: grid rows (y)
BLOCKS = "blocks"        # spatial mesh axis 1: lane groups (x)
PARTICLES = "particles"  # the 1D particle-sharded mesh

GROUP_TIMEOUT_S = 60.0   # a collective's longest wait on a peer
# the capture mode of a CUDA graph that may hold NCCL work: the process
# group's watchdog thread queries events while another thread captures
CAPTURE_ERROR_MODE = "thread_local"


class CollectiveCounter:
    """Bytes this rank sent, per category (``add`` at every call site)."""

    def __init__(self):
        self.bytes: Dict[str, int] = {}

    def add(self, category: str, nbytes: int) -> None:
        self.bytes[category] = self.bytes.get(category, 0) + int(nbytes)

    def add_all(self, counts: Dict[str, int]) -> None:
        for category, nbytes in counts.items():
            self.add(category, nbytes)

    def reset(self) -> None:
        self.bytes = {}

    def snapshot(self) -> Dict[str, int]:
        return dict(self.bytes)

    def restore(self, snapshot: Dict[str, int]) -> None:
        self.bytes = dict(snapshot)

    def since(self, snapshot: Dict[str, int]) -> Dict[str, int]:
        """The bytes added since ``snapshot``, per category that moved."""
        return {k: v - snapshot.get(k, 0) for k, v in self.bytes.items()
                if v != snapshot.get(k, 0)}

    @contextlib.contextmanager
    def uncounted(self):
        """The adds inside are dropped; yields the dict that receives what
        they added (:meth:`since`) when the block ends: how a captured
        graph's bytes are tallied once and added at each replay."""
        before = self.snapshot()
        diff = {}
        try:
            yield diff
        finally:
            diff.update(self.since(before))
            self.restore(before)


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_single_rank(device) -> None:
    """Start a one-rank process group in this process when none runs (an
    in-memory ``HashStore``: no network, no ``torchrun``)."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(
                                seconds=GROUP_TIMEOUT_S))


def init_from_env(device) -> None:
    """Join the process group ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) when none
    runs yet."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """This rank's view of a mesh of ranks: its shape, axis names, its
    coordinates, the axis groups and the device its tensors live on."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device):
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.size = 1
        for s in self.shape:
            self.size *= s
        self.device = torch.device(device)
        self.counter = CollectiveCounter()
        if not dist.is_initialized():
            if self.size != 1:
                raise RuntimeError(
                    f"a {'x'.join(map(str, self.shape))} mesh needs a process "
                    f"group of {self.size} ranks and none is running: start "
                    f"the program under torchrun --nproc-per-node "
                    f"{self.size} (or init_process_group it)")
            init_single_rank(self.device)
        world = dist.get_world_size()
        if world != self.size:
            raise RuntimeError(
                f"a {'x'.join(map(str, self.shape))} mesh needs a process "
                f"group of {self.size} ranks; the running one has {world}")
        self.rank = dist.get_rank()
        coords, r = [], self.rank
        for s in reversed(self.shape):
            coords.append(r % s)
            r //= s
        self.coords: Tuple[int, ...] = tuple(reversed(coords))
        # one group per axis through this rank; every rank creates every
        # group, in the same order, as new_group requires
        self._axis_ranks, self._groups = {}, {}
        for a, name in enumerate(self.axis_names):
            if self.shape[a] == 1:
                continue
            for line in self._lines(a):
                group = dist.new_group(line)
                if self.rank in line:
                    self._axis_ranks[name] = line
                    self._groups[name] = group

    def _lines(self, axis: int):
        """Every line of ranks along ``axis`` (the other coordinates fixed),
        in row-major order of the fixed coordinates."""
        strides = [1] * len(self.shape)
        for a in range(len(self.shape) - 2, -1, -1):
            strides[a] = strides[a + 1] * self.shape[a + 1]
        others = [a for a in range(len(self.shape)) if a != axis]
        lines = []
        n_fixed = self.size // self.shape[axis]
        for f in range(n_fixed):
            base, rem = 0, f
            for a in reversed(others):
                base += (rem % self.shape[a]) * strides[a]
                rem //= self.shape[a]
            lines.append([base + i * strides[axis]
                          for i in range(self.shape[axis])])
        return lines

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]

    # ------------------------------------------------------ collectives --

    def ring_shift(self, t: torch.Tensor, axis: str, shift: int,
                   category: str) -> torch.Tensor:
        """The tensor sent by the rank ``shift`` places before this one on
        the ring of ``axis``; this rank's ``t`` goes ``shift`` places on
        (``ppermute`` with ``(i, (i + shift) % size)`` pairs). A copy on a
        one-rank axis."""
        size = self.axis_size(axis)
        if size == 1:
            return t.clone()
        line = self._axis_ranks[axis]
        i = self.axis_index(axis)
        send = t.contiguous()
        recv = torch.empty_like(send)
        group = self._groups[axis]
        ops = [dist.P2POp(dist.isend, send, line[(i + shift) % size], group),
               dist.P2POp(dist.irecv, recv, line[(i - shift) % size], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.counter.add(category, _nbytes(send))
        return recv

    def _all_reduce(self, t: torch.Tensor, op, category: str) -> torch.Tensor:
        if self.size == 1:
            return t
        t = t.contiguous().clone()
        dist.all_reduce(t, op=op)
        self.counter.add(category, _nbytes(t))
        return t

    def psum(self, t: torch.Tensor, category: str = "reductions"):
        """Sum over every rank of the mesh (``psum`` over all its axes)."""
        return self._all_reduce(t, dist.ReduceOp.SUM, category)

    def pmax(self, t: torch.Tensor, category: str = "reductions"):
        return self._all_reduce(t, dist.ReduceOp.MAX, category)

    def pmin(self, t: torch.Tensor, category: str = "reductions"):
        return self._all_reduce(t, dist.ReduceOp.MIN, category)

    def all_gather(self, t: torch.Tensor, category: str) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order
        (``all_gather(..., tiled=True)`` over the whole mesh)."""
        if self.size == 1:
            return t
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
        self.counter.add(category, _nbytes(t))
        return out


def make_mesh(device) -> Mesh:
    """1D mesh over every rank of the running group (one rank when none
    runs), the particle-sharded axis (JAX ``sharding.make_mesh``)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return Mesh((n,), (PARTICLES,), _rank_device(device))


def make_spatial_mesh(db: int, dx: int = 1, device="cuda") -> Mesh:
    """``(bands, blocks)`` mesh of ``db * dx`` ranks (JAX
    ``spatial.make_spatial_mesh``)."""
    return Mesh((db, dx), (BANDS, BLOCKS), _rank_device(device))


def _rank_device(device) -> torch.device:
    """``device``, a CUDA one without an index being the card of this
    rank's local rank (``LOCAL_RANK``, as ``torchrun`` and
    :func:`spawn_ranks` set it)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def _rank_entry(rank: int, fn, n_ranks: int, store_path: str, device: str,
                timeout_s: float, args) -> None:
    """A spawned rank: join the group through the file store, run
    ``fn(*args)``, leave the group."""
    device = torch.device(device)
    os.environ["LOCAL_RANK"] = str(rank)
    if device.type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group(
        backend_for(device), store=dist.FileStore(store_path, n_ranks),
        rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, args, n_ranks: int, device: str,
                timeout_s: float = 300.0,
                group_timeout_s: float = GROUP_TIMEOUT_S):
    """Run ``fn(*args)`` on ``n_ranks`` spawned ranks of one process group
    (a ``FileStore`` in a fresh temporary directory: no network; gloo for
    ``device="cpu"``, NCCL and one card a rank for ``"cuda"``). ``fn`` must
    be importable by name. Raises if a rank fails, and kills every rank and
    raises ``TimeoutError`` if they have not all ended after ``timeout_s``
    seconds."""
    import torch.multiprocessing as mp
    if torch.device(device).type == "cuda" and \
            n_ranks > torch.cuda.device_count():
        raise RuntimeError(f"{n_ranks} NCCL ranks need {n_ranks} cards; this "
                           f"machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_entry,
            args=(fn, n_ranks, os.path.join(tmp, "store"), str(device),
                  group_timeout_s, tuple(args)),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks still running after "
                                       f"{timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
