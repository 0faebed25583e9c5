"""Headless demo harness — the programmatic equivalent of the reference's demo.

Mirrors the reference's ``test.lua`` without a window: spawn/remove batches at
the viewport corners (the J/H keys, test.lua:136-170), drive every batch along
a randomized closed polygon path at 300 px/s (:223-261), hot-swap between the
solid-egg and low-damping "fluid" configs (the L key, :110-123), regenerate
the path (G, :165), and keep the same rolling performance window
(100 samples, :178-221). Frames render to numpy arrays (and optionally PNGs).

The counterpart of ``egg_fluid_simulation_tpu/demo.py``: the same session,
keys and random stream, so a seed gives the JAX demo's session. Frames are
drawn on the handler's device and read back as numpy arrays.

Run on the card: ``python -m egg_fluid_simulation_tpu_torch.demo --frames
120 --out DIR`` (``--device cpu`` runs the kernels' plain versions).
``--spatial DBxDX`` runs the session on a
:class:`~.parallel.spatial_handler.SpatialHandler` over a ``DB x DX`` mesh
of ranks: ``1x1`` alone, a larger mesh under ``torchrun --nproc-per-node
DB*DX`` (one rank a card with ``--device cuda``; gloo ranks on the CPU with
``--device cpu``); only rank 0 writes frames and prints. ``--spatial``
refuses ``--particle-color`` (the spatial draw has no per-particle
colour).
"""

from __future__ import annotations

import argparse
import math
import os
import random
import sys
from typing import List, Optional

import numpy as np

from . import config as config_mod
from .handler import SimulationHandler
from .parallel.spatial_handler import SpatialHandler
from .path import Path
from .utils.mathx import fract, wrap
from .utils.profiling import StepTimer

__all__ = ["DemoState", "run_demo"]

_COLORS = [  # the reference demo's yolk recolor cycle (test.lua:29-53)
    (0.0118, 0.8627, 0.1961, 1.0),   # green
    (1.0, 0.1137, 0.4667, 1.0),      # red
    (0.0706, 1.0, 0.7059, 1.0),      # mint
    (0.0, 0.6039, 0.9961, 1.0),      # blue
]


class DemoState:
    """Interactive-equivalent demo harness with programmatic 'keys'."""

    def __init__(self, width: int = 800, height: int = 600, seed: int = 0,
                 spatial=None, use_particle_color: bool = False,
                 **handler_kwargs):
        """A :class:`SimulationHandler` session; ``handler_kwargs`` go to
        the handler (``device``, ``capacity``, ...). ``spatial=(db, dx)``
        runs it on a :class:`SpatialHandler` over a ``db x dx`` mesh (same
        public API, sharded step and render; a mesh of more than one rank
        needs its process group). ``use_particle_color`` mirrors the
        reference demo's experimental per-particle rgb accumulation toggle
        (test.lua:26) — colors persist per particle at spawn/recolor time
        and ride the splat kernel's rgb accumulators."""
        self.width, self.height = width, height
        self.rng = random.Random(seed)
        handler_kwargs.setdefault("capacity", 8192)
        if spatial is not None:
            db, dx = spatial
            self.handler = SpatialHandler(config_mod.default_white_config(),
                                          config_mod.default_yolk_config(),
                                          db=db, dx=dx, **handler_kwargs)
        else:
            self.handler = SimulationHandler(config_mod.default_white_config(),
                                             config_mod.default_yolk_config(),
                                             **handler_kwargs)
        # the experimental toggle is a pre-spawn attribute poke in the
        # reference too (test.lua:26) — it must precede add() so spawn
        # colors materialize as per-particle arrays; a spatial handler's
        # flag is its inner handler's, and its draw refuses it
        target = self.handler._inner if spatial is not None else self.handler
        target._use_particle_color = bool(use_particle_color)
        # the reference demo shrinks particles before spawning (test.lua:56-66)
        self.handler.set_yolk_config({"min_radius": 0.5, "max_radius": 1.0})
        self.handler.set_white_config({"min_radius": 1.5, "max_radius": 2.0})
        self.solid_white = self.handler.get_white_config()
        self.solid_yolk = self.handler.get_yolk_config()
        self.current_config_solid = True

        self.batch_ids: List[int] = []
        self.color_i = 0
        self.elapsed = 0.0
        self.velocity = 300.0                    # px/s along the path
        self.path = Path([0.0, 0.0, 0.0, 0.0])
        self.regenerate_path()

        # the overlay's update time: CUDA events on a card (the step's
        # device time, not its enqueue), the host clock on the CPU
        self.timer = StepTimer(window=100, device=self.handler.device)

    # ------------------------------------------------------------- 'keys' --

    def spawn_batch(self) -> int:
        """The J key: spawn at the next viewport corner (test.lua:136-163)."""
        w, h = self.width, self.height
        corner = wrap(len(self.batch_ids), 4)
        x, y = [(0, 0), (w, 0), (w, h), (0, h)][corner - 1] if corner else (w / 2, h / 2)
        yolk_color = _COLORS[self.color_i % len(_COLORS)]
        self.color_i += 1
        bid = self.handler.add(float(x), float(y), 10.0, 3.0,
                               None, list(yolk_color), 20, 15)
        self.batch_ids.insert(0, bid)
        return bid

    def remove_batch(self) -> None:
        """The H key: remove the most recent batch (test.lua:165-170)."""
        if self.batch_ids:
            self.handler.remove(self.batch_ids.pop(0))

    def regenerate_path(self) -> None:
        """The G key: random closed polygon path (test.lua:243-262)."""
        w, h = self.width, self.height
        r = min(w, h) / 2.5
        n = self.rng.randint(3, 7)
        offset = self.rng.uniform(0, 2 * math.pi)
        points = []
        for i in range(n):
            angle = i / n * 2 * math.pi + offset
            points += [w / 2 + math.cos(angle) * r, h / 2 + math.sin(angle) * r]
        points += points[:2]
        self.path.create_from_and_reparameterize(points)

    def swap_config(self) -> None:
        """The L key: toggle solid egg <-> low-damping fluid (test.lua:110-123)."""
        if self.current_config_solid:
            fluid = config_mod.fluid_config()
            self.handler.set_white_config(dict(fluid))
            self.handler.set_yolk_config(dict(fluid))
        else:
            self.handler.set_white_config(self.solid_white)
            self.handler.set_yolk_config(self.solid_yolk)
        self.current_config_solid = not self.current_config_solid

    # -------------------------------------------------------------- frame --

    def target_position(self):
        t = fract(self.elapsed / max(self.path.get_length() / self.velocity, 1e-9))
        return self.path.at(t)

    def update(self, delta: float = 1 / 60) -> None:
        x, y = self.target_position()
        with self.timer.phase("update"):
            for bid in self.batch_ids:
                self.handler.set_target_position(bid, x, y)
            self.handler.update(delta)
        self.elapsed += delta

    def draw(self) -> np.ndarray:
        frame = self.handler.draw(viewport=(0.0, 0.0, self.width, self.height),
                                  background=(0.5, 0.5, 0.5, 1.0))
        return frame.cpu().numpy()

    def run(self, frames: int, out_dir: Optional[str] = None,
            spawn_every: int = 30, swap_at: int = 60,
            draw_every: Optional[int] = None) -> dict:
        """The scripted session of :func:`run_demo`: four batches, one more
        every ``spawn_every`` frames, the config swap at frame ``swap_at``;
        every ``draw_every``-th frame is drawn (default: every frame when
        ``out_dir`` is given, none otherwise) and written to ``out_dir``.
        Returns :meth:`overlay_stats`."""
        if draw_every is None:
            draw_every = 1 if out_dir is not None else 0
        for _ in range(4):
            self.spawn_batch()
        for f in range(frames):
            if spawn_every and f and f % spawn_every == 0:
                self.spawn_batch()
            if f == swap_at:
                self.swap_config()
            self.update(1 / 60)
            if draw_every and f % draw_every == 0:
                frame = self.draw()
                if out_dir is not None:
                    _save_png(frame, f"{out_dir}/frame_{f:04d}.png")
        return self.overlay_stats()

    def overlay_stats(self) -> dict:
        """The demo's FPS / particle / frame-usage overlay (test.lua:198-221):
        the mean of the last 100 updates' times (on a card this waits for
        their events)."""
        w, y = self.handler.get_n_particles()
        ms = self.timer.samples("update") or [0.0]
        mean_ms = sum(ms) / len(ms)
        return {"n_particles": w + y,
                "mean_update_ms": mean_ms,
                "frame_usage_pct": mean_ms / (1000 / 60) * 100}


def run_demo(frames: int = 120, out_dir: Optional[str] = None, seed: int = 0,
             spawn_every: int = 30, swap_at: int = 60, spatial=None,
             draw_every: Optional[int] = None, **demo_kwargs) -> dict:
    """Scripted session: spawn batches, drag along the path, config-swap;
    ``demo_kwargs`` go to :class:`DemoState`, the rest to
    :meth:`DemoState.run`."""
    demo = DemoState(seed=seed, spatial=spatial, **demo_kwargs)
    return demo.run(frames, out_dir, spawn_every, swap_at, draw_every)


def _save_png(frame: np.ndarray, path: str) -> None:
    rgb = (np.clip(frame[..., :3], 0, 1) * 255).astype(np.uint8)
    try:
        from PIL import Image
        Image.fromarray(rgb).save(path)
    except ImportError:  # minimal fallback writer
        import struct, zlib

        h, w, _ = rgb.shape
        raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

        def chunk(tag, data):
            c = tag + data
            return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

        with open(path, "wb") as fh:
            fh.write(b"\x89PNG\r\n\x1a\n")
            fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
            fh.write(chunk(b"IDAT", zlib.compress(raw)))
            fh.write(chunk(b"IEND", b""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", type=str, default=None, help="PNG output directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--capacity", type=int, default=8192,
                    help="particle capacity (below 16384: the gather engine)")
    ap.add_argument("--particle-color", action="store_true",
                    help="per-particle rgb accumulation (the reference "
                         "demo's experimental mode, test.lua:25-67)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the simulation (default cuda)")
    ap.add_argument("--spatial", type=str, default=None, metavar="DBxDX",
                    help="run on a DB x DX spatial mesh of ranks (e.g. 2x2); "
                         "more than one rank: under torchrun "
                         "--nproc-per-node DB*DX")
    args = ap.parse_args(argv)
    spatial, lead = None, True
    if args.spatial:
        if args.particle_color:
            raise SystemExit("--particle-color is not supported with "
                             "--spatial: the spatial draw has no "
                             "per-particle colour")
        db, dx = (int(v) for v in args.spatial.lower().split("x"))
        spatial = (db, dx)
        if db * dx > 1:
            world = int(os.environ.get("WORLD_SIZE", "1"))
            if world != db * dx:
                raise SystemExit(
                    f"--spatial {args.spatial} needs {db * dx} ranks: run "
                    f"it under torchrun --nproc-per-node {db * dx} (this "
                    f"process group has {world})")
            from .parallel.mesh import init_from_env
            init_from_env(args.device)
            lead = int(os.environ.get("RANK", "0")) == 0
    out_dir = args.out if lead else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    stats = run_demo(frames=args.frames, out_dir=out_dir, seed=args.seed,
                     spatial=spatial, capacity=args.capacity,
                     device=args.device,
                     use_particle_color=args.particle_color,
                     draw_every=1 if args.out else None)
    if lead:
        print(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
