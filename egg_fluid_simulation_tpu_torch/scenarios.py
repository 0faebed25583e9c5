"""The five baseline scenarios (``BASELINE.json`` "configs"), at the sizes of
``tests/test_baseline_scenarios.py``, as calls any ``SimulationHandler``
takes: this package's on a card or the CPU, or the JAX package's, so two
handlers built from one :class:`Scenario` take the same calls.

1. one egg batch (white r = 50 px, yolk r = 15 px), static target, 60
   updates;
2. 16 spread-out batches whose targets follow a square ``Path``, 90
   updates;
3. 8 overlapping batches pulled to one point (dense pair load), 60 updates;
4. parameter extremes, one batch pulled to (80, 40), 90 updates: ``4a``
   damping 0.01, ``4b`` cohesion 1.0 at 3x reach, ``4c`` masses 0.02-1.0;
5. 64 small batches on an 8 x 8 grid, 5 frames of ``update`` + ``draw`` at
   a 720 x 720 viewport.

Every baseline scenario runs on the handler's automatic options: the
gather engine with the ordered budget (capacities below 16384).

The dense scenes (:data:`DENSE_SCENES`, :data:`BENCH_SCENES`) run the main
path, the dense engine's fused step (kernels A and B):

- ``dense_16k``: the smallest handler whose automatic options take the
  dense engine, ``SimulationHandler(white, yolk, capacity=16384)`` (G (128,
  64), K 4, budget off, ``wide_budget_substeps`` 240, one binning a step),
  with 6 batches of 2000 white + 200 yolk on a 3 x 2 grid 260 px apart:
  each batch spawns at ~9 times its settled density, so the violence gate
  trips through the spawn transient;
- ``bench_65k``: the bench's ``--quick`` scene at 65,536 whites
  (``bench.build_handler(65_536, wide_default=True)``, the options of
  ``step_ms_1m_default_opts``), from its spawn;
- ``headline_1m``: the bench's headline scene, ``bench.build_handler(
  1_000_000)`` (the wide sweep statically off), settled ``bench.SETTLE`` =
  120 steps, as ``step_ms_1m`` and ``update_ms_1m`` time it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from .path import Path

__all__ = ["Scenario", "SCENARIOS", "DENSE_SCENES", "BenchScene",
           "BENCH_SCENES", "build", "build_bench", "config5_centres"]

VIEWPORT_5 = (0.0, 0.0, 720, 720)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One baseline configuration: the constructor's keywords, config
    overrides (applied to white and yolk alike), the ``add`` calls, the
    static targets set after them, the updates (``steps``; ``frames`` of
    update + draw at ``viewport``), and ``drive(h, ids, i)``, called before
    update ``i``."""
    name: str
    capacity: int
    max_batches: int
    adds: Tuple[tuple, ...]
    steps: int
    overrides: Optional[Dict] = None
    target: Optional[Tuple[float, float]] = None
    drive: Optional[Callable] = None
    frames: int = 0
    viewport: Optional[Tuple[float, float, int, int]] = None


def _square_path() -> Path:
    path = Path([0.0, 0.0, 600.0, 0.0, 600.0, 600.0, 0.0, 600.0, 0.0, 0.0])
    path.create_from_and_reparameterize(path.get_points())
    return path


def _path_times(n: int) -> List[float]:
    """The phase of each update, accumulated as the test file does."""
    out, t = [], 0.0
    for _ in range(n):
        t = (t + 1 / 90) % 1.0
        out.append(t)
    return out


_PATH = _square_path()
_TIMES = _path_times(90)


def _drive_path(h, ids: List[int], i: int) -> None:
    """Config 2: batch ``j`` follows the square at phase ``t + j / 16``."""
    for j, bid in enumerate(ids):
        x, y = _PATH.at((_TIMES[i] + j / 16) % 1.0)
        h.set_target_position(bid, x, y)


def config5_centres() -> List[Tuple[float, float]]:
    return [((i % 8) * 80.0 + 40.0, (i // 8) * 80.0 + 40.0)
            for i in range(64)]


SCENARIOS: Dict[str, Scenario] = {
    "1": Scenario("1", 4096, 64, ((100.0, 100.0, 50.0, 15.0),), 60),
    "2": Scenario("2", 8192, 64,
                  tuple(((i % 4) * 200.0, (i // 4) * 200.0, 20.0, 6.0, None,
                         None, 25, 6) for i in range(16)),
                  90, drive=_drive_path),
    "3": Scenario("3", 4096, 64,
                  tuple((10.0 * i, 0.0, 25.0, 8.0, None, None, 40, 8)
                        for i in range(8)),
                  60, target=(0.0, 0.0)),
    "4a": Scenario("4a", 2048, 8, ((0.0, 0.0, 25.0, 8.0, None, None, 40, 10),),
                   90, overrides={"damping": 0.01}, target=(80.0, 40.0)),
    "4b": Scenario("4b", 2048, 8, ((0.0, 0.0, 25.0, 8.0, None, None, 40, 10),),
                   90, overrides={"cohesion_strength": 1.0,
                                  "cohesion_interaction_distance_factor": 3.0},
                   target=(80.0, 40.0)),
    "4c": Scenario("4c", 2048, 8, ((0.0, 0.0, 25.0, 8.0, None, None, 40, 10),),
                   90, overrides={"min_mass": 0.02, "max_mass": 1.0},
                   target=(80.0, 40.0)),
    "5": Scenario("5", 8192, 64,
                  tuple((x, y, 8.0, 2.5, None, None, 8, 2)
                        for x, y in config5_centres()),
                  0, frames=5, viewport=VIEWPORT_5),
}


def build(sc: Scenario, package, **kw):
    """A ``package.SimulationHandler`` (this package or the JAX one) set up
    as ``sc`` says, and its batch ids. ``kw`` goes to the constructor (this
    package's ``device``)."""
    white, yolk = package.default_white_config(), package.default_yolk_config()
    white.update(sc.overrides or {})
    yolk.update(sc.overrides or {})
    h = package.SimulationHandler(white, yolk, capacity=sc.capacity,
                                  max_batches=sc.max_batches, **kw)
    ids = [h.add(*args) for args in sc.adds]
    if sc.target is not None:
        for bid in ids:
            h.set_target_position(bid, *sc.target)
    return h, ids


DENSE_SCENES: Dict[str, Scenario] = {
    "dense_16k": Scenario(
        "dense_16k", 16384, 256,
        tuple((200.0 + 260.0 * (i % 3), 200.0 + 260.0 * (i // 3), None, None,
               None, None, 2000, 200) for i in range(6)),
        20),
}


@dataclasses.dataclass(frozen=True)
class BenchScene:
    """A scene of this package's bench (``bench.build_handler``): the
    whites asked for, whether the wide sweep keeps its default budget, the
    steps it is settled before use and where the bench reads it."""
    name: str
    n_white: int
    wide_default: bool
    settle: int
    source: str


BENCH_SCENES: Dict[str, BenchScene] = {
    "bench_65k": BenchScene("bench_65k", 65_536, True, 0,
                            "bench.py --quick scene at 65,536 whites, the "
                            "options of step_ms_1m_default_opts"),
    "headline_1m": BenchScene("headline_1m", 1_000_000, False, 120,
                              "bench.py step_ms_1m / update_ms_1m scene, "
                              "settled bench.SETTLE steps"),
}


def build_bench(sc: BenchScene, device):
    """``sc``'s handler on ``device``, settled through ``run_steps``."""
    from .bench import build_handler
    h = build_handler(sc.n_white, device, wide_default=sc.wide_default)
    if sc.settle:
        h.run_steps(sc.settle)
    return h
