"""The system under test: ``egg_fluid_simulation_tpu_torch``'s
``SimulationHandler``, built and driven through its public API, and what
the benchmark reads of it (its state, its counters). The only module of the
benchmark that imports the port."""

from __future__ import annotations

import torch

# the moving fields of a state (what the reference follows from) and the
# fields a spawn fixes (what the reference works out itself)
DYNAMIC = ("pos", "prev", "vel", "last_pos")
SPAWN = ("pos", "radius", "mass_t", "inv_mass", "batch_slot", "count",
         "batch_target", "batch_radius")
STATS = ("centroid", "last_centroid", "aabb_min", "aabb_max")


def port():
    import egg_fluid_simulation_tpu_torch as P
    return P


def build(cell_cfg: dict, specs: list, device):
    """A handler of the configuration with the scene's batches added:
    ``(handler, batch ids)``."""
    P = port()
    hd = cell_cfg["handler"]
    if (cell_cfg["white_config"], cell_cfg["yolk_config"]) != ("default",
                                                               "default"):
        raise ValueError("only the upstream default configs are known")
    if hd["options"] != "auto":
        raise ValueError("only the handler's automatic options are known")
    h = P.SimulationHandler(P.default_white_config(), P.default_yolk_config(),
                            capacity=hd["capacity"],
                            max_batches=hd["max_batches"],
                            jacobi_relaxation=hd["jacobi_relaxation"],
                            render_post_mode=hd["render_post_mode"],
                            device=device)
    return h, h.add_many(specs)


def snapshot(h, fields=DYNAMIC) -> dict:
    """Copies of the handler's state ``fields`` (on its device)."""
    st = h.state
    return {f: getattr(st, f).clone() for f in fields}


def stats(h) -> dict:
    return {f: getattr(h.stats, f).clone() for f in STATS}


def wide_state(h):
    """A copy of the wide-sweep gate's episode state, a moving part of the
    step's state the handler keeps privately (None before the first
    step)."""
    ws = h._wide_state
    if ws is None:
        return None
    return tuple(tuple(t.clone() for t in pop) for pop in ws)


def rebins(h) -> torch.Tensor:
    """(2,) int64 rebins (white, yolk) of the handler's resident loops so
    far, as a tensor on the handler's device without a read: the replayed
    loops' device counter on a card, the eager loop's count elsewhere."""
    from egg_fluid_simulation_tpu_torch.ops import solver
    graphs = h._resident_graphs()
    if graphs is None or graphs.rebins is None:
        if graphs is None:
            return torch.tensor(solver.rebins, dtype=torch.int64)
        return torch.zeros((2,), dtype=torch.int64, device=h.device)
    return graphs.rebins.to(torch.int64)          # a copy


def counters() -> dict:
    """The port's host-read counters: the render's reads (stats and
    audit) and the resident loops' reads of their rebin flag."""
    from egg_fluid_simulation_tpu_torch.ops import render, solver
    return {"host_reads": render.host_reads, "host_syncs": solver.host_syncs}


def graph_census(h) -> dict:
    """The CUDA graphs the handler holds, by cache: their count and a
    fingerprint of their identities (a graph made in the measured window
    changes it)."""
    out = {}
    caches = {"step": h._step_graphs, "render": h._render_graphs,
              "resident": h._resident,
              "final": getattr(h._resident, "final", None)}
    for name, cache in caches.items():
        gs = getattr(cache, "_graphs", None) or {}
        out[name] = [len(gs), hash(tuple(sorted(id(g) for g in gs.values())))]
    return out
