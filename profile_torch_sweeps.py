#!/usr/bin/env python3
"""Kernels B (``substep_pass``) and D (``sweep_planes``) build against
build, and the steps that run them, on one card.

    python3 profile_torch_sweeps.py [--baseline-csrc DIR] [--n 6] [--blocks 2]

Builds of the kernel library compared in one process, in turns:

- ``tiled``: the package's ``csrc/`` as it stands (shared-memory tiles, the
  list of occupied slots);
- ``staged_only``: the same sources with ``-DEGG_SWEEP_NO_COMPACT`` (tiles
  staged, every slot walked: what staging alone buys);
- ``baseline``: the sources under ``--baseline-csrc`` (for instance another
  commit's ``csrc/``, unpacked with ``git archive``), where given. The C
  entry points must have the package's signatures.

Phase ``kernel``: on the 1M-white scene of ``chip_smoke.build_handler``
(white G=768, yolk G=512, K=4), the time of one launch of B (window 1 with
and without ``integrate``, window 3, and window 1 through the device flag)
and of D (window 1 with and without the ordered cutoff, window 3, and the
flag) per population and build: CUDA events around 20 launches, builds in
the order given and then reversed. Every build's output is compared with
the first's (``max_abs_diff``).

Phase ``step``: ``update(1/60)`` of the fused handler (budget off: 12 B per
step) and of the ordered-budget handler (plane-resident step, default gate:
12 D per step) in blocks of ``--n`` steps per build, alternating (first to
last, then reversed), host clock around work that ends in a synchronise;
then one block per build under ``utils.profiling.trace`` for the device
time (sum of kernel events), the kernel count and the two sweeps' share.
The builds compute the same bits, so the scene's trajectory does not depend
on the order; but the scene moves on from block to block, and on the plane
handler the violence gate decides per substep whether the wide window runs
(``wide_state``, printed with every block), so two blocks of the plane step
compare only as far as their wide windows ran alike.

Prints one JSON object per line, the card's name and power limit last.
Needs a CUDA card (exits 1 without one).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--blocks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    from egg_fluid_simulation_tpu_torch.utils.profiling import trace

    card = C.nvidia_smi()
    dev = torch.device("cuda", 0)
    builds = {"tiled": library.open_build(),
              "staged_only": library.open_build(
                  extra_flags=["-DEGG_SWEEP_NO_COMPACT"])}
    if args.baseline_csrc:
        builds["baseline"] = library.open_build(csrc=args.baseline_csrc)
    print(json.dumps({"builds": list(builds), "card": card,
                      "torch": torch.__version__}), flush=True)

    h = C.build_handler(C.N_WHITE, dev)
    hp = C.build_handler(C.N_WHITE, dev, wide_default=True,
                         budget_mode="ordered")
    torch.cuda.synchronize()

    # ---- phase kernel ----
    cases = {}
    library.use(builds["tiled"])
    ordered_planes = C.check_count(hp, {})
    for pop, name in ((0, "white"), (1, "yolk")):
        p = C.population_inputs(h, pop, C.SEED + pop)
        xy, prev, stat, follow, _ = S._bin_components(
            p["pos"], p["vel"], p["inv_mass"], p["radius"], p["batch"],
            p["act"], p["cell_size"], p["tx"], p["ty"], p["td"], p["sub_dt"],
            p["g"], p["k"])
        b_args = (xy, stat, p["params"], p["aux"], p["k"])
        integ = dict(cohesion=True, integrate=True, prev=prev, follow=follow)
        narrow = torch.tensor(False, device=dev)
        for case, kw in (
                ("w1_integrate", dict(integ, window=1)),
                ("w1", dict(cohesion=True, window=1)),
                ("w3_integrate", dict(integ, window=3, fresh_mask=True)),
                ("w1_flag_integrate", dict(integ, wide=narrow))):
            cases[f"B.{name}.{case}"] = (
                lambda a=b_args, kw=kw: SK.substep_pass(*a, **kw))
        q, planes, cum_max = ordered_planes[pop]
        params = q["params"].clone()
        params[4] = 0.5 * cum_max              # the cutoff binds for half
        d_args = (planes, params, q["k"])
        for case, kw in (
                ("w1_ordered", dict(ordered_budget=True, window=1)),
                ("w1", dict(ordered_budget=False, window=1)),
                ("w3_ordered", dict(ordered_budget=True, window=3,
                                    fresh_mask=True)),
                ("w1_flag_ordered", dict(ordered_budget=True, wide=narrow))):
            cases[f"D.{name}.{case}"] = (
                lambda a=d_args, kw=kw: SK.sweep_planes(*a, cohesion=True,
                                                        **kw))
    ms = {c: {b: [] for b in builds} for c in cases}
    diff = {c: {} for c in cases}
    for order in (list(builds), list(builds)[::-1]):
        for b in order:
            library.use(builds[b])
            for c, fn in cases.items():
                ms[c][b].append(C.cuda_ms(fn, 20, 2))
    for c, fn in cases.items():
        outs = {}
        for b in builds:
            library.use(builds[b])
            out = fn()
            outs[b] = torch.cat([o.reshape(-1) for o in
                                 (out if isinstance(out, tuple) else (out,))])
        first = outs[next(iter(builds))]
        diff[c] = {b: float((o - first).abs().max()) for b, o in outs.items()}
    for c in cases:
        print(json.dumps({"phase": "kernel", "case": c,
                          "ms": {b: min(v) for b, v in ms[c].items()},
                          "all_ms": ms[c], "max_abs_diff": diff[c]}),
              flush=True)

    # ---- phase step ----
    timed = [b for b in builds if b != "staged_only"]
    handlers = {"update_fused": h, "update_plane": hp}
    n = args.n
    for hh in handlers.values():                   # first-use costs
        hh.update(1 / 60)
    torch.cuda.synchronize()
    wall = {m: {b: [] for b in timed} for m in handlers}
    for blk in range(args.blocks):
        for b in (timed if blk % 2 == 0 else timed[::-1]):
            library.use(builds[b])
            for m, hh in handlers.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    hh.update(1 / 60)
                torch.cuda.synchronize()
                wall[m][b].append((time.perf_counter() - t0) * 1e3 / n)
                print(json.dumps({
                    "phase": "step", "block": blk, "mode": m, "build": b,
                    "wall_ms_per_step": wall[m][b][-1],
                    "wide_state": [[int(v) for v in w]
                                   for w in hh._wide_or_init()]}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for b in timed:
            library.use(builds[b])
            for m, hh in handlers.items():
                profiled(m, b, hh, n, f"{tmp}/{m}_{b}", trace)
    library.use(builds["tiled"])
    print(json.dumps({"phase": "step", "summary": {
        m: {b: {"p50_ms": statistics.median(v), "all": v}
            for b, v in per.items()} for m, per in wall.items()}}), flush=True)
    print(card, flush=True)
    return 0


def profiled(mode: str, build: str, handler, n: int, trace_dir: str,
             trace) -> None:
    """One block of ``n`` updates under ``trace``: device ms, kernels and the
    sweeps' device ms per step."""
    import torch
    torch.cuda.synchronize()
    with trace(trace_dir) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            handler.update(1 / 60)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    sweeps = {e.key: (e.device_time_total / 1e3 / n, e.count / n)
              for e in prof.key_averages()
              if "substep_pass_kernel" in e.key
              or "sweep_planes_kernel" in e.key}
    print(json.dumps({
        "phase": "step", "mode": mode, "build": build,
        "profiled_wall_ms_per_step": wall / n,
        "device_ms_per_step": dev_ms / n,
        "kernels_per_step": len(kernels) / n,
        "sweep_kernels_ms_and_count_per_step": sweeps,
        "wide_state": [[int(v) for v in w]
                       for w in handler._wide_or_init()]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
