#!/usr/bin/env python3
"""The hand-written sweeps (kernels B ``substep_pass``, D ``sweep_planes``,
E its symmetric form) and the render splat (kernel C) build against build,
and the steps and frames that run them, on one card.

    python3 profile_torch_sweeps.py [--baseline-csrc DIR] [--n 6] [--blocks 2]

Builds of the kernel library compared in one process, in turns:

- ``tree``: the package's ``csrc/`` as it stands;
- ``baseline``: the sources under ``--baseline-csrc`` (for instance another
  commit's ``csrc/``, unpacked with ``git archive``), where given. The C
  entry points must have the package's signatures;
- ablation builds of the tree, each one ``-D`` flag (``ABLATIONS``): the
  sweeps' tiles staged without the list of occupied slots; kernel E without
  its partner-side adds (the pair arithmetic alone: wrong sums) and without
  its pair loop (listing, staging, memset and flush alone: wrong sums);
  kernel C without its cull and without its evaluation (staging alone:
  wrong output).

Phase ``kernel``: on the 1M-white scene of ``chip_smoke.build_handler``
(white G=768, yolk G=512, K=4), the time of one call of each kernel's
wrapper per population and build (for E that is the memset of the output
and the kernel): B at window 1 with and without ``integrate``, window 3,
and window 1 through the device flag; D and E at window 1 with and without
the ordered cutoff, window 3, and both windows through the flag; C on the
white and yolk render payloads, alpha and rgb. CUDA events around 20 calls,
builds in the order given and then reversed; the least of the two is
``ms``. Every build's output is compared with the first's
(``max_abs_diff``).

Phase ``step``: ``update(1/60)`` of the fused handler (budget off: 12 B per
step), of the ordered-budget handler (plane-resident step, default gate: 12
D per step), of the same with ``sweep_symmetric`` (12 E per step), and
``update`` + ``draw`` of a 2560 px viewport on the fused handler (2 C per
draw), in blocks of ``--n`` per build, alternating (first to last, then
reversed), host clock around work that ends in a synchronise; then one
block per build under ``utils.profiling.trace`` for the device time (sum of
kernel events), the kernel count and the four kernels' share. The builds
compute the same bits (E to rounding), so the scene's trajectory hardly
depends on the order; but the scene moves on from block to block, and on
the plane handlers the violence gate decides per substep whether the wide
window runs (``wide_state``, printed with every block), so two blocks of a
plane step compare only as far as their wide windows ran alike.

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

# build name -> (nvcc flag, the kernels it changes)
ABLATIONS = {
    "staged_only": ("-DEGG_SWEEP_NO_COMPACT", "BDE"),
    "sym_no_push": ("-DEGG_SYM_NO_PUSH", "E"),
    "sym_no_walk": ("-DEGG_SYM_NO_WALK", "E"),
    "splat_no_cull": ("-DEGG_SPLAT_NO_CULL", "C"),
    "splat_no_eval": ("-DEGG_SPLAT_NO_EVAL", "C"),
}
KERNEL_NAMES = ("substep_pass_kernel", "sweep_planes_kernel",
                "sweep_planes_sym_kernel", "splat_kernel")


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
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    from egg_fluid_simulation_tpu_torch.utils.profiling import trace

    card = C.nvidia_smi()
    dev = torch.device("cuda", 0)
    builds = {"tree": library.open_build()}
    resources = {"tree": library.kernel_resources()}
    changes = {"tree": "BCDE"}
    for name, (flag, kernels) in ABLATIONS.items():
        builds[name] = library.open_build(extra_flags=[flag])
        resources[name] = library.kernel_resources()
        changes[name] = kernels
    if args.baseline_csrc:
        builds["baseline"] = library.open_build(csrc=args.baseline_csrc)
        resources["baseline"] = library.kernel_resources()
        changes["baseline"] = "BCDE"
    print(json.dumps({"builds": list(builds), "card": card,
                      "torch": torch.__version__}), flush=True)
    for name, res in resources.items():
        print(json.dumps({"build": name, "ptxas": {
            k: f"{r['registers']} regs, {r['spill_bytes']} B spilled"
            for k, r in sorted(res.items())
            if any(k.startswith(n) for n in KERNEL_NAMES)}}), flush=True)

    h = C.build_handler(C.N_WHITE, dev)
    hp = C.build_handler(C.N_WHITE, dev, wide_default=True,
                         budget_mode="ordered")
    hs = C.build_handler(C.N_WHITE, dev, wide_default=True,
                         budget_mode="ordered", sweep_symmetric=True)
    for hh in (h, hp, hs):
        hh.seed_render_budget()
    torch.cuda.synchronize()

    # ---- phase kernel ----
    cases = {}
    library.use(builds["tree"])
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
        wide = torch.tensor(True, device=dev)
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
                ("w1_flag_ordered", dict(ordered_budget=True, wide=narrow)),
                ("w3_flag_ordered", dict(ordered_budget=True, wide=wide))):
            for kernel, sym in (("D", False), ("E", True)):
                cases[f"{kernel}.{name}.{case}"] = (
                    lambda a=d_args, kw=kw, sym=sym: SK.sweep_planes(
                        *a, cohesion=True, symmetric=sym, **kw))
        for use_rgb in (False, True):
            payload, counts, opts, _ = C.splat_case(h, pop, "coarse", use_rgb)
            cases[f"C.{name}.{'rgb' if use_rgb else 'alpha'}"] = (
                lambda a=(payload, counts, opts, use_rgb): SPK.splat(*a))
    on = {c: [b for b in builds if c[0] in changes[b]] for c in cases}
    ms = {c: {b: [] for b in on[c]} for c in cases}
    diff = {c: {} for c in cases}
    for order in (list(builds), list(builds)[::-1]):
        for b in order:
            library.use(builds[b])
            for c, fn in cases.items():
                if b in on[c]:
                    ms[c][b].append(C.cuda_ms(fn, 20, 2))
    for c, fn in cases.items():
        outs = {}
        for b in on[c]:
            library.use(builds[b])
            out = fn()
            outs[b] = torch.cat([o.reshape(-1) for o in
                                 (out if isinstance(out, tuple) else (out,))
                                 if o is not None])
        first = outs["tree"]
        diff[c] = {b: float((o - first).abs().max()) for b, o in outs.items()}
    for c in cases:
        print(json.dumps({"phase": "kernel", "case": c,
                          "ms": {b: min(v) for b, v in ms[c].items()},
                          "all_ms": ms[c], "max_abs_diff": diff[c]}),
              flush=True)

    # ---- phase step ----
    timed = [b for b in ("tree", "baseline") if b in builds]
    viewport = (0, 0, 2560, 2560)

    def frame():
        h.update(1 / 60)
        h.draw(viewport=viewport)

    modes = {"update_fused": (h, lambda: h.update(1 / 60)),
             "update_plane": (hp, lambda: hp.update(1 / 60)),
             "update_symmetric": (hs, lambda: hs.update(1 / 60)),
             "update_draw_fused": (h, frame)}
    n = args.n
    for _, fn in modes.values():                   # first-use costs
        fn()
    torch.cuda.synchronize()
    wall = {m: {b: [] for b in timed} for m in modes}
    for blk in range(args.blocks):
        for b in (timed if blk % 2 == 0 else timed[::-1]):
            library.use(builds[b])
            for m, (hh, fn) in modes.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
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
            for m, (hh, fn) in modes.items():
                profiled(m, b, hh, fn, n, f"{tmp}/{m}_{b}", trace)
    library.use(builds["tree"])
    print(json.dumps({"phase": "step", "summary": {
        m: {b: {"p50_ms": statistics.median(v), "all": v}
            for b, v in per.items()} for m, per in wall.items()}}), flush=True)
    print(card, flush=True)
    return 0


def profiled(mode: str, build: str, handler, fn, n: int, trace_dir: str,
             trace) -> None:
    """One block of ``n`` calls of ``fn`` under ``trace``: device ms,
    kernels and the hand-written sweeps' and splat's device ms per call."""
    import torch
    torch.cuda.synchronize()
    with trace(trace_dir) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ours = {e.key: (e.device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if any(name in e.key for name in KERNEL_NAMES)}
    print(json.dumps({
        "phase": "step", "mode": mode, "build": build,
        "profiled_wall_ms_per_step": wall / n,
        "device_ms_per_step": dev_ms / n,
        "kernels_per_step": len(kernels) / n,
        "kernel_ms_and_count_per_step": ours,
        "wide_state": [[int(v) for v in w]
                       for w in handler._wide_or_init()]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
