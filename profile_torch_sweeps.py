#!/usr/bin/env python3
"""The hand-written kernels with a caller (A ``place_planes``, B
``substep_pass``, C ``splat``, D ``sweep_planes``, E its symmetric form, F
``count_planes``) build against build, and the steps and frames that run
them, on one card.

    python3 profile_torch_sweeps.py [--baseline-csrc DIR]
                                    [--baseline-kernels ABCDEFG] [--n 6]
                                    [--blocks 2] [--phase kernel|all]

Builds of the kernel library compared in one process, in turns:

- ``tree``: the package's ``csrc/`` as it stands;
- ``baseline``: the sources under ``--baseline-csrc`` (for instance another
  commit's ``csrc/``, unpacked with ``git archive``), where given, timed on
  the kernels ``--baseline-kernels`` names (default ``ABCDEF``). The C
  entry points must have the package's signatures, except kernel A's: a
  baseline ``egg_place_planes`` takes the signature it had before kernel A
  owned its output slots (``BASELINE_PLACE_ARGTYPES``), and the entry
  points of ``BASELINE_OPTIONAL`` may be missing; the baseline's kernel A
  is called through the wrapper logic of its time (``baseline_place``: the gather of the
  payload into sorted order, the int32 slots, the zero fill, the kernel),
  all of it charged to the baseline, in the kernel phase and the steps;
- ablation builds of the tree, each one ``-D`` flag (``ABLATIONS``): the
  tiles of B, D, E and F staged without the list of occupied slots; kernel
  E without its partner-side adds (the pair arithmetic alone: wrong sums)
  and without its pair loop (listing, staging, memset and flush alone:
  wrong sums); kernel C without its cull and without its evaluation
  (staging alone: wrong output); kernel A without its search and staging
  (every slot written empty: its store floor, wrong output).

Phase ``kernel``: on the 1M-white scene of ``chip_smoke.build_handler``
(white G=768, yolk G=512, K=4), the time of one call of each kernel's
wrapper per population and build (for E that is the memset of the output
and the kernel): A on the fused path's binning (13 fields); B at window 1
with and without ``integrate``, window 3, and window 1 through the device
flag; D and E at window 1 with and without the ordered cutoff, window 3,
and both windows through the flag; C on the white and yolk render payloads,
alpha and rgb; F on the ordered layout; G (no caller) on the slot-major
candidates of ``chip_smoke.splat_tiles_case``. CUDA events around 20 calls
(for A and F, which take tens of microseconds, 20 calls captured in a CUDA
graph and replayed, ``chip_smoke.graph_ms``, so that the host's launch cost
between calls is not timed), builds in the order given and then reversed;
the least of the two is ``ms``. Every build's output is compared with the first's
(``max_abs_diff``).

Phase ``step`` (left out with ``--phase kernel``): ``update(1/60)`` of
the fused handler (budget off: 12 B per
step), of the ordered-budget handler (plane-resident step, default gate: 12
D per step), of the same with ``sweep_symmetric`` (12 E per step), and
``update`` + ``draw`` of a 2560 px viewport on the fused handler (2 C per
draw), in blocks of ``--n`` per build, alternating (first to last, then
reversed), host clock around work that ends in a synchronise; then one
block per build under ``utils.profiling.trace`` for the device time (sum of
kernel events), the kernel count and each hand-written kernel's device ms,
launches and share of the step's device time (A's share of the fused step,
F's of the plane steps). The builds
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
import ctypes
import json
import statistics
import sys
import tempfile
import time

# build name -> (nvcc flag, the kernels it changes)
ABLATIONS = {
    "staged_only": ("-DEGG_SWEEP_NO_COMPACT", "BDEF"),
    "sym_no_push": ("-DEGG_SYM_NO_PUSH", "E"),
    "sym_no_walk": ("-DEGG_SYM_NO_WALK", "E"),
    "splat_no_cull": ("-DEGG_SPLAT_NO_CULL", "C"),
    "splat_no_eval": ("-DEGG_SPLAT_NO_EVAL", "C"),
    "place_write_only": ("-DEGG_PLACE_WRITE_ONLY", "A"),
}
KERNEL_NAMES = ("place_planes_kernel", "substep_pass_kernel",
                "sweep_planes_kernel", "sweep_planes_sym_kernel",
                "splat_kernel", "count_planes_kernel", "splat_tiles_kernel")
# egg_place_planes(slot32, pack_sorted, out, n, n_fields, g, lanes, row_pad,
# stream) of the baseline: one thread an entry onto a zeroed output
BASELINE_PLACE_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]
# entry points a baseline's sources may lack (added with kernel H's front)
BASELINE_OPTIONAL = ("egg_gather_front", "egg_empty", "egg_if_node",
                     "egg_composite", "egg_upsample")


def baseline_place(lib, cell_sorted, slot_sorted, pidx_sorted, pack, g, k):
    """Kernel A of the baseline through its wrapper's logic: the payload
    gathered into sorted order, the slots as int32, a zero-filled output,
    then the kernel (``cell_sorted`` is not used)."""
    import torch
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    pack_sorted = pack[pidx_sorted]
    slot32 = slot_sorted.to(torch.int32).contiguous()
    n, n_f = pack_sorted.shape
    lanes = g * k
    out = torch.zeros((n_f, g + 2 * D.ROW_PAD, lanes), dtype=torch.float32,
                      device=pack.device)
    library.check("place_planes (baseline)", lib.egg_place_planes(
        slot32.data_ptr(), pack_sorted.data_ptr(), out.data_ptr(), n, n_f, g,
        lanes, D.ROW_PAD, library.stream_handle(pack.device)))
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline-csrc", default=None)
    ap.add_argument("--baseline-kernels", default="ABCDEF")
    ap.add_argument("--n", type=int, default=6)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--phase", choices=("kernel", "all"), default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    from egg_fluid_simulation_tpu_torch.utils.profiling import trace

    card = C.nvidia_smi()
    dev = torch.device("cuda", 0)
    builds = {"tree": library.open_build()}
    resources = {"tree": library.kernel_resources()}
    changes = {"tree": "ABCDEFG"}
    for name, (flag, kernels) in ABLATIONS.items():
        builds[name] = library.open_build(extra_flags=[flag])
        resources[name] = library.kernel_resources()
        changes[name] = kernels
    if args.baseline_csrc:
        builds["baseline"] = library.open_build(
            csrc=args.baseline_csrc, optional=BASELINE_OPTIONAL)
        if "A" in args.baseline_kernels:
            builds["baseline"].egg_place_planes.argtypes = \
                BASELINE_PLACE_ARGTYPES
        resources["baseline"] = library.kernel_resources()
        changes["baseline"] = args.baseline_kernels
    tree_place = PK.place_planes

    def use(b):
        """Make build ``b`` the one the wrappers call; the baseline's
        kernel A goes through its own wrapper logic."""
        library.use(builds[b])
        PK.place_planes = (
            (lambda *a: baseline_place(builds[b], *a))
            if b == "baseline" and "A" in args.baseline_kernels
            else tree_place)
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
    use("tree")
    ordered_planes = C.check_count(hp, {})
    for pop, name in ((0, "white"), (1, "yolk")):
        p = C.population_inputs(h, pop, C.SEED + pop)
        aux_cols = torch.stack([p["pos"][:, 0] - p["sub_dt"] * p["vel"][:, 0],
                                p["pos"][:, 1] - p["sub_dt"] * p["vel"][:, 1],
                                p["tx"], p["ty"], p["td"]], dim=1)
        slot_sorted, pidx_sorted, _, pack, cell_sorted = D.sort_bin(
            p["pos"], p["inv_mass"], p["radius"], p["batch"], p["act"],
            p["cell_size"], grid_dim=p["g"], slots_per_cell=p["k"],
            aux_cols=aux_cols, rotate=True)
        cases[f"A.{name}"] = (
            lambda a=(cell_sorted, slot_sorted, pidx_sorted, pack, p["g"],
                      p["k"]): PK.place_planes(*a))
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
        cases[f"F.{name}"] = lambda a=(planes, q["k"]): SK.count_planes(*a)
    g_args = C.splat_tiles_case(h)[:6]
    cases["G.white"] = lambda a=g_args: SPK.splat_tiles(*a)
    on = {c: [b for b in builds if c[0] in changes[b]] for c in cases}
    ms = {c: {b: [] for b in on[c]} for c in cases}
    diff = {c: {} for c in cases}
    for order in (list(builds), list(builds)[::-1]):
        for b in order:
            use(b)
            for c, fn in cases.items():
                if b in on[c]:
                    timer = C.graph_ms if c[0] in "AF" else C.cuda_ms
                    ms[c][b].append(timer(fn, 20))
    for c, fn in cases.items():
        outs = {}
        for b in on[c]:
            use(b)
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

    if args.phase == "kernel":
        print(card, flush=True)
        return 0

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
            use(b)
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
            use(b)
            for m, (hh, fn) in modes.items():
                profiled(m, b, hh, fn, n, f"{tmp}/{m}_{b}", trace)
    use("tree")
    print(json.dumps({"phase": "step", "summary": {
        m: {b: {"p50_ms": statistics.median(v), "all": v}
            for b, v in per.items()} for m, per in wall.items()}}), flush=True)
    print(card, flush=True)
    return 0


def profiled(mode: str, build: str, handler, fn, n: int, trace_dir: str,
             trace) -> None:
    """One block of ``n`` calls of ``fn`` under ``trace``: device ms,
    kernels and, per hand-written kernel, device ms and launches per call
    and the share of the call's device time."""
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
    ours = {e.key: (e.device_time_total / 1e3 / n, e.count / n,
                    e.device_time_total / 1e3 / max(dev_ms, 1e-9))
            for e in prof.key_averages()
            if any(name in e.key for name in KERNEL_NAMES)}
    print(json.dumps({
        "phase": "step", "mode": mode, "build": build,
        "profiled_wall_ms_per_step": wall / n,
        "device_ms_per_step": dev_ms / n,
        "kernels_per_step": len(kernels) / n,
        "kernel_ms_count_and_share_per_step": ours,
        "wide_state": [[int(v) for v in w]
                       for w in handler._wide_or_init()]}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
