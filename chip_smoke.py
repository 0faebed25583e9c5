#!/usr/bin/env python3
"""GPU smoke run of egg_fluid_simulation_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``egg_fluid_simulation_tpu_torch/
csrc/``, checks each kernel against its plain PyTorch version at the shapes
of the main path, then drives the main path through the public API: the
1M-white / 100k-yolk scene of ``bench.py`` (``build_handler``), a few
``update(1/60)`` calls and a 2560 px ``draw``, and last a small spawn
explosion with the constructor-default solver options (the wide sweep).

Every phase prints its own line; any failure raises, so the script exits
non-zero. Without a CUDA card it exits non-zero before doing anything. The
line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
SPAWN_AREA = 20.0           # px^2 per white particle at spawn (bench.py)
N_WHITE = 1_000_000
MAIN_UPDATES = 3
PLACE_TOL = 0.0             # bit-exact
SUBSTEP_TOL = 1e-4          # px
SPLAT_TOL = 1e-4            # alpha: products taken in another order


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi not found"
    if out.returncode != 0 or not out.stdout.strip():
        return f"nvidia-smi failed: {out.stderr.strip()}"
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device ms per call of ``fn`` (CUDA events around ``reps`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_handler(n_target: int, device, wide_default: bool = False):
    """The bench.py scene (build_handler) through the port's API: 2000-white
    batches tiled alias-free, per-population grids, dense engine."""
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                SolverOptions,
                                                default_white_config,
                                                default_yolk_config)
    per_batch = max(200, min(n_target // 4, 2000))
    n_batches = min(max(1, n_target // per_batch), 512)
    per_batch_w = n_target // n_batches
    per_batch_y = max(2, per_batch_w // 10)
    cap_w = 1 << int(np.ceil(np.log2(max(per_batch_w * n_batches, 1024))))
    cap_y = 1 << int(np.ceil(np.log2(max(per_batch_y * n_batches, 1024))))
    radius = float(np.sqrt(per_batch_w * SPAWN_AREA / np.pi))
    spacing = 2.0 * radius + 0.25 * radius
    side = int(np.ceil(np.sqrt(n_batches)))
    extent = (side - 1) * spacing + 2.0 * radius + 64.0

    def pick_grid(cell: float, n_pop: int) -> int:
        g = 32
        while g * cell < extent * 1.04 or g * g * 4 < 2 * n_pop:
            g += 32
        return g

    g_w = pick_grid(8.0, per_batch_w * n_batches)
    g_y = pick_grid(12.0, per_batch_y * n_batches)
    kw = {} if wide_default else {"wide_budget_substeps": 0}
    options = SolverOptions(engine="dense", budget_mode="off",
                            dense_rebin="step", dense_grid_dim=(g_w, g_y),
                            dense_slots=4, pop_caps=(cap_w, cap_y), **kw)
    h = SimulationHandler(default_white_config(), default_yolk_config(),
                          capacity=max(cap_w, cap_y),
                          max_batches=max(n_batches, 4), options=options,
                          device=device)
    specs = [dict(x=float((b % side) * spacing + radius + 32.0),
                  y=float((b // side) * spacing + radius + 32.0),
                  white_radius=radius, yolk_radius=radius * 0.3,
                  white_n_particles=per_batch_w,
                  yolk_n_particles=per_batch_y)
             for b in range(n_batches)]
    h.add_many(specs)
    return h


def population_inputs(h, pop: int, vel_seed: int):
    """Per-population step inputs of the handler's current state, with a
    seeded random velocity field so integration has work to do."""
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    st, opts = h.state, h._options
    dev = st.device
    cap = opts.pop_caps[pop]
    g, k = opts.dense_grid_dim[pop], opts.dense_slots[pop]
    cfg = population_config(h._device_cfg2(), pop)
    act = st.active_mask()[pop, :cap]
    pos = st.pos[pop, :cap]
    gen = torch.Generator(device=dev).manual_seed(vel_seed)
    vel = (torch.rand(pos.shape, generator=gen, device=dev) - 0.5) * 40.0
    mass = cfg.min_mass * (1 - st.mass_t[pop, :cap]) + cfg.max_mass * st.mass_t[pop, :cap]
    inv_mass = torch.where(act, 1.0 / torch.clamp(mass, min=1e-12), 0.0)
    radius = torch.where(act, st.radius[pop, :cap], 0.0)
    sub_dt = torch.tensor((1 / 60) / opts.n_substeps, dtype=torch.float32,
                          device=dev)
    cell_size, params = S._dense_params(
        cfg, S.strength_to_compliance(cfg.collision_strength, sub_dt),
        S.strength_to_compliance(cfg.cohesion_strength, sub_dt), opts)
    table = torch.cat([st.batch_target,
                       torch.sqrt(torch.clamp(st.batch_radius[pop], min=0.0))[:, None]], 1)
    rows3 = S.take_batch_rows(table, st.batch_slot[pop, :cap])
    aux = torch.stack([1.0 - torch.clamp(cfg.damping, 0.0, 1.0),
                       S.strength_to_compliance(cfg.follow_strength, sub_dt),
                       torch.tensor(1.0, device=dev),
                       torch.tensor(0.0, device=dev)]).to(torch.float32)
    return dict(pos=pos, vel=vel, inv_mass=inv_mass, radius=radius,
                batch=st.batch_slot[pop, :cap], act=act, cell_size=cell_size,
                params=params.pack(dev), aux=aux, tx=rows3[:, 0],
                ty=rows3[:, 1], td=2.0 * rows3[:, 2], sub_dt=sub_dt, g=g, k=k)


def check_place(h, results) -> None:
    import torch
    from egg_fluid_simulation_tpu_torch.ops import dense as D
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    for pop, name in ((0, "white"), (1, "yolk")):
        p = population_inputs(h, pop, SEED + pop)
        aux_cols = torch.stack([p["pos"][:, 0] - p["sub_dt"] * p["vel"][:, 0],
                                p["pos"][:, 1] - p["sub_dt"] * p["vel"][:, 1],
                                p["tx"], p["ty"], p["td"]], dim=1)
        slot_sorted, pidx_sorted, _, pack = D.sort_bin(
            p["pos"], p["inv_mass"], p["radius"], p["batch"], p["act"],
            p["cell_size"], grid_dim=p["g"], slots_per_cell=p["k"],
            aux_cols=aux_cols)
        pack_sorted = pack[pidx_sorted]
        got = PK.place_planes(slot_sorted, pack_sorted, p["g"], p["k"])
        want = PK.place_planes_plain(slot_sorted, pack_sorted, p["g"], p["k"])
        err = float((got - want).abs().max())
        exact = bool(torch.equal(got, want))
        # and the whole binning against the golden scatter branch
        gold = S._bin_components(p["pos"], p["vel"], p["inv_mass"], p["radius"],
                                 p["batch"], p["act"], p["cell_size"], p["tx"],
                                 p["ty"], p["td"], p["sub_dt"], p["g"], p["k"],
                                 use_placement=False)
        kern = S._bin_components(p["pos"], p["vel"], p["inv_mass"], p["radius"],
                                 p["batch"], p["act"], p["cell_size"], p["tx"],
                                 p["ty"], p["td"], p["sub_dt"], p["g"], p["k"])
        golden_exact = all(torch.equal(a, b) for a, b in zip(gold, kern))
        ms = cuda_ms(lambda: PK.place_planes(slot_sorted, pack_sorted,
                                             p["g"], p["k"]), 20)
        plain_ms = cuda_ms(lambda: PK.place_planes_plain(
            slot_sorted, pack_sorted, p["g"], p["k"]), 20)
        log("check.place_planes", pop=name, G=p["g"], K=p["k"],
            N=int(pack.shape[0]), F=int(pack.shape[1]), max_abs_err=err,
            bit_exact=exact, golden_bit_exact=golden_exact,
            ms=round(ms, 4), plain_ms=round(plain_ms, 4))
        if not (exact and golden_exact and err <= PLACE_TOL):
            raise AssertionError(f"place_planes not bit-exact ({name})")
        r = results.setdefault("place_planes", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if pop == 0:
            r.update(ms=ms, plain_ms=plain_ms)


def check_substep(h, results) -> None:
    import torch
    from egg_fluid_simulation_tpu_torch.ops import solver as S
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    p = population_inputs(h, 0, SEED)
    xy, prev, stat, follow, _ = S._bin_components(
        p["pos"], p["vel"], p["inv_mass"], p["radius"], p["batch"], p["act"],
        p["cell_size"], p["tx"], p["ty"], p["td"], p["sub_dt"], p["g"], p["k"])
    # start the plain passes from a state one integrating pass in, so the
    # pair terms see moved particles
    xy1, prev1 = SK.substep_pass_plain(xy, stat, p["params"], p["aux"], p["k"],
                                       cohesion=True, prev=prev, follow=follow,
                                       integrate=True)
    for window, integrate in ((1, True), (1, False), (3, True), (3, False)):
        kw = dict(cohesion=True, window=window, fresh_mask=window == 3,
                  integrate=integrate)
        if integrate:
            args = (xy, stat, p["params"], p["aux"], p["k"])
            kw.update(prev=prev, follow=follow)
        else:
            args = (xy1, stat, p["params"], p["aux"], p["k"])
        got = SK.substep_pass(*args, **kw)
        want = SK.substep_pass_plain(*args, **kw)
        if integrate:
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        else:
            err = float((got - want).abs().max())
        ms = cuda_ms(lambda: SK.substep_pass(*args, **kw), 10)
        plain_ms = cuda_ms(lambda: SK.substep_pass_plain(*args, **kw), 2)
        # the device-flag form of the gate selects the same window
        flag = torch.tensor(window == 3, device=xy.device)
        kw_flag = {k_: v for k_, v in kw.items() if k_ not in ("window", "fresh_mask")}
        got_flag = SK.substep_pass(*args, wide=flag, **kw_flag)
        same_flag = all(torch.equal(a, b) for a, b in
                        zip(got if integrate else [got],
                            got_flag if integrate else [got_flag]))
        log("check.substep_pass", G=p["g"], K=p["k"], window=window,
            fresh_mask=window == 3, integrate=integrate, max_abs_err=err,
            tol=SUBSTEP_TOL, device_flag_same=same_flag, ms=round(ms, 4),
            plain_ms=round(plain_ms, 4))
        if not (err <= SUBSTEP_TOL and same_flag):
            raise AssertionError("substep_pass disagrees with its plain version")
        r = results.setdefault("substep_pass", dict(max_abs_err=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if (window, integrate) == (1, True):
            r.update(ms=ms, plain_ms=plain_ms)


def check_splat(h, results) -> None:
    import dataclasses
    import torch
    from egg_fluid_simulation_tpu_torch.config import population_config
    from egg_fluid_simulation_tpu_torch.ops import render as R
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    st = h.state
    dev = st.device
    cap = h._options.pop_caps[0]
    cfg = population_config(h._device_cfg2(), 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    color = torch.cat([torch.rand((cap, 3), generator=gen, device=dev),
                       torch.ones((cap, 1), device=dev)], 1)
    alpha_t = torch.tensor(0.5, device=dev)
    for post_mode in ("coarse", "full"):
        for use_rgb in (False, True):
            base = R.frame_options(h)[0]
            opts = dataclasses.replace(base, post_mode=post_mode,
                                       use_particle_color=use_rgb)
            payload, audit, counts = R._splat_payload(
                st.pos[0, :cap], st.last_pos[0, :cap], st.vel[0, :cap],
                st.radius[0, :cap], color, st.active_mask()[0, :cap],
                h.stats.centroid[0], alpha_t, cfg.texture_scale,
                cfg.motion_blur, opts)
            got = SPK.splat(payload, counts, opts, use_rgb)
            want = SPK.splat_plain(payload, counts, opts, use_rgb)
            err = float((got[0] - want[0]).abs().max())
            if use_rgb:
                err = max(err, float((got[1] - want[1]).abs().max()))
            ms = cuda_ms(lambda: SPK.splat(payload, counts, opts, use_rgb), 10)
            plain_ms = cuda_ms(lambda: SPK.splat_plain(payload, counts, opts,
                                                       use_rgb), 2)
            log("check.splat", post_mode=post_mode, use_rgb=use_rgb,
                canvas=opts.canvas_size, eff=opts.eff_size,
                tile=f"{opts.tile_h}x{opts.tile_w}",
                bin=f"{opts.bin_h}x{opts.bin_w}", K=opts.tile_capacity,
                dropped=int(audit[0]), max_abs_err=err, tol=SPLAT_TOL,
                alpha_max=round(float(want[0].max()), 4), ms=round(ms, 4),
                plain_ms=round(plain_ms, 4))
            if not err <= SPLAT_TOL:
                raise AssertionError("splat disagrees with its plain version")
            r = results.setdefault("splat", dict(max_abs_err=0.0))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if (post_mode, use_rgb) == ("coarse", False):
                r.update(ms=ms, plain_ms=plain_ms)


def main() -> int:
    import torch
    card = nvidia_smi()
    log("device", nvidia_smi=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, available=torch.cuda.is_available())
    if not torch.cuda.is_available():
        print("no CUDA device: nothing to check", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    from egg_fluid_simulation_tpu_torch.ops.kernels import library
    from egg_fluid_simulation_tpu_torch.ops.kernels import place_kernel as PK
    from egg_fluid_simulation_tpu_torch.ops.kernels import splat_kernel as SPK
    from egg_fluid_simulation_tpu_torch.ops.kernels import sweep_kernel as SK
    from egg_fluid_simulation_tpu_torch.utils.profiling import (
        collision_drop_stats, validate_state)

    t0 = time.perf_counter()
    library.load()
    log("build", seconds=round(time.perf_counter() - t0, 2),
        nvcc_seconds=library.last_build_seconds, flags=" ".join(library.NVCC_FLAGS))

    t0 = time.perf_counter()
    h = build_handler(N_WHITE, dev)
    torch.cuda.synchronize()
    log("scene", particles=h.get_n_particles(), grids=h._options.dense_grid_dim,
        caps=h._options.pop_caps, seconds=round(time.perf_counter() - t0, 2))
    h.seed_render_budget()

    results = {}
    check_place(h, results)
    check_substep(h, results)
    check_splat(h, results)

    # ---- main path: update(1/60) x N + draw, counters from zero ----
    PK.launches = SK.launches = SPK.launches = 0
    step_ms, frame_ms = [], []
    viewport = (0, 0, 2560, 2560)
    for i in range(MAIN_UPDATES):
        torch.cuda.synchronize()
        t_start = torch.cuda.Event(enable_timing=True)
        t_step = torch.cuda.Event(enable_timing=True)
        t_draw = torch.cuda.Event(enable_timing=True)
        t_start.record()
        h.update(1 / 60)
        t_step.record()
        frame = h.draw(viewport=viewport)
        t_draw.record()
        torch.cuda.synchronize()
        step_ms.append(t_start.elapsed_time(t_step))
        frame_ms.append(t_start.elapsed_time(t_draw))
    launches = {"place_planes": PK.launches, "substep_pass": SK.launches,
                "splat": SPK.launches}
    validate_state(h)
    audit = h.render_audit
    drops = collision_drop_stats(h)
    n_steps = MAIN_UPDATES
    log("main_path", updates=n_steps, step_ms=[round(x, 3) for x in step_ms],
        step_render_ms=[round(x, 3) for x in frame_ms],
        frame=tuple(frame.shape), frame_finite=bool(torch.isfinite(frame).all()),
        alpha_max=round(float(frame[..., 3].max()), 4),
        render_dropped=audit[:, 0].tolist(), peak_bin=audit[:, 1].tolist(),
        drop_pct_white=round(drops["white"]["drop_pct"], 3),
        drop_pct_yolk=round(drops["yolk"]["drop_pct"], 3),
        max_cell_occupancy=(drops["white"]["max_cell_occupancy"],
                            drops["yolk"]["max_cell_occupancy"]),
        launches=launches)
    if int(audit[:, 0].sum()) != 0:
        raise AssertionError("render overflow dropped particles")
    if not (bool(torch.isfinite(frame).all()) and float(frame[..., 3].max()) > 0.5):
        raise AssertionError("frame is not finite or empty")
    per = h._options.n_substeps * h._options.n_collision_steps * 2
    if not (launches["place_planes"] == 2 * n_steps
            and launches["substep_pass"] == per * n_steps
            and launches["splat"] >= 2 * n_steps):
        raise AssertionError(f"unexpected kernel launch counts {launches}")

    # ---- default options: the violence-gated wide sweep on a spawn explosion ----
    from egg_fluid_simulation_tpu_torch import (SimulationHandler,
                                                default_white_config,
                                                default_yolk_config)
    hd = SimulationHandler(default_white_config(), default_yolk_config(),
                           capacity=16384, max_batches=16, device=dev)
    rng = np.random.RandomState(SEED)
    hd.add_many([dict(x=float(400 + 40 * rng.randn()), y=float(300 + 40 * rng.randn()))
                 for _ in range(8)])
    wide_substeps = [0, 0]
    SK.launches = 0
    for _ in range(10):
        before = [int(w[1]) for w in hd._wide_or_init()]
        hd.step_once()
        after = [int(w[1]) for w in hd._wide_state]
        for pop in range(2):
            if after[pop] <= before[pop]:
                wide_substeps[pop] += before[pop] - after[pop]
    frame_d = hd.draw(viewport=(0, 0, 800, 600))
    validate_state(hd)
    log("default_options", particles=hd.get_n_particles(),
        wide_budget_substeps=hd._options.wide_budget_substeps,
        wide_substeps_run=wide_substeps, substep_launches=SK.launches,
        frame_finite=bool(torch.isfinite(frame_d).all()),
        render_dropped=hd.render_audit[:, 0].tolist())
    if sum(wide_substeps) == 0:
        raise AssertionError("the wide sweep never ran on a spawn explosion")

    src = "egg_fluid_simulation_tpu_torch/csrc/"
    tpu = "egg_fluid_simulation_tpu/ops/pallas/"
    table = [("place_planes", src + "place_planes.cu", tpu + "place_kernel.py:124"),
             ("substep_pass", src + "substep_pass.cu", tpu + "sweep_kernel.py:771"),
             ("splat", src + "splat.cu", tpu + "splat_kernel.py:400")]
    kernels = [dict(name=n, route="cuda", source=s, replaces=r,
                    launches=launches[n], max_abs_err=results[n]["max_abs_err"],
                    ms=results[n]["ms"], plain_ms=results[n]["plain_ms"])
               for n, s, r in table]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
