"""The port's bench (``egg_fluid_simulation_tpu_torch/bench.py``) against the
JAX package's root ``bench.py``, on the CPU.

- The scene: the port's ``build_handler(n, device="cpu")`` and ``bench.py``'s
  ``build_handler(n)`` give equal solver options, capacity, batch slots,
  counts and host views (initial positions included), bit for bit.
- ``drop_stats``, ``seed_render_budget`` and the frame options of the same
  spawn state: equal key for key.
- Every stage at a toy size (a few hundred to a few thousand particles, 2
  settle steps, 2 blocks of 2): one headline-shaped JSON line a stage, and
  the final line's keys are exactly ``bench.py``'s (read from its source
  with ``ast``, so the list cannot drift from the file) plus the port's.
- A failed stage gives a non-zero exit; without a card the command line
  exits non-zero with one line.

The numbers of a CPU run are CPU times; they are checked for shape, never
read as the card's.
"""

import ast
import contextlib
import dataclasses
import importlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import egg_fluid_simulation_tpu_torch as T
from egg_fluid_simulation_tpu.state import host_view
from egg_fluid_simulation_tpu_torch import bench as B
from egg_fluid_simulation_tpu_torch.interop import state_to_numpy

ROOT = Path(__file__).resolve().parent.parent
TOY = {"10k": dict(n=400, settle=2, block=2, blocks=2),
       "1m_step": dict(n=400, settle=2, block=2, blocks=2),
       "1m_step_render": dict(block=2, blocks=2),
       "render_modes": dict(block=2, blocks=2),
       "1m_step_default": dict(n=400, settle=2, block=2, blocks=2),
       "spatial_1x1": dict(n=400, settle=2, block=2, blocks=2)}
# the leading keys of every line, in bench.py's order (bench.py:73-85)
HEADLINE = ("metric", "value", "unit", "vs_baseline", "stage", "wall_s")
STAGES = ("10k", "1m_step", "1m_step_render", "render_modes",
          "1m_step_default", "spatial_1x1")


@pytest.fixture(autouse=True)
def _jax_plane_path(monkeypatch):
    # pin the JAX step to its CPU path (the plane path) whatever interpret
    # switch an earlier test file set for the session
    from egg_fluid_simulation_tpu.ops.pallas import sweep_kernel as jsweep
    monkeypatch.setattr(jsweep, "FORCE_INTERPRET", False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jbench(tmp_path_factory):
    """The root ``bench.py``, imported with its compile cache pointed at a
    temporary directory (importing it calls ``enable_compile_cache()``);
    the session's cache directory is restored afterwards."""
    prev = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR",
                  str(tmp_path_factory.mktemp("jax_cache")))
        mp.syspath_prepend(str(ROOT))
        sys.modules.pop("bench", None)
        mod = importlib.import_module("bench")
    jax.config.update("jax_compilation_cache_dir", prev)
    yield mod
    sys.modules.pop("bench", None)


def _bench_py_keys():
    """``bench.py``'s keys from its source: the ``results["..."]`` stores
    and ``drop_stats``'s keys (an f-string key once per value of its
    loop). Returns (keys, error keys)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "results"
                and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    drop = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "drop_stats")
    loop = next(n for n in ast.walk(drop) if isinstance(n, ast.For))
    values = [e.value for e in loop.iter.elts]
    for node in ast.walk(drop):
        if not (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)):
            continue
        if isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
        elif isinstance(node.slice, ast.JoinedStr):
            for v in values:
                keys.add("".join(p.value if isinstance(p, ast.Constant) else v
                                 for p in node.slice.values))
    errors = {k for k in keys if k.endswith("_error")}
    return keys - errors, errors


def _spreads(keys):
    return {f"{k}_{s}" for k in keys for s in ("p25", "p75", "blocks")}


# ---------------------------------------------------------------- the scene --

@pytest.mark.parametrize("n,spatial", [(4096, False), (10_000, False),
                                       (4096, True)])
def test_scene_twin(jbench, n, spatial):
    hj = jbench.build_handler(n, spatial=int(spatial))
    ht = B.build_handler(n, device="cpu", spatial=spatial)
    assert type(ht).__name__ == type(hj).__name__
    for f in dataclasses.fields(type(hj._options)):
        assert getattr(ht._options, f.name) == getattr(hj._options, f.name), \
            f.name
    ij = hj._inner if spatial else hj
    it = ht._inner if spatial else ht
    assert (it._capacity, it._max_batches) == (ij._capacity, ij._max_batches)
    assert tuple(ht.get_n_particles()) == tuple(hj.get_n_particles())
    a, b = host_view(hj.state), state_to_numpy(ht.state)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert b[k].dtype == a[k].dtype, k


def test_scene_overrides_and_wide_default(jbench):
    hj = jbench.build_handler(4096, wide_default=True)
    ht = B.build_handler(4096, device="cpu", wide_default=True)
    assert (ht._options.wide_budget_substeps
            == hj._options.wide_budget_substeps
            == T.SolverOptions().wide_budget_substeps)
    ho = B.build_handler(4096, device="cpu", budget_mode="ordered")
    assert ho._options.budget_mode == "ordered"
    assert ho._options.wide_budget_substeps == 0


def test_drop_stats_and_render_budget_match_jax(jbench):
    from egg_fluid_simulation_tpu.ops import render as JR
    hj = jbench.build_handler(4096)
    ht = B.build_handler(4096, device="cpu")
    assert B.drop_stats(ht) == jbench.drop_stats(hj)
    hj.seed_render_budget()
    ht.seed_render_budget()
    assert ht._render_budget.peak_density == hj._render_peak_density
    assert ([dataclasses.asdict(o) for o in ht._frame_options()]
            == [dataclasses.asdict(o) for o in JR.frame_options(hj)])


# ------------------------------------------------------- the stages, toy size --

@pytest.fixture(scope="module")
def toy_run():
    """Every stage on the CPU at ``TOY``: (exit code, lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = B.run("cpu", sizes=TOY)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_bench_keys_are_bench_py_keys():
    keys, errors = _bench_py_keys()
    assert set(B.BENCH_KEYS) == keys
    assert len(B.BENCH_KEYS) == len(keys)
    assert set(B.ERROR_KEYS.values()) == errors
    assert set(B.TIMED_KEYS) <= keys | set(B.PORT_KEYS)
    assert not set(B.PORT_KEYS) & keys


def test_toy_run_lines_are_headline_shaped(toy_run):
    rc, lines = toy_run
    assert rc == 0
    assert [ln["stage"] for ln in lines] == [*STAGES, "final"]
    for ln in lines:
        assert tuple(ln)[:len(HEADLINE)] == HEADLINE
        assert ln["metric"] == "p50 step+render latency at 1M particles"
        assert ln["unit"] == "ms"
        assert ln["device"] == "cpu"
    final = lines[-1]
    assert final["value"] == final["step_render_ms_1m"] > 0
    assert final["vs_baseline"] == round(16.0 / final["value"], 4)
    assert {k: v for k, v in final.items() if k != "stage"} == {
        k: v for k, v in lines[-2].items() if k != "stage"} | {
        "wall_s": final["wall_s"]}


def test_toy_run_keys_are_bench_py_keys_plus_the_ports(toy_run):
    _, lines = toy_run
    keys, _ = _bench_py_keys()
    want = keys | set(B.PORT_KEYS) | _spreads(B.TIMED_KEYS)
    assert set(lines[-1]) - set(HEADLINE) == want


STAGE_KEYS = {
    "10k": {"device", "step_ms_10k", "particle_steps_per_sec_10k",
            "engine_10k"} | _spreads(["step_ms_10k"]),
    "1m_step": {"n_particles_headline", "step_ms_1m",
                "particle_steps_per_sec_1m", "host_syncs_per_step_1m",
                "rebins_1m", "update_ms_1m", "physics_honest"}
    | _spreads(["step_ms_1m", "update_ms_1m"])
    | {f"{m}_{p}" for m in ("collision_drop_pct", "max_cell_occupancy",
                            "mean_cell_occupancy")
       for p in ("white", "yolk")},
    "1m_step_render": {"step_render_ms_1m", "render_ms_1m",
                       "render_overflow_dropped"}
    | _spreads(["step_render_ms_1m"]),
    "render_modes": {"render_only_ms_coarse", "render_only_ms_full",
                     "coarse_vs_full_max_err", "coarse_vs_full_mean_err"}
    | _spreads(["render_only_ms_coarse", "render_only_ms_full"]),
    "1m_step_default": {"step_ms_1m_default_opts"}
    | _spreads(["step_ms_1m_default_opts"]),
    "spatial_1x1": {"spatial_1x1_step_ms_65k", "dense_step_ms_65k",
                    "spatial_1x1_vs_dense", "spatial_host_syncs_per_step_65k"}
    | _spreads(["spatial_1x1_step_ms_65k", "dense_step_ms_65k"]),
}


@pytest.mark.parametrize("stage", STAGES)
def test_each_stage_adds_its_keys(toy_run, stage):
    _, lines = toy_run
    i = STAGES.index(stage)
    before = set(HEADLINE) if i == 0 else set(lines[i - 1])
    assert set(lines[i]) - before == STAGE_KEYS[stage]


def test_toy_run_values(toy_run):
    _, lines = toy_run
    final = lines[-1]
    for k in B.TIMED_KEYS:
        assert final[f"{k}_blocks"] == 2, k
        assert 0 < final[f"{k}_p25"] <= final[k] <= final[f"{k}_p75"], k
    for k, v in final.items():
        if isinstance(v, float):
            assert np.isfinite(v), k
    assert final["engine_10k"] == "dense"
    assert final["render_overflow_dropped"] == 0
    assert final["render_ms_1m"] == round(
        final["step_render_ms_1m"] - final["step_ms_1m"], 4)
    assert final["spatial_1x1_vs_dense"] == round(
        final["spatial_1x1_step_ms_65k"] / final["dense_step_ms_65k"], 4)
    n = B.build_handler(TOY["1m_step"]["n"], device="cpu").get_n_particles()
    assert final["n_particles_headline"] == sum(n)
    assert len(final["rebins_1m"]) == 2
    assert final["host_syncs_per_step_1m"] >= 0
    # the CPU steps the spatial handler eagerly: a read per population
    assert final["spatial_host_syncs_per_step_65k"] == 2.0


# ----------------------------------------------------------- failures --

def _fake_stages(monkeypatch, failing=None, dropped=0):
    """Every stage replaced by one that returns its keys at once; the one
    named ``failing`` raises."""
    def make(stage, keys):
        def fn(*args, **kwargs):
            if stage == failing:
                raise RuntimeError(f"{stage} failed")
            return {k: 1.0 for k in keys}
        return fn
    for stage, name in (("10k", "stage_10k"),
                        ("render_modes", "stage_render_modes"),
                        ("1m_step_default", "stage_default_opts"),
                        ("spatial_1x1", "stage_spatial_1x1")):
        monkeypatch.setattr(B, name, make(stage, STAGE_KEYS[stage]))
    step = make("1m_step", STAGE_KEYS["1m_step"])
    monkeypatch.setattr(B, "stage_1m_step",
                        lambda *a, **k: (object(), step()))
    render = make("1m_step_render", STAGE_KEYS["1m_step_render"])
    monkeypatch.setattr(B, "stage_1m_step_render", lambda *a, **k: {
        **render(), "render_overflow_dropped": dropped})


@pytest.mark.parametrize("stage", ["render_modes", "1m_step_default",
                                   "spatial_1x1"])
def test_a_failed_extra_stage_exits_nonzero(monkeypatch, capsys, stage):
    _fake_stages(monkeypatch, failing=stage)
    assert B.run("cpu") == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [ln["stage"] for ln in lines] == [*STAGES, "final"]
    line = lines[STAGES.index(stage)]
    assert line[B.ERROR_KEYS[stage]] == f"RuntimeError: {stage} failed"
    assert set(lines[-1]) - set(HEADLINE) == (
        set().union(*STAGE_KEYS.values()) - STAGE_KEYS[stage]
        | {B.ERROR_KEYS[stage]})


@pytest.mark.parametrize("stage", ["10k", "1m_step", "1m_step_render"])
def test_a_failed_headline_stage_ends_the_run(monkeypatch, stage):
    _fake_stages(monkeypatch, failing=stage)
    with pytest.raises(RuntimeError, match=f"{stage} failed"):
        B.run("cpu")


def test_a_render_drop_fails_the_run(monkeypatch, capsys):
    _fake_stages(monkeypatch, dropped=3)
    with pytest.raises(AssertionError, match="3 particles dropped"):
        B.run("cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[-1]["stage"] == "1m_step_render"
    assert lines[-1]["render_overflow_dropped"] == 3


# ------------------------------------------------------- the command line --

@pytest.mark.parametrize("cmd", [["-m", "egg_fluid_simulation_tpu_torch.bench"],
                                 ["bench_torch.py", "--quick"]])
def test_no_card_exits_nonzero_with_one_line(cmd):
    proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, text=True,
                          capture_output=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert len(proc.stderr.strip().splitlines()) == 1, proc.stderr
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("argv", [["--device", "cpu"], ["--ranks", "1"],
                                  ["--spatial"]])
def test_device_and_ranks_go_with_spatial(argv):
    with pytest.raises(SystemExit) as e:
        B.main(argv)
    assert e.value.code == 2


@pytest.mark.parametrize("argv,sub", [
    (["--spatial", "--device", "cpu"], ["--device", "cpu"]),
    (["--spatial", "--device", "cuda", "--ranks", "1"],
     ["--device", "cuda", "--ranks", "1"])])
def test_spatial_passes_device_and_ranks_through(monkeypatch, argv, sub):
    from egg_fluid_simulation_tpu_torch.parallel import spatial_bench
    seen = []
    monkeypatch.setattr(spatial_bench, "main",
                        lambda a: seen.append(a) or 0)
    assert B.main(argv) == 0
    assert seen == [sub]
