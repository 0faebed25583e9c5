"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port either: top-level module names
compared whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "egg_fluid_simulation_tpu"}
PORT = "egg_fluid_simulation_tpu_torch"
MODULES = sorted(BENCH.rglob("*.py"))


def top_levels(path: Path) -> set:
    """Top-level names of every absolute import in ``path`` (a relative
    import stays inside the benchmark)."""
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_walk_sees_every_part():
    parts = {p.relative_to(BENCH).parts[0] for p in MODULES}
    assert {"reference", "metrics", "roofline", "tests", "run.py",
            "harness.py"} <= parts


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side(path):
    assert not top_levels(path) & JAX_SIDE
    assert PORT.startswith("egg_fluid_simulation_tpu")   # why names are whole


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_levels(path)
    assert "benchmark" not in top_levels(path)     # only its own modules


def test_the_guard_catches_a_planted_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\n"
                   "from egg_fluid_simulation_tpu.ops import solver\n"
                   "import egg_fluid_simulation_tpu_torch\n")
    assert top_levels(bad) == {"jax", "egg_fluid_simulation_tpu",
                               "egg_fluid_simulation_tpu_torch"}
