"""The port stands alone: no module of ``egg_fluid_simulation_tpu_torch``,
``parallel/`` included, and no root script of the port (``chip_smoke.py``,
``bench_torch.py``, ``profile_torch_*.py``) imports ``jax`` or the JAX
package ``egg_fluid_simulation_tpu``. Every such ``.py`` file is parsed with
``ast`` (so a lazy import inside a function counts too) and each ``import``
/ ``from ... import`` is checked. The same parse holds the ``ops/`` layer
below the handlers: no module there takes a handler."""

import ast
from pathlib import Path

import pytest

import egg_fluid_simulation_tpu_torch

PKG = Path(egg_fluid_simulation_tpu_torch.__file__).resolve().parent
FILES = sorted(PKG.rglob("*.py"))
ROOT = PKG.parent
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "bench_torch.py",
           *sorted(ROOT.glob("profile_torch_*.py"))]
BANNED = ("jax", "jaxlib", "egg_fluid_simulation_tpu")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_the_package_has_its_parallel_layer():
    names = {p.relative_to(PKG).as_posix() for p in FILES}
    assert {"parallel/mesh.py", "parallel/sharding.py", "parallel/spatial.py",
            "parallel/spatial_handler.py", "parallel/accounting.py",
            "parallel/dryrun.py", "parallel/spatial_bench.py"} <= names


def test_the_package_has_its_captured_step_and_render():
    names = {p.relative_to(PKG).as_posix() for p in FILES}
    assert {"ops/step_graph.py", "ops/render_graph.py"} <= names
    _assert_no_jax(PKG / "ops" / "render_graph.py")


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(PKG)
                         .as_posix())
def test_no_jax_import(path):
    _assert_no_jax(path)


def test_the_port_has_its_root_scripts():
    assert len(SCRIPTS) >= 5 and all(p.is_file() for p in SCRIPTS)


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_root_script_has_no_jax_import(path):
    _assert_no_jax(path)


def test_no_ops_module_takes_a_handler():
    """The layers point down: no module under ``ops/`` has a parameter
    named ``handler`` or reads an attribute through one. The handlers own
    their state and pass the render budget, their render and plain values
    down."""
    bad = []
    for path in sorted((PKG / "ops").rglob("*.py")):
        where = path.relative_to(PKG).as_posix()
        for node in ast.walk(ast.parse(path.read_text(), filename=where)):
            if isinstance(node, ast.arg) and node.arg == "handler":
                bad.append(f"{where}:{node.lineno} parameter handler")
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Name)
                  and node.value.id == "handler"):
                bad.append(f"{where}:{node.lineno} handler.{node.attr}")
    assert not bad, bad


def _assert_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if any(m == b or m.startswith(b + ".") for b in BANNED)]
    assert not bad, f"{path.name} imports {bad}"
