"""The port's import arrows point one way: ``models/`` (and ``parallel/``)
over ``kernels/`` over ``ops/`` over ``scene/``, ``config`` and the spans
(``utils/profiling.py``). Each module's source is read with ``ast``, so an
import inside a function counts as one at module level."""

import ast
import pathlib
import sys

import pytest

PKG = "fluid_simulation_tpu_torch"
ROOT = pathlib.Path(__file__).resolve().parent.parent / PKG
ABOVE_OPS = ("kernels", "models", "parallel")


def _imported(path):
    """Every module the file imports, dotted; ``from pkg import name`` gives
    ``pkg.name`` as well, since ``name`` may be a module."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: relative import"
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


def _under(mods, layers):
    return sorted(m for m in mods
                  if any(m == f"{PKG}.{x}" or m.startswith(f"{PKG}.{x}.")
                         for x in layers))


@pytest.mark.parametrize("rel", ["ops/advect.py", "ops/linsolve.py",
                                 "ops/project.py", "ops/bounds.py",
                                 "ops/vorticity.py", "utils/profiling.py"])
def test_bottom_layers_import_nothing_above_them(rel):
    mods = _imported(ROOT / rel)
    assert _under(mods, ABOVE_OPS) == []
    if rel.startswith("utils/"):
        # the spans sit under every layer: the standard library and torch
        tops = {m.split(".")[0] for m in mods}
        assert tops <= set(sys.stdlib_module_names) | {"torch"}, tops
